from .pipeline import SyntheticLM, TokenBatcher, sharded_batches

__all__ = ["SyntheticLM", "TokenBatcher", "sharded_batches"]
