"""Schedule packing (``ops``), oracles (``ref``) and the hand-written Hopper
kernels with their plain versions and launch counts (``bsr_matmul``,
``moe_ffn``)."""
