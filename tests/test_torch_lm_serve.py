"""LM serving of the port against the reference, on the CPU.

Whole models for every architecture (logits and caches within 1e-4, f32),
the serve loop's greedy tokens against the reference's loop for one
architecture per family, the CLI for every architecture, and the refusal
to fall back to the CPU.  Weights are the reference's, carried across with
``lm_params_from_numpy``.
"""

from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.launch.mesh import make_test_mesh
from repro.launch.steps import make_prefill_step as jmake_prefill_step
from repro.launch.steps import make_serve_step as jmake_serve_step
from repro.models import encdec as jencdec
from repro.models import lm as jlm
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.engine import Mesh
from repro_torch.launch import serve
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import encdec as tencdec
from repro_torch.models import lm as tlm
from test_torch_models import (B, MODEL_TOL, S, WINDOW, close, close_tree,
                               count, models, np_tree, t)

SERVE_ARGV = ["--device", "cpu", "--batch", "2", "--prompt-len", "8",
              "--gen", "4", "--requests", "3"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_matches_reference(arch):
    """forward, prefill (logits and caches), grow_caches and one
    decode_step; encdec: encode, decode_train, make_dec_caches and
    decode_step.  The decode step gets the serve loop's 1x1 mesh."""
    jc, tc, jp, tp = models(arch)
    # the converted module holds every leaf, and the port's own init has
    # the reference's tree: the same names and shapes
    assert count(jp) == sum(p.numel() for p in tp.parameters())
    own = (tencdec if tc.family == "encdec" else tlm).init(
        torch.Generator().manual_seed(0), tc, dtype=torch.float32)
    assert {k: v.shape for k, v in own.state_dict().items()} == \
        {k: v.shape for k, v in tp.state_dict().items()}
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
    if jc.family == "encdec":
        src = (rng.standard_normal((B, S, jc.d_model)) * 0.05).astype(np.float32)
        jenc = jencdec.encode(jp, jc, jnp.asarray(src))
        tenc = tencdec.encode(tp, tc, t(src))
        close(tenc, jenc, MODEL_TOL)
        close(tencdec.decode_train(tp, tc, tenc, t(toks[:, :5])),
              jencdec.decode_train(jp, jc, jenc, jnp.asarray(toks[:, :5])),
              MODEL_TOL)
        jcache = jencdec.make_dec_caches(jp, jc, jenc, WINDOW, jnp.float32)
        tcache = tencdec.make_dec_caches(tp, tc, tenc, WINDOW, torch.float32)
        close_tree(tcache, jcache, MODEL_TOL)
        for step in range(2):
            tok = toks[:, step:step + 1]
            jl, jcache = jencdec.decode_step(jp, jc, jnp.asarray(tok), jcache)
            tl, tcache = tencdec.decode_step(tp, tc, t(tok), tcache)
            close(tl, jl, MODEL_TOL)
            close_tree(tcache, jcache, MODEL_TOL)
        return
    jh, _ = jlm.forward(jp, jc, tokens=jnp.asarray(toks))
    th, _ = tlm.forward(tp, tc, tokens=t(toks))
    close(th, jh, MODEL_TOL)
    jl, jcache = jlm.prefill(jp, jc, tokens=jnp.asarray(toks))
    tl, tcache = tlm.prefill(tp, tc, tokens=t(toks))
    close(tl, jl, MODEL_TOL)
    close_tree(tcache, jcache, MODEL_TOL)
    jcache = jlm.grow_caches(jc, jcache, WINDOW)
    tcache = tlm.grow_caches(tc, tcache, WINDOW)
    close_tree(tcache, jcache, MODEL_TOL)
    nxt = np.asarray(jnp.argmax(jl, -1), np.int32)[:, None]
    jl, jcache = jlm.decode_step(jp, jc, jnp.asarray(nxt), jcache,
                                 mesh=make_test_mesh(1, 1))
    tl, tcache = tlm.decode_step(tp, tc, t(nxt), tcache, mesh=Mesh(1, 1))
    close(tl, jl, MODEL_TOL)
    close_tree(tcache, jcache, MODEL_TOL)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "seamless-m4t-medium"])
def test_prefill_step_matches_reference(arch):
    """make_prefill_step: lm.prefill's logits and caches, or encdec's
    encoder output and the last target position's logits."""
    jc, tc, jp, tp = models(arch)
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, jc.vocab, (B, 9)).astype(np.int32),
             "tgt_tokens": rng.integers(0, jc.vocab, (B, 5)).astype(np.int32),
             "src_embeds": (rng.standard_normal((B, 11, jc.d_model))
                            * 0.05).astype(np.float32)}
    jl, jout = jmake_prefill_step(jc)(jp, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
    tl, tout = make_prefill_step(tc)(tp, {k: t(v) for k, v in batch.items()})
    close(tl, jl, MODEL_TOL)
    close_tree(tout, jout, MODEL_TOL)


def reference_loop(cfg, params, args):
    """The reference's LM serving loop (src/repro/launch/serve.py:490-529)
    on given weights: a 1x1 mesh for the decode step, prompts and encoder
    inputs from np.random.default_rng(0)."""
    serve_step = jax.jit(jmake_serve_step(cfg, make_test_mesh(1, 1)))
    rng = np.random.default_rng(0)
    window = args.prompt_len + args.gen
    queue = deque(
        rng.integers(0, cfg.vocab, size=args.prompt_len).astype(np.int32)
        for _ in range(args.requests))
    done = []
    while queue:
        slot_prompts = [queue.popleft()
                        for _ in range(min(args.batch, len(queue)))]
        Bq = len(slot_prompts)
        prompts = jnp.asarray(np.stack(slot_prompts))
        if cfg.family == "encdec":
            enc_in = jnp.asarray(
                rng.standard_normal((Bq, args.prompt_len, cfg.d_model)) * 0.05,
                jnp.float32)
            enc_out = jencdec.encode(params, cfg, enc_in)
            caches = jencdec.make_dec_caches(params, cfg, enc_out,
                                             window=window, dtype=jnp.float32)
            cur = jnp.zeros((Bq, 1), jnp.int32)
        else:
            logits, caches = jlm.prefill(params, cfg, tokens=prompts)
            caches = jlm.grow_caches(cfg, caches, window)
            cur = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        outs = [cur]
        for _ in range(args.gen - 1):
            cur, caches = serve_step(params, caches, cur)
            outs.append(cur)
        done.extend(list(np.concatenate([np.asarray(o) for o in outs], axis=1)))
    return done


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "codeqwen1.5-7b",
                                  "mamba2-1.3b", "zamba2-1.2b",
                                  "seamless-m4t-medium"])
def test_serve_lm_tokens_equal_reference_loop(arch):
    """One architecture per family (moe, dense, ssm, hybrid, encdec): 3
    requests in slots of 2, so the second batch is partial."""
    jc, tc, jp, tp = models(arch)
    args = serve.parse_args(["--arch", arch] + SERVE_ARGV)
    ref = reference_loop(jc, jp, args)
    report = serve.serve_lm(tc, args, params=tp)
    assert len(report.sequences) == len(ref) == args.requests
    assert report.tokens == args.requests * args.gen
    for port_seq, ref_seq in zip(report.sequences, ref):
        np.testing.assert_array_equal(port_seq, ref_seq)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cli_serves_every_arch(arch, capsys):
    """python -m repro_torch.launch.serve --arch ARCH --device cpu: the
    reduced config (``--reduced`` is always on), every request served."""
    serve.main(["--arch", arch] + SERVE_ARGV)
    out = capsys.readouterr().out
    assert f"arch={arch}-reduced served 3 sequences, 12 tokens" in out
    assert "sample: [" in out


def test_lm_defaults_are_the_references():
    args = serve.parse_args([])
    assert (args.arch, args.reduced, args.batch, args.prompt_len, args.gen,
            args.requests, args.device, args.sparse_ffnn) == \
        ("mamba2-1.3b", True, 4, 32, 16, 8, "cuda", False)


def test_serve_lm_without_card_raises():
    """--device cuda never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = serve.parse_args(["--device", "cuda"])
    cfg = treduced(tget_config("mamba2-1.3b"))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        serve.serve_lm(cfg, args)


def test_converter_refuses_a_tree_that_does_not_fit():
    jc, tc, jp, _ = models("granite-moe-1b-a400m")
    tree = np_tree(jp)
    del tree["layers"]["moe"]["gate"]
    with pytest.raises(RuntimeError, match="Missing key"):
        lm_params_from_numpy(tc, tree, device="cpu")
    tree = np_tree(jp)
    tree["layers"]["attn"]["wq"] = tree["layers"]["attn"]["wq"][:, :, :8]
    with pytest.raises(RuntimeError, match="size mismatch"):
        lm_params_from_numpy(tc, tree, device="cpu")
