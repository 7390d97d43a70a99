"""The in-place decode step and its CUDA graph, against the functional step
and the reference, on the CPU.

``lm.decode_step_`` / ``encdec.decode_step_`` (what the captured serve step
replays on the card) must give the functional ``decode_step``'s logits and
caches bit for bit, match the reference's ``decode_step`` within 1e-4
(f32, every architecture, an int8 KV cache too), write only the step's slot
of each attention window (a sentinel elsewhere stays as it was), write every
cache into its own storage, and advance ``pos`` in place.  The CUDA graph
itself (``launch.steps.CapturedServeStep``) needs the card: its tests are
marked ``cuda`` and skip without one (``chip_smoke.py`` phase 9 runs it at
full width).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.launch.mesh import make_test_mesh
from repro.models import encdec as jencdec
from repro.models import lm as jlm
from repro_torch.configs import get_config, reduced
from repro_torch.engine import Mesh
from repro_torch.launch import serve
from repro_torch.launch.steps import CapturedServeStep
from repro_torch.models import encdec as tencdec
from repro_torch.models import lm as tlm
from test_torch_models import (B, MODEL_TOL, S, WINDOW, close, close_tree,
                               models, t)

SENTINEL = 7
CASES = [(arch, {}) for arch in ARCH_IDS] + [("codeqwen1.5-7b",
                                              {"kv_quant": True})]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    return {} if tree is None else {prefix[:-1]: tree}


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return None if tree is None else tree.clone()


def _set_sentinel(caches, pos):
    """Every attention window slot past ``pos`` set to SENTINEL."""
    for name, x in _leaves(caches).items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("k", "v", "k_scale", "v_scale") \
                and not name.startswith("cross"):
            x[..., pos + 1:, :, :] = SENTINEL


def _prepare(arch, changes):
    """Reference and port at the reference's weights, primed for decoding:
    (jc, tc, jp, tp, jcache, tcache, first token)."""
    jc, tc, jp, tp = models(arch, **changes)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
    if jc.family == "encdec":
        src = (rng.standard_normal((B, S, jc.d_model)) * 0.05).astype(
            np.float32)
        jenc = jencdec.encode(jp, jc, jnp.asarray(src))
        tenc = tencdec.encode(tp, tc, t(src))
        jcache = jencdec.make_dec_caches(jp, jc, jenc, WINDOW, jnp.float32)
        tcache = tencdec.make_dec_caches(tp, tc, tenc, WINDOW, torch.float32)
        return jc, tc, jp, tp, jcache, tcache, toks[:, :1]
    jl, jcache = jlm.prefill(jp, jc, tokens=jnp.asarray(toks))
    _, tcache = tlm.prefill(tp, tc, tokens=t(toks))
    jcache = jlm.grow_caches(jc, jcache, WINDOW)
    tcache = tlm.grow_caches(tc, tcache, WINDOW)
    nxt = np.asarray(jnp.argmax(jl, -1), np.int32)[:, None]
    return jc, tc, jp, tp, jcache, tcache, nxt


def _slot_only(tp, tc, tok, caches):
    """One in-place step on a copy of ``caches`` whose window slots past
    ``pos`` hold SENTINEL: every cache keeps its storage, only the step's
    slot of each attention window changes, ``pos`` advances by one and the
    cross-attention caches stay as they were."""
    mod = tencdec if tc.family == "encdec" else tlm
    kw = {} if tc.family == "encdec" else {"mesh": Mesh(1, 1)}
    probe = _clone(caches)
    attn = "self" if tc.family == "encdec" else "attn"
    pos = int(probe[attn]["pos"].reshape(-1)[0]) if attn in probe else None
    if pos is not None:
        _set_sentinel(probe, pos)
    before = _clone(probe)
    ptrs = {n: x.data_ptr() for n, x in _leaves(probe).items()}
    mod.decode_step_(tp, tc, t(tok), probe, **kw)
    assert {n: x.data_ptr() for n, x in _leaves(probe).items()} == ptrs
    if pos is None:
        return
    slot = min(pos, WINDOW - 1)
    for name, x in _leaves(probe).items():
        old = _leaves(before)[name]
        leaf = name.rsplit(".", 1)[-1]
        if name.startswith("cross"):
            assert torch.equal(x, old), name
        elif leaf == "pos":
            assert torch.equal(x, old + 1), name
        elif leaf in ("k", "v", "k_scale", "v_scale"):
            keep = torch.ones(x.shape[-3], dtype=torch.bool)
            keep[slot] = False
            assert torch.equal(x[..., keep, :, :], old[..., keep, :, :]), name
            assert not torch.equal(x[..., slot, :, :],
                                   old[..., slot, :, :]), name


@pytest.mark.parametrize("arch,changes", CASES,
                         ids=[a + ("-int8-kv" if c else "")
                              for a, c in CASES])
def test_inplace_decode_equals_functional_and_reference(arch, changes):
    """Two steps, the second past the window (its write clamps to the last
    slot): bit for bit the functional step's logits and caches, within 1e-4
    of the reference's, the functional step's input left as it was, and
    only the step's slot written, in place."""
    jc, tc, jp, tp, jcache, tcache, tok = _prepare(arch, changes)
    mod = tencdec if tc.family == "encdec" else tlm
    jmod = jencdec if jc.family == "encdec" else jlm
    kw = {} if tc.family == "encdec" else {"mesh": Mesh(1, 1)}
    jkw = {} if jc.family == "encdec" else {"mesh": make_test_mesh(1, 1)}
    functional, inplace = _clone(tcache), _clone(tcache)
    for step in range(2):
        if step == 1:          # a position past the window: it clamps
            for c in (functional, inplace):
                for sub in c.values():
                    if isinstance(sub, dict) and "pos" in sub:
                        sub["pos"] += WINDOW
            jcache = {k: (dict(v, pos=v["pos"] + WINDOW)
                          if isinstance(v, dict) and "pos" in v else v)
                      for k, v in jcache.items()}
        _slot_only(tp, tc, tok, inplace)
        given, kept = functional, _clone(functional)
        lf, functional = mod.decode_step(tp, tc, t(tok), functional, **kw)
        li = mod.decode_step_(tp, tc, t(tok), inplace, **kw)
        jl, jcache = jmod.decode_step(jp, jc, jnp.asarray(tok), jcache, **jkw)
        for name, x in _leaves(kept).items():
            assert torch.equal(_leaves(given)[name], x), name
        assert torch.equal(li, lf)
        for name, x in _leaves(functional).items():
            assert torch.equal(_leaves(inplace)[name], x), name
        close(li, jl, MODEL_TOL)
        close_tree(inplace, jcache, MODEL_TOL)
        tok = np.asarray(jnp.argmax(jl, -1), np.int32)[:, None]


def test_serve_lm_on_the_cpu_stays_eager():
    """``--device cpu`` decodes eagerly: no graph is captured or
    replayed."""
    CapturedServeStep.reset_counts()
    args = serve.parse_args(["--arch", "granite-moe-1b-a400m", "--device",
                             "cpu", "--batch", "2", "--prompt-len", "8",
                             "--gen", "3", "--requests", "3"])
    report = serve.serve_lm(reduced(get_config(args.arch)), args)
    assert report.tokens == 9
    assert CapturedServeStep.replays == CapturedServeStep.captures == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100: python3 "
                    "chip_smoke.py, phase 9)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "granite-moe-1b-a400m",
                                  "mamba2-1.3b", "zamba2-1.2b",
                                  "seamless-m4t-medium"])
def test_captured_step_equals_eager_on_the_card(arch, cuda_device):
    """One graph per shape; its tokens equal the eager step's, its logits
    within 1e-6 of max |logit| (MoE combines with atomics)."""
    _, tc, _, tp, _, tcache, tok = _prepare(arch, {})
    tp = tp.to(cuda_device)
    caches = {k: (None if v is None else
                  {kk: vv.to(cuda_device) for kk, vv in v.items()})
              for k, v in tcache.items()}
    cur = torch.from_numpy(tok).to(cuda_device)
    eager, logits, c, x = [], [], caches, cur
    with torch.inference_mode():
        mod = tencdec if tc.family == "encdec" else tlm
        for _ in range(4):
            lg, c = mod.decode_step(tp, tc, x, c, mesh=Mesh(1, 1))
            x = torch.argmax(lg, -1).to(torch.int32)[:, None]
            eager.append(x)
            logits.append(lg)
        captured = CapturedServeStep(tc, tp, Mesh(1, 1))
        got = captured(caches, cur, 4, keep_logits=True)
        again = captured(caches, cur, 4)
    assert len(captured.graphs) == 1
    for a, b in zip(got, eager):
        assert torch.equal(a, b)
    for a, b in zip(again, got):
        assert torch.equal(a, b)
    for a, b in zip(captured.step_logits, logits):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
