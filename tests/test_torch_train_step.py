"""One train step of the port against the reference's, on the CPU, in f32.

The same weights and batches (``test_torch_train``'s helpers) go through
each package's ``make_train_step``: the metrics within 1e-5, ``mu``/``nu``
within 1e-4, the new ``master`` and parameters within ``atol = 1e-2 * lr``
plus Adam's bound on how far rounding in a near-zero gradient moves an
update (``check_step``).
"""

import jax
import numpy as np
import pytest

from repro.launch.mesh import make_test_mesh
from repro.launch.steps import make_train_step as jmake_train_step
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw as jadamw
from repro_torch.convert import lm_params_to_numpy, opt_state_to_numpy
from repro_torch.engine import Mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import OptConfig
from repro_torch.optim import adamw as tadamw
from test_torch_train import (FAMILIES, METRIC_TOL, MOMENT_TOL, OPT, batch,
                              close, close_tree, jbatch, models, tbatch)


# =============================================================================
# one train step
# =============================================================================

def run_steps(arch, n_steps=1, mesh=True, seed=0, **changes):
    """``n_steps`` of each package's make_train_step from the same weights
    and batches: (port metrics, port params, port state, reference
    metrics, reference params, reference state), the trees as numpy."""
    jc, tc, jp, tp = models(arch, seed=seed, **changes)
    jstep = jax.jit(jmake_train_step(jc, JOptConfig(**OPT),
                                     make_test_mesh(1, 1) if mesh else None))
    tstep = make_train_step(tc, OptConfig(**OPT), Mesh(1, 1) if mesh else None)
    jopt, topt = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
    for i in range(n_steps):
        b = batch(jc, seed=seed + i, b=4)
        jp, jopt, jm = jstep(jp, jopt, jbatch(b))
        tp, topt, tm = tstep(tp, topt, tbatch(b))
    return ({k: float(v) for k, v in tm.items()}, lm_params_to_numpy(tp),
            opt_state_to_numpy(topt),
            {k: float(v) for k, v in jm.items()},
            jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, jopt))


def check_step(out, lr, first=True):
    """Metrics, moments, master and params after the step(s).

    After the first step the update of each element is ``lr * g / (|g| +
    eps)`` (plus the decay), and ``g / (|g| + eps)`` moves by at most
    ``|dg| / eps`` when ``g`` moves by ``dg``: a gradient element of about
    1e-8, where the two packages' summation orders differ by about 1e-9,
    moves its update by a few per cent of ``lr``.  So each element is held
    to ``1e-2 * lr`` plus that bound, ``dg`` read off the two ``mu``s
    (``mu = (1 - b1) * g`` after one step)."""
    tm, tparams, topt, jm, jparams, jopt = out
    assert set(tm) == set(jm) == {"loss", "grad_norm", "lr"}
    for k in jm:
        close(tm[k], jm[k], METRIC_TOL)
    assert int(topt["step"]) == int(jopt["step"])
    close_tree(topt["mu"], jopt["mu"], MOMENT_TOL)
    close_tree(topt["nu"], jopt["nu"], MOMENT_TOL)
    cfg = OptConfig(**OPT)
    bounds = jax.tree.map(
        lambda a, b: 1e-2 * lr + (lr * np.abs(a - b) / ((1 - cfg.b1) * cfg.eps)
                                  if first else 0.0),
        topt["mu"], jax.tree.map(np.asarray, jopt["mu"]))
    for port in (topt["master"], tparams):
        pl = jax.tree_util.tree_flatten_with_path(port)[0]
        for (path, a), b, bound in zip(pl, jax.tree.leaves(jopt["master"]),
                                       jax.tree.leaves(bounds)):
            err = np.abs(a - np.asarray(b))
            assert np.all(err <= bound), (jax.tree_util.keystr(path),
                                          float((err - bound).max()))


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step(arch):
    """One step under a 1x1 mesh (granite's ``moe_impl="a2a"`` takes the
    one-shard expert-parallel body in both packages)."""
    out = run_steps(arch)
    check_step(out, out[3]["lr"])


def test_microbatch_matches_reference_scan():
    """``microbatch=2`` splits the batch of 4 in two: gradients summed in
    f32 and averaged, the mean loss; the reference scans."""
    out = run_steps("codeqwen1.5-7b", microbatch=2)
    check_step(out, out[3]["lr"])


def test_three_steps_track_reference():
    """Later steps feed the new moments back: three steps still agree."""
    out = run_steps("mamba2-1.3b", n_steps=3, mesh=False)
    check_step(out, out[3]["lr"], first=False)
