"""The fused AdamW pass: its wrapper, its plain version and its launch count.

``adamw_fused`` runs one AdamW step over a group of leaves: the moments and
the f32 master updated in place, the new parameters returned in their own
dtypes.  On the card it is one launch of a CUDA C++ kernel for ``sm_90a``
(``csrc/adamw.cu``, built with the other kernels by ``_build``).  The
reference has no Pallas kernel here: under ``jax.jit`` XLA fuses
``repro.optim.adamw.adamw_update`` into a few passes, and this kernel is the
port's counterpart of that fusion.  The source notes what bounds it (bytes:
~30 a parameter) and what its design does about it.

``adamw_plain`` is the plain version: the ``torch._foreach_*`` sequence the
port ran before, whose order of correctly rounded f32 operations the kernel
follows, so the two agree bit for bit.  A CUDA tensor launches the kernel on
``torch.cuda.current_stream()`` (or raises — there is no fallback); a CPU
tensor runs the plain version; a ``meta`` tensor (the dry run's stand-in for
the card) gets the kernel's outputs and nothing else, as the kernel
allocates no temporaries.  ``adamw_fused.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from . import _build
from .bsr_matmul import count_launch

#: elements per CTA (``kChunk`` in csrc/adamw.cu)
CHUNK = 256 * 16
#: int64 words per leaf in the kernel's table (``Leaf`` in csrc/adamw.cu)
_WORDS = 8
_OUT_DTYPES = (torch.bfloat16, torch.float32)


def adamw_plain(grads: Sequence[torch.Tensor], master: Sequence[torch.Tensor],
                mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
                dtypes: Sequence[torch.dtype], scale: torch.Tensor,
                lr: torch.Tensor, bc1: torch.Tensor, bc2: torch.Tensor,
                b1: float, b2: float, eps: float,
                weight_decay: float) -> List[torch.Tensor]:
    """One AdamW step over a group, as ``torch._foreach_*`` calls: ``mu``,
    ``nu`` and ``master`` (f32) updated in place; returns the new
    parameters, ``master`` cast to each of ``dtypes``."""
    g = torch._foreach_mul([x.float() for x in grads], scale)
    # mu = b1 * mu + (1 - b1) * g
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
    # nu = b2 * nu + (1 - b2) * g * g
    gg = torch._foreach_mul(g, 1 - b2)
    torch._foreach_mul_(gg, g)
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, gg)
    del g, gg
    # m = m - lr * (mhat / (sqrt(nhat) + eps) + wd * m)
    den = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    upd = torch._foreach_div(mu, bc1)
    torch._foreach_div_(upd, den)
    del den
    torch._foreach_add_(upd, torch._foreach_mul(master, weight_decay))
    torch._foreach_mul_(upd, lr)
    torch._foreach_sub_(master, upd)
    del upd
    return [m.to(dt, copy=True) for m, dt in zip(master, dtypes)]


def adamw_fused(grads: Sequence[torch.Tensor], master: Sequence[torch.Tensor],
                mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
                dtypes: Sequence[torch.dtype], scale: torch.Tensor,
                lr: torch.Tensor, bc1: torch.Tensor, bc2: torch.Tensor,
                b1: float, b2: float, eps: float,
                weight_decay: float) -> List[torch.Tensor]:
    """One AdamW step over a group of leaves in one pass (``adamw_plain``'s
    arguments and result).  On the card: ``master``, ``mu`` and ``nu`` f32
    and contiguous, ``grads`` of their shapes (cast to f32 where they are
    not), ``dtypes`` bf16 or f32, and ``scale``, ``lr``, ``bc1``, ``bc2``
    0-d f32 tensors on the same device, read there by the kernel."""
    device = master[0].device
    if device.type == "cpu":
        return adamw_plain(grads, master, mu, nu, dtypes, scale, lr, bc1,
                           bc2, b1, b2, eps, weight_decay)
    if device.type == "meta":
        return [torch.empty(m.shape, dtype=dt, device=device)
                for m, dt in zip(master, dtypes)]
    if device.type != "cuda":
        raise ValueError(f"adamw_fused: the state must lie on the CPU or a "
                         f"CUDA device, got {device}")
    for name, ts in (("master", master), ("mu", mu), ("nu", nu)):
        for t in ts:
            if t.device != device or t.dtype != torch.float32 \
                    or not t.is_contiguous():
                raise ValueError(f"adamw_fused: {name} must be contiguous f32 "
                                 f"on {device}, got {t.dtype} on {t.device}")
    for name, t in (("scale", scale), ("lr", lr), ("bc1", bc1), ("bc2", bc2)):
        if t.device != device or t.dtype != torch.float32 or t.ndim:
            raise ValueError(f"adamw_fused: {name} must be a 0-d f32 tensor "
                             f"on {device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    grads = [g if g.dtype == torch.float32 else g.float() for g in grads]
    grads = [g.contiguous() for g in grads]
    for g, m, dt in zip(grads, master, dtypes):
        if g.device != device or g.shape != m.shape:
            raise ValueError(f"adamw_fused: a gradient {tuple(g.shape)} on "
                             f"{g.device} does not fit its master "
                             f"{tuple(m.shape)} on {device}")
        if dt not in _OUT_DTYPES:
            raise ValueError(f"adamw_fused: parameters must be bf16 or f32, "
                             f"got {dt}")
    outs = [torch.empty(m.shape, dtype=dt, device=device)
            for m, dt in zip(master, dtypes)]
    return launch(grads, master, mu, nu, outs, scale, lr, bc1, bc2, b1, b2,
                  eps, weight_decay)


def leaf_table(grads, master, mu, nu, outs) -> tuple:
    """The kernel's table of the non-empty leaves (``Leaf`` in
    csrc/adamw.cu: 8 int64 words each) and its chunk count."""
    rows, chunk0 = [], 0
    for g, m, a, b, o in zip(grads, master, mu, nu, outs):
        n = m.numel()
        if n == 0:
            continue
        rows.append([g.data_ptr(), m.data_ptr(), a.data_ptr(), b.data_ptr(),
                     o.data_ptr(), n, int(o.dtype == torch.bfloat16), chunk0])
        chunk0 += -(-n // CHUNK)
    table = np.array(rows, dtype=np.int64).reshape(-1, _WORDS)
    return table, chunk0


def launch(grads, master, mu, nu, outs, scale, lr, bc1, bc2, b1, b2, eps,
           weight_decay) -> List[torch.Tensor]:
    """Launch the kernel on checked CUDA tensors (``adamw_fused`` checks
    them): the leaf table goes to the device through pinned memory, without
    a host sync."""
    lib = _build.load()
    table, n_chunks = leaf_table(grads, master, mu, nu, outs)
    if n_chunks == 0:
        return outs
    device = master[0].device
    dev_table = torch.from_numpy(table).pin_memory().to(device,
                                                        non_blocking=True)
    rc = lib.adamw_launch(
        dev_table.data_ptr(), table.shape[0], n_chunks, scale.data_ptr(),
        lr.data_ptr(), bc1.data_ptr(), bc2.data_ptr(), b1, 1 - b1, b2,
        1 - b2, eps, weight_decay, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"adamw_fused: kernel launch failed, CUDA error "
                           f"{rc}")
    count_launch(adamw_fused)
    return outs


adamw_fused.launches = 0
