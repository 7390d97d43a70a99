#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port, on one H100.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

  1. environment: torch/CUDA versions, device capability (9, 0), the card's
     name and power limit from nvidia-smi;
  2. build: the CUDA sources compiled with nvcc for sm_90a, one nvcc
     process per source, all started together; a ``ptxas:`` JSON line with
     the registers, static shared memory and spills of each instance of
     the BSR kernels and ``moe_ffn``, and, where cuobjdump exists, the
     count of HGMMA instructions in each one's SASS (the bf16 ``moe_ffn``
     kernel must have some);
  3. kernel vs plain at the BERT-large FFNN shapes (1024 -> 4096 -> 1024,
     density 0.1, 128x128 tiles, gelu): ``bsr_matmul`` per layer and
     ``bsr_megakernel`` for the net, f32/bf16/fp8 weights, f32/bf16
     inputs, B in {1, 4, 32, 33} (33 spans two row chunks), each against
     its plain PyTorch version; with f32 x the megakernel's output must be
     bit-equal to two chained ``bsr_matmul`` launches (both walk the same
     split-K code and keep the hidden tile in f32), and every schedule's
     arrival counters must be zero after each launch; the megakernel's
     cooperative grid size is printed; then the gated megakernel on the
     same widths with relu, half of the hidden tiles killed by a bias of
     -10 and the first 4 of 8 input tiles zero: occupancy equal to the
     plain version's, output within tolerance of it and bit-equal to the
     ungated kernel's, counters zero, and ``measure_dynamic``'s read
     fraction below 1;
  4. main path: ``repro_torch.launch.serve --sparse-ffnn --batch 4
     --requests 64 --reorder-iters 300`` in-process — every request answered,
     answers equal to the plan's plain (torch-backend) version, and one megakernel
     launch per forward; again with ``--no-fuse``, one bsr_matmul launch per
     layer per forward; again with ``--gate``, one gated megakernel launch
     per forward and per dynamic-I/O sample, on Gaussian requests and then
     on 64 requests whose first 4 input tiles are zero;
  5. times of each BSR kernel, its plain version and a PyTorch yardstick,
     beside the least time the card could take for the same work: device
     time per call from a torch.profiler trace of 30 calls, and per-call
     time between CUDA events (median of 30, after warm-up), which adds the
     host's share of the call; the megakernel rows also carry the device
     time of two chained ``bsr_matmul`` launches (``two_bsr_matmul_ms``,
     what ``--no-fuse`` runs) and the cooperative grid size; the
     megakernel again at the offline benchmark cells' 4,096 rows on both
     benchmark nets' widths (the BERT FFNN and the 512-wide, 4-layer MLP
     of 64 x 64 blocks), f32, with the walk it took (``phase_times_large``,
     which also runs alone against another tree's ``src``); then one
     profiled serving window, for the device's busy share;
  6. ``moe_ffn`` against its plain version at the expert widths of
     Granite-3.0-1B-A400M (E = 32, C = 640, d = 1024, f = 512, gelu), f32
     and bf16, f_tile 128 and 512, and bf16 with the other row tile (64
     rows per CTA); one call through its entry point, and its times as in
     5, both bf16 row tiles among them;
  7. the serving runtime at the BERT net's full width, gated, ``--batch
     32``, all of it through one ``--plan-store`` in a temporary directory:
     the plan set built twice, cold then warm (a plan-store hit with 0
     annealer iterations, outputs bit-equal on the card); 8 threads x 50
     launches of the gated megakernel on one flat schedule, each output
     bit-equal to the ungated kernel's and each occupancy equal to the
     plain version's; ``--async --workers 4`` with 256 requests in bursts
     of mixed sizes from 4 submitter threads (answers equal to the plain
     version within 1e-4, gated launches exactly forwards plus dynamic-I/O
     samples, no batch degraded); a swap to new weights under traffic
     (every answer the old or the new plan's); ``--models 2`` (every answer
     its own model's); failures injected at ``server.run_batch`` tripping
     ``--breaker 2`` (degraded batches run on the safe twin, one
     ``bsr_matmul`` launch per layer and no megakernel; the probe after the
     cool-down launches the gated megakernel again); POSTs to the HTTP
     front door and a GET of the Prometheus endpoint; and the serving rate
     for ``--workers 0``, ``1`` and ``4`` over timed windows of a few
     seconds each, and the card's busy share of a profiled window;
  8. sharded plans at the same widths: ``Mesh(2, 1)``, ``Mesh(4, 1)`` and
     ``Mesh(4, 2)`` on the kernel backend, f32 and bf16 x, B in {1, 4, 33}:
     each forward exactly model x layers ``bsr_matmul`` launches and no
     megakernel, answers within tolerance of ``plan.plain()``, every shard
     schedule's arrival counters zero after each forward, and the rows of a
     batch padded to the data axis bit-equal to those of an unpadded one;
     ``Mesh(1, 1)`` one megakernel launch per forward, bit-equal to the
     unsharded plan; ``serve --mesh 4x1`` step-driven (64 requests, model x
     layers launches per forward); ``--mesh 4x2 --gate --async --workers 2``
     through a temporary ``--plan-store``, cold then warm (0 annealer
     iterations in every shard, outputs bit-equal); device time per forward
     (torch.profiler) and per-call time of ``Mesh(2, 1)`` and ``Mesh(4, 1)``
     beside the unsharded megakernel and ``--no-fuse``; and ``Mesh(2, 1)``
     as two processes on the one card through ``gloo`` all-gathers, where
     this torch's gloo takes CUDA tensors (else it says so);
  9. LM serving (``serve --arch``, no hand-written kernel on its path; its
     decode step a CUDA graph, ``steps.CapturedServeStep``): all ten
     architectures reduced through ``serve_lm`` (``--batch 4 --prompt-len
     32 --gen 16 --requests 8``), every request given 16 tokens, one graph
     replay per decode step (the replay counter) and one capture per batch
     shape, prefill and first decode-step logits within 1e-4 (of max
     |logit|) of the same weights on the CPU, and the captured step's
     tokens equal to the eager step's over 15 steps from the same caches,
     its logits within 1e-6 of max |logit|; then mamba2-1.3b and
     granite-moe-1b-a400m at full width in f32: ``serve_lm`` at the
     reference's defaults, the reference's prefill-then-decode consistency
     test within 5e-3 (no-drop capacity for the MoE), the same weights on
     the CPU (B = 1, 8 prompt tokens, 2 decode steps; logits within 1e-3,
     greedy tokens equal wherever the top-2 margin exceeds the error), and
     an ``lm:`` JSON line with the peak memory, prefill time, decode-step
     device and call time, tokens/s, launches and host ops per step, and
     the step's bound (its f32 weight bytes over 3.35 TB/s); beside them
     the captured step's capture time, device and call time per token,
     device and host launches per token, and the bytes one in-place step
     writes into its caches (its slots only: no window copied; the
     functional step's window copies for contrast); the captured tokens
     equal to the eager step's over every generated step; every kernel
     launch counter must be unchanged across the phase;
 10. training (``repro_torch.launch.train``; on one card the whole step is
     a CUDA graph, ``steps.CapturedTrainStep``: one eager warm-up step,
     then one replay per step; every AdamW update one launch of the fused
     kernel, ``kernels/csrc/adamw.cu``, per group of leaves):
     one arch per family and internvl2-26b's ``embeds`` batches,
     reduced, in f32 with remat on: one train step on the card
     against the same weights and batch on the CPU (loss within 1e-5,
     ``grad_norm`` within 1e-4, the new master within 1e-2 * lr plus
     Adam's bound for near-zero gradients), the loss and gradients with
     remat on against remat off on the card, and, under
     ``torch.use_deterministic_algorithms(True)``, three calls of the
     captured step (two replays) against three eager steps from the same
     weights and batches: bit-equal where no atomics sum, the MoE's loss
     within 1e-5 and ``grad_norm`` within 1e-4; the entry point reduced
     (``--reduced --steps 12 --ckpt-every 4 --inject-fault-at 6``) under
     deterministic algorithms: one capture and a replay in every later
     step, one restart, finite and falling losses, final weights and
     optimizer state bit-equal to a run without the fault, and the last
     checkpoint restored into a fresh model bit for bit; then
     granite-moe-1b-a400m at full width through
     ``main`` at its defaults (bf16, B = 8, S = 128, remat on, 10 steps;
     one capture, 9 replays): finite and falling losses, the first near
     ln(vocab), the final
     checkpoint restored bit for bit; in f32 at B = 1, S = 16 the loss and
     gradient norm on the card against the CPU with the same weights; and a
     ``train:`` JSON line with the parameter count, the graph's figures
     (capture seconds, captures, replays, device and call time per step,
     device and host launches per step, the capture's and main's peak
     memory), beside them the eager step's on the same state (peak memory,
     device and call time, tokens/s, launches and host ops per step), the
     step's bound, the checkpoint's save and restore time; the fused AdamW kernel
     launched once per group in every step of ``main`` and of
     ``train_step``, bit-equal to its plain version for one update of
     every group on the full-width state (bf16 and f32 parameters), and an
     ``adamw:`` JSON line with its time over one update beside its bytes
     bound, its plain version's and ``torch._fused_adamw_``'s; no other
     kernel launch counter may move;
 11. training on a ``data x model`` mesh, one process per mesh slot (the
     fused AdamW kernel on each rank's ZeRO slices, launched in every
     rank): which collectives this torch's
     ``gloo`` takes on CUDA tensors (two ranks on the card); then four
     ranks on the card at 2x2, reduced, f32: one step per family against
     the one-device step on the card from the same weights and batch (loss
     within 1e-5, ``grad_norm`` within 1e-4, the new master within Adam's
     bound; for the MoE, whose aux loss is a per-shard estimator, ce and
     its gradient norm, and the loss differing by 0.01 x the aux losses'
     difference), ``moe_a2a`` against the dense dispatch, the ring matmul
     and ``quantized_psum``; decode on the mesh per family against one
     device in each rank (prefill on the mesh, its caches in
     ``cache_specs``' layout, ``grow_caches`` on the mesh, three steps,
     the last past the window; a KV window of 7, whole on every rank, and
     mamba2 with 3 heads and 128 conv channels among them) within 1e-5;
     granite-moe-1b-a400m at full width through
     ``main --data-mesh 2 --model-mesh 2`` at its defaults (finite and
     falling losses, the first near ln(vocab)), its last checkpoint
     resharded onto 2x1 by two processes and held against the files bit
     for bit; the figures of a full-width 2x2 step per rank (call time
     from ``main``, device time from a trace, collectives, peak memory);
     in f32 at B = 2, S = 16 with
     no-drop capacity, ce and its gradient norm at 2x2 against one device;
     and a ``mesh train:`` JSON line; no BSR or MoE kernel launch counter
     may move in any rank;
 12. the dry run (``repro_torch.launch.cost_analysis``) against the card,
     in the same run: granite-moe-1b-a400m at phase 11's setting traced on
     ``meta`` as rank 0 of a fake 2x2 world must count phase 11's rank 0's
     collective calls and bytes exactly; one reduced arch per family (and
     the vision stub) must count the same FLOPs on ``meta`` as
     FlopCounterMode on the card's real train, prefill and decode steps;
     the predicted peak memory at phase 10's 1x1 and phase 11's 2x2 within
     20 % of their ``max_memory_allocated``; the roofline's three terms of
     both beside the measured step times; a ``dryrun:`` JSON line per
     check; no kernel launch, and at most 120 s.

The last two lines are the card's name and power limit, then
``{"ok": true, "device": {...}}``; the line before them is the ``kernels``
JSON.  Without a CUDA device, or without ``src/repro_torch`` beside this
file, it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent
SIZES = [1024, 4096, 1024]
DENSITY, BLOCK, REORDER_ITERS = 0.1, 128, 300
BATCHES = (1, 4, 32, 33)
MAIN_B = 4
# kernel vs plain on the same inputs: both accumulate in f32, in different
# orders (FMA chain vs per-block matmul) -> f32 outputs agree to 1e-4;
# bf16 outputs may round one bf16 ulp apart -> 3e-2 (as the reference's
# kernel tests).  Error = max |a - b| / (1 + |b|).
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# moe_ffn vs plain: as the reference's moe tests (bf16 rounds h and the
# output to bf16 on both sides, from sums taken in different orders)
MOE_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# Granite-3.0-1B-A400M's experts (configs/granite_moe_1b_a400m.py); C is
# the capacity of 2048 tokens at top-8, capacity factor 1.25
MOE_E, MOE_C, MOE_D, MOE_F = 32, 640, 1024, 512
MOE_F_TILES = (128, 512)
# the gated checks: input tiles zeroed in x, hidden tiles killed
DEAD_IN_TILES, KILL_BIAS = 4, -10.0
# phase 7: the serving runtime's top bucket, traffic and thread counts
RUNTIME_B, RUNTIME_REQUESTS, SUBMITTERS = 32, 256, 4
CONC_THREADS, CONC_LAUNCHES = 8, 50
RATE_WORKERS = (0, 1, 4)
# the rates: requests per submit_all call (under the admission bound), the
# least seconds of one timed window, and of the profiled one
RATE_CHUNK, RATE_WINDOW_S, PROFILED_WINDOW_S = 512, 3.0, 1.0
WAIT_S = 120.0
# phase 8: the sharded meshes on the kernel route, their batches, and the
# deadline of the two-process gloo run
SHARD_MESHES, SHARD_BATCHES = ((2, 1), (4, 1), (4, 2)), (1, 4, 33)
GLOO_TIMEOUT_S = 300.0
# phase 5's large calls: the offline benchmark cells' batch, on the widths
# of the benchmark's two nets (bench/configs): sizes, block, activation
LARGE_B = 4096
LARGE_NETS = {"bert-ffnn": ([1024, 4096, 1024], 128, "gelu"),
              "random-mlp-512x5": ([512] * 5, 64, "relu")}
# H100 SXM data-sheet peaks: HBM bytes/s, f32 FMA operations/s outside the
# tensor cores (the kernels' arithmetic) and bf16 tensor-core operations/s.
# phase 9: LM serving; reduced archs at --batch 4 --prompt-len 32 --gen 16
# (card vs CPU within LM_DEVICE_TOL of max |logit|), the two full-width
# models (card vs CPU within LM_FULL_TOL; the consistency test's 5e-3)
LM_FULL = ("mamba2-1.3b", "granite-moe-1b-a400m")
LM_PROMPT, LM_GEN, LM_REDUCED_REQUESTS = 32, 16, 8
LM_DEVICE_TOL, LM_FULL_TOL, LM_CONSISTENCY_TOL = 1e-4, 1e-3, 5e-3
# the captured decode step against the eager one on the same caches, of
# max |logit|: the same kernels in the same order, but the MoE combine's
# index_add_ sums with atomics, in an order that may change between runs
LM_GRAPH_TOL = 1e-6
LM_CPU_STEPS, LM_TIMED_STEPS, LM_PROFILED_STEPS = 2, 10, 5
# phase 10: one arch per family (and the vision stub's embeds), reduced,
# card vs CPU (TRAIN_LOSS_TOL, TRAIN_GNORM_TOL); the entry point reduced,
# then TRAIN_FULL at full width for TRAIN_FULL_STEPS steps
TRAIN_ARCHS = ("granite-moe-1b-a400m", "codeqwen1.5-7b", "mamba2-1.3b",
               "zamba2-1.2b", "seamless-m4t-medium", "internvl2-26b")
TRAIN_LOSS_TOL, TRAIN_GNORM_TOL = 1e-5, 1e-4
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)
TRAIN_FULL, TRAIN_FULL_STEPS = "granite-moe-1b-a400m", 10
TRAIN_CPU_B, TRAIN_CPU_S = 1, 16
# a full-width step is ~16k launches and a profiled one costs seconds of
# trace processing: device_ms traces one step (after one warm-up step), so
# its whole-number-per-call check never retries
TRAIN_TIMED_STEPS, TRAIN_PROFILED_STEPS = 5, 1
# the captured train step (steps.CapturedTrainStep) against the eager one
# per reduced arch: one warm-up step, then two replays; a replay is one
# graph launch, so its trace is cheap
TRAIN_GRAPH_STEPS, TRAIN_GRAPH_PROFILED_STEPS = 3, 2
# phase 11: the mesh; one step per family at 2x2 (reduced), then
# TRAIN_FULL at full width: the f32 check's batch; the collectives the
# probe tries on CUDA tensors
MESH_ARCHS = ("codeqwen1.5-7b", "granite-moe-1b-a400m", "mamba2-1.3b",
              "zamba2-1.2b", "seamless-m4t-medium")
MESH_F32_B, MESH_F32_S = 2, 16
MESH_PROBES = ("all_reduce f32", "all_reduce bf16", "all_gather_into_tensor",
               "reduce_scatter_tensor", "all_to_all_single",
               "batch_isend_irecv")
MESH_PROBE_WAIT_S = 60
# phase 11's decode on the mesh against one device (tests/test_torch_
# dryrun.py's tolerance): (name, arch, config changes, KV window)
MESH_DECODE = (
    ("dense", "codeqwen1.5-7b", {}, 8),
    ("dense window 7", "codeqwen1.5-7b", {}, 7),
    ("moe", "granite-moe-1b-a400m", {"capacity_factor": 4.0}, 8),
    ("ssm", "mamba2-1.3b", {}, 8),
    ("ssm H 3 Ch 128", "mamba2-1.3b", {"d_model": 48, "ssm_headdim": 32}, 8),
    ("hybrid", "zamba2-1.2b", {}, 8),
    ("encdec", "seamless-m4t-medium", {}, 8),
)
MESH_DECODE_TOL = 1e-5
F32_OPS = 67e12
# phase 12: the dry run against the card; one reduced arch per family
# (and the vision stub) for the FLOP checks, at these sizes
DRY_ARCHS = ("codeqwen1.5-7b", "granite-moe-1b-a400m", "mamba2-1.3b",
             "zamba2-1.2b", "seamless-m4t-medium", "internvl2-26b")
DRY_B, DRY_S, DRY_W = 2, 32, 64
DRY_MEM_TOL, DRY_BUDGET_S = 0.2, 120.0
TPU_KERNELS = {
    "bsr_matmul": "src/repro/kernels/bsr_matmul.py:81",
    "bsr_megakernel": "src/repro/kernels/bsr_matmul.py:279",
    "bsr_megakernel_gated": "src/repro/kernels/bsr_matmul.py:279",
    "moe_ffn": "src/repro/kernels/moe_ffn.py:47",
    # no Pallas kernel: XLA's fusion of the reference's update under jit
    "adamw": "src/repro/optim/adamw.py:55",
}
SOURCES = {
    "bsr_matmul": "src/repro_torch/kernels/csrc/bsr_matmul.cu",
    "bsr_megakernel": "src/repro_torch/kernels/csrc/bsr_kernels.cu",
    "bsr_megakernel_gated": "src/repro_torch/kernels/csrc/bsr_kernels.cu",
    "moe_ffn": "src/repro_torch/kernels/csrc/moe_ffn.cu",
    "adamw": "src/repro_torch/kernels/csrc/adamw.cu",
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def rel_err(a, b):
    a, b = a.float(), b.float()
    return float(((a - b).abs() / (1 + b.abs())).max()), \
        float((a - b).abs().max())


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def median_ms(fn, runs=30, warm=5):
    """Median over ``runs`` single calls, each bracketed by CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, runs=30, warm=5, tries=5):
    """Device time per call (ms): the summed duration of the GPU activities
    (kernels, copies) that ``runs`` calls put on the card, from a
    torch.profiler trace, over ``runs``.  Host time between launches is not
    in it.  Once other traces or processes have used the card, a trace
    misses its first few kernels, so the ``warm`` calls run inside the
    trace and only activity that starts within a marked range after them
    counts (not the range's own device-side annotation); a trace whose
    activity is not a whole number per call is taken again, up to
    ``tries`` times.  None when no trace shows it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    mark = "chip_smoke.timed"
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(warm):
                fn()
            torch.cuda.synchronize()
            with record_function(mark):
                for _ in range(runs):
                    fn()
                torch.cuda.synchronize()
        events = prof.events()
        t0 = min((e.time_range.start for e in events if e.name == mark
                  and e.device_type == DeviceType.CPU), default=None)
        dev = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name != mark and t0 is not None
               and e.time_range.start >= t0]
        if dev and len(dev) % runs == 0:
            return sum(e.time_range.elapsed_us() for e in dev) / 1e3 / runs
    return None


def hbm_bps():
    """The card's HBM rate: the dry run's roofline constant
    (``cost_analysis.HBM_BW``), so bounds here and there cannot drift."""
    from repro_torch.launch.cost_analysis import HBM_BW

    return HBM_BW


def bf16_ops():
    """The card's dense bf16 tensor-core rate (``cost_analysis.PEAK_FLOPS``;
    F32_OPS, the f32 FMA rate, has no counterpart in the roofline)."""
    from repro_torch.launch.cost_analysis import PEAK_FLOPS

    return PEAK_FLOPS


def bound_ms(n_bytes, n_ops, ops_rate=F32_OPS):
    t_bytes, t_ops = n_bytes / hbm_bps(), n_ops / ops_rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_env():
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    cap = torch.cuda.get_device_capability(0)
    print(f"device 0: {torch.cuda.get_device_name(0)}, capability {cap}, "
          f"{torch.cuda.device_count()} device(s)")
    check(cap == (9, 0), f"expected an sm_90 device, got capability {cap}")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmul is on; the plain versions need full f32 products")
    smi = nvidia_smi()
    print(f"nvidia-smi: {smi}")
    return smi


# the kernels whose registers and spills phase 2 reports, as their mangled
# names begin
NEW_KERNELS = ("bsr_matmul_kernel", "bsr_megakernel_kernel",
               "bsr_megakernel_row_tiled_kernel", "moe_bf16_kernel",
               "moe_f32_kernel", "adamw_kernel")


def ptxas_summary(log):
    """Registers, shared memory and spills of each instance of the new
    kernels, from ``nvcc -Xptxas -v``'s output."""
    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = next((k for k in NEW_KERNELS if k in m.group(1)), None)
            # the template arguments, as mangled
            args = m.group(1).split(name, 1)[1].split("EEv")[0] \
                if name else ""
            spills = (0, 0)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append({"kernel": name, "instance": args,
                         "registers": int(m.group(1)),
                         "static_smem": int(smem.group(1)) if smem else 0,
                         "spill_stores": spills[0],
                         "spill_loads": spills[1]})
            name = None
    return rows


def cuobjdump():
    """The toolkit's cuobjdump, else the one Triton carries, else None."""
    found = shutil.which("cuobjdump")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/cuobjdump")
    if cand.exists():
        return str(cand)
    try:
        import triton
    except ImportError:
        return None
    cand = Path(triton.__file__).parent / "backends/nvidia/bin/cuobjdump"
    return str(cand) if cand.exists() else None


def phase_build():
    from repro_torch.kernels import _build

    path, seconds, log = _build.build()
    print(f"build: {path.name} in {seconds:.1f} s (nvcc, sm_90a, "
          f"{len(_build.SOURCES)} sources)")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
        elif "arning" in line:
            print(f"  nvcc: {line.strip()}")
    if seconds:
        summary = ptxas_summary(log)
        check({r["kernel"] for r in summary} == set(NEW_KERNELS),
              f"ptxas reported {sorted({r['kernel'] for r in summary})}")
        print("ptxas: " + json.dumps(summary))
    else:
        print("ptxas: the build was reused; no compiler output")
    _build.load()
    tool = cuobjdump()
    if tool is None:
        print("sass: no cuobjdump on this machine; HGMMA not inspected")
        return
    proc = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, timeout=300)
    check(proc.returncode == 0, f"cuobjdump failed: {proc.stderr[:500]}")
    counts, fn = {}, None
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = next((k for k in NEW_KERNELS if k in m.group(1)), None)
        elif fn is not None and "HGMMA" in line:
            counts[fn] = counts.get(fn, 0) + 1
    print(f"sass ({tool}): HGMMA instructions per kernel "
          + json.dumps({k: counts.get(k, 0) for k in NEW_KERNELS}))
    check(counts.get("moe_bf16_kernel", 0) > 0,
          "the bf16 moe_ffn kernel's SASS holds no HGMMA instruction")


def compile_plans(layers, Engine):
    plans = {}
    for wdt in ("f32", "bf16", "fp8"):
        engine = Engine(activation="gelu", reorder=True,
                        reorder_iters=REORDER_ITERS, weight_dtype=wdt,
                        device="cuda")
        plans[wdt] = engine.compile(layers)
        check(plans[wdt].fused, f"{wdt} plan did not fuse")
    return plans


def phase_kernels(plans, rng):
    from repro_torch.kernels import bsr_matmul as K

    worst = {"bsr_matmul": (0.0, 0.0), "bsr_megakernel": (0.0, 0.0)}
    main_err = {}
    n = n_bit = 0
    grids = {}
    for wdt, plan in plans.items():
        biases = [torch.as_tensor(l.bias).cuda() for l in plan.layers]
        acts = ["gelu", "none"]
        for B in BATCHES:
            x32 = torch.from_numpy(
                rng.standard_normal((B, SIZES[0])).astype(np.float32)).cuda()
            for xdt in (torch.float32, torch.bfloat16):
                x = x32.to(xdt)
                # per layer; layer 1 reads the plain layer-0 output
                h = x
                for k, (sch, bias) in enumerate(zip(plan.schedules, biases)):
                    before = K.bsr_matmul.launches
                    y = K.bsr_matmul(h, sch, bias, acts[k])
                    check(K.bsr_matmul.launches == before + 1,
                          "bsr_matmul did not count its launch")
                    y_ref = K.bsr_matmul_plain(h, sch, bias, acts[k])
                    torch.cuda.synchronize()
                    check(not sch.arrivals.any(), f"bsr_matmul layer {k} "
                          f"{wdt} B={B}: arrival counters not zero")
                    err, abs_err = rel_err(y, y_ref)
                    check(y.dtype == xdt and y.shape == y_ref.shape,
                          "bsr_matmul output dtype/shape")
                    check(err < TOL[xdt], f"bsr_matmul layer {k} {wdt} x "
                          f"{xdt} B={B}: error {err:.3e} >= {TOL[xdt]}")
                    worst["bsr_matmul"] = max(worst["bsr_matmul"],
                                              (err, abs_err))
                    if (wdt, B, xdt, k) == ("f32", MAIN_B, torch.float32, 1):
                        main_err["bsr_matmul"] = abs_err
                    h = y_ref
                    n += 1
                before = K.bsr_megakernel.launches
                y = K.bsr_megakernel(x, plan.flat, "gelu", "none")
                check(K.bsr_megakernel.launches == before + 1,
                      "bsr_megakernel did not count its launch")
                grids[f"{wdt} B={B}"] = K.bsr_megakernel.grid
                y_ref = K.bsr_megakernel_plain(x, plan.flat, "gelu", "none")
                torch.cuda.synchronize()
                check(not plan.flat.arrivals.any(), f"bsr_megakernel {wdt} "
                      f"x {xdt} B={B}: arrival counters not zero")
                if xdt == torch.float32:
                    # the same split-K walk: bit-equal to two bsr_matmul
                    # launches, which keep the hidden tile in f32 too
                    y_two = K.bsr_matmul(K.bsr_matmul(
                        x, plan.schedules[0], biases[0], "gelu"),
                        plan.schedules[1], biases[1], "none")
                    check(torch.equal(y, y_two), f"bsr_megakernel {wdt} "
                          f"B={B}: not bit-equal to two bsr_matmul launches")
                    n_bit += 1
                err, abs_err = rel_err(y, y_ref)
                check(err < TOL[xdt], f"bsr_megakernel {wdt} x {xdt} B={B}: "
                      f"error {err:.3e} >= {TOL[xdt]}")
                worst["bsr_megakernel"] = max(worst["bsr_megakernel"],
                                              (err, abs_err))
                if (wdt, B, xdt) == ("f32", MAIN_B, torch.float32):
                    main_err["bsr_megakernel"] = abs_err
                n += 1
    for name, (err, abs_err) in worst.items():
        print(f"kernel vs plain: {name} worst relative error {err:.3e}, "
              f"worst abs error {abs_err:.3e} (tolerance f32 {TOL[torch.float32]}, "
              f"bf16 {TOL[torch.bfloat16]})")
    print(f"kernel vs plain: {n} comparisons passed "
          f"(weights f32/bf16/fp8, x f32/bf16, B in {BATCHES}); with f32 x "
          f"the megakernel bit-equal to two bsr_matmul launches in {n_bit} "
          "of them; arrival counters zero after every launch")
    print("megakernel cooperative grid (CTAs): " + json.dumps(grids))
    return main_err


def kill_tiles(layers):
    """Half of every hidden layer's output tiles dead: a bias of -10 keeps
    each pre-activation there below zero, so relu zeroes the tile."""
    out = []
    for k, lay in enumerate(layers):
        if k < len(layers) - 1:
            bias = np.array(lay.bias, np.float32)
            bias.reshape(lay.grid_out, lay.block_n)[:lay.grid_out // 2] = \
                KILL_BIAS
            lay = dataclasses.replace(lay, bias=bias)
        out.append(lay)
    return out


def sparse_rows(rng, n):
    """n Gaussian feature vectors whose first DEAD_IN_TILES input tiles are
    zero (what users with sparse feature vectors send)."""
    x = rng.standard_normal((n, SIZES[0])).astype(np.float32)
    x[:, :DEAD_IN_TILES * BLOCK] = 0.0
    return x


def phase_gated_kernels(layers, rng, Engine):
    """Gated megakernel vs its plain version and vs the ungated kernel."""
    from repro_torch.engine import tile_occupancy
    from repro_torch.kernels import bsr_matmul as K

    killed = kill_tiles(layers)
    worst, main_err, n, fractions = (0.0, 0.0), None, 0, []
    for wdt in ("f32", "bf16", "fp8"):
        plan = Engine(activation="relu", reorder=True,
                      reorder_iters=REORDER_ITERS, weight_dtype=wdt,
                      gate=True, device="cuda").compile(killed)
        check(plan.fused and plan.gate, f"gated {wdt} plan did not fuse")
        flat = plan.flat
        for B in BATCHES:
            x32 = torch.from_numpy(sparse_rows(rng, B)).cuda()
            for xdt in (torch.float32, torch.bfloat16):
                x = x32.to(xdt)
                occ0 = tile_occupancy(x, BLOCK, SIZES[0] // BLOCK)
                before = K.bsr_megakernel.gated_launches
                y, occ = K.bsr_megakernel(x, flat, "relu", "none", gate=True,
                                          occ0=occ0)
                check(K.bsr_megakernel.gated_launches == before + 1,
                      "the gated megakernel did not count its launch")
                y_ref, occ_ref = K.bsr_megakernel_plain(
                    x, flat, "relu", "none", gate=True, occ0=occ0)
                y_ungated = K.bsr_megakernel(x, flat, "relu", "none")
                torch.cuda.synchronize()
                check(not flat.arrivals.any(), f"gated {wdt} x {xdt} B={B}: "
                      "arrival counters not zero")
                check(torch.equal(occ.cpu(), occ_ref.cpu()),
                      f"gated {wdt} x {xdt} B={B}: occupancy {occ.tolist()} "
                      f"!= plain {occ_ref.tolist()}")
                check(torch.equal(y, y_ungated),
                      f"gated {wdt} x {xdt} B={B}: output not bit-equal to "
                      "the ungated kernel's")
                err, abs_err = rel_err(y, y_ref)
                check(err < TOL[xdt], f"gated {wdt} x {xdt} B={B}: error "
                      f"{err:.3e} >= {TOL[xdt]}")
                worst = max(worst, (err, abs_err))
                if (wdt, B, xdt) == ("f32", MAIN_B, torch.float32):
                    main_err = abs_err
                n += 1
            rep = plan.measure_dynamic(x32)
            fractions.append(rep.read_fraction)
            check(rep.read_fraction < 1.0,
                  f"gated {wdt} B={B}: read fraction {rep.read_fraction}")
            print(f"gated {wdt} B={B}: {rep.summary()}")
    print(f"gated kernel vs plain: {n} comparisons passed, occupancy equal, "
          f"output bit-equal to the ungated kernel, counters zero; worst "
          f"relative error "
          f"{worst[0]:.3e}, worst abs error {worst[1]:.3e}; read fraction "
          f"{min(fractions):.4f}..{max(fractions):.4f}")
    return main_err


def phase_main_path(no_fuse):
    from repro_torch.kernels import bsr_matmul as K
    from repro_torch.launch import serve

    argv = ["--sparse-ffnn", "--batch", str(MAIN_B), "--requests", "64",
            "--reorder-iters", str(REORDER_ITERS)]
    if no_fuse:
        argv.append("--no-fuse")
    args = serve.parse_args(argv)
    plans, server = serve.build_server(args)
    K.reset_launches()
    report = serve.drive(server, args)
    torch.cuda.synchronize()
    launches = {"bsr_matmul": K.bsr_matmul.launches,
                "bsr_megakernel": K.bsr_megakernel.launches}
    print(f"main path{' --no-fuse' if no_fuse else ''}: "
          f"{server.metrics.summary()}; {report.forwards} forwards, "
          f"launches {launches}")
    check(len(report.inputs) == 64, "not every request was admitted")
    check(all(y is not None for y in report.outputs.values()),
          "a request went unanswered")
    n_layers = len(plans.base.layers)
    if no_fuse:
        check(not plans.base.fused, "--no-fuse plan is fused")
        check(launches == {"bsr_matmul": n_layers * report.forwards,
                           "bsr_megakernel": 0},
              "layered forwards did not each launch bsr_matmul per layer")
    else:
        check(plans.base.fused, "default plan is not fused")
        check(launches == {"bsr_matmul": 0,
                           "bsr_megakernel": report.forwards},
              "fused forwards did not each launch the megakernel once")
    rids = sorted(report.inputs)
    x = torch.from_numpy(np.stack([report.inputs[r] for r in rids])).cuda()
    y = torch.from_numpy(np.stack([report.outputs[r] for r in rids]))
    y_ref = plans.base.plain()(x).cpu()
    err, _ = rel_err(y, y_ref)
    check(y.shape == (64, SIZES[-1]) and bool(torch.isfinite(y).all()),
          "served answers are not finite [64, 1024]")
    check(err < TOL[torch.float32],
          f"served answers vs plain version: error {err:.3e}")
    print(f"main path answers vs plain (torch-backend) version: error "
          f"{err:.3e}")
    return launches, server, args


def expected_dynamic(plan, dead_in):
    """Blocks a gated forward reads on Gaussian rows whose first ``dead_in``
    input tiles are zero: every layer-0 step on a live input tile, and
    every layer-1 step on a hidden tile that some nonzero layer-0 block
    fills from a live input tile (any other hidden tile holds gelu(0) = 0
    for every row)."""
    rows = plan.flat.rows.cpu().numpy()
    (s0, e0), (s1, e1) = plan.flat.segments
    lay = plan.layers[0]
    live_hidden = {int(c) for r, c in zip(lay.rows, lay.cols) if r >= dead_in}
    return (int(np.sum(rows[s0:e0] >= dead_in)),
            int(sum(r in live_hidden for r in rows[s1:e1].tolist())))


def phase_gated_main_path():
    """``serve --gate``: Gaussian requests through ``serve.drive``, then 64
    requests whose first input tiles are zero, with a dynamic-I/O sample
    after every batch."""
    from repro_torch.kernels import bsr_matmul as K
    from repro_torch.launch import serve

    args = serve.parse_args(["--sparse-ffnn", "--batch", str(MAIN_B),
                             "--requests", "64", "--reorder-iters",
                             str(REORDER_ITERS), "--gate"])
    plans, server = serve.build_server(args)
    base = plans.base
    check(base.fused and base.gate and base._measure is not None,
          "--gate plan is not a gated fused plan")
    check(server.measure_dynamic_every == 1, "--gate does not sample")
    K.reset_launches()
    report = serve.drive(server, args)
    torch.cuda.synchronize()
    gauss = server.io.snapshot()
    calls0 = sum(plans.bucket_calls.values())
    rng = np.random.default_rng(3)
    xs = sparse_rows(rng, 64)
    rids = []
    for i, x in enumerate(xs):
        rids.append(server.submit(x))
        if i % 3 == 2:
            server.poll()
    server.drain()
    answers = [server.result(r) for r in rids]
    torch.cuda.synchronize()
    launches = {"bsr_matmul": K.bsr_matmul.launches,
                "bsr_megakernel": K.bsr_megakernel.launches,
                "bsr_megakernel_gated": K.bsr_megakernel.gated_launches}
    snap = server.io.snapshot()
    forwards = report.forwards + sum(plans.bucket_calls.values()) - calls0
    print(f"main path --gate: {server.metrics.summary()}; {forwards} "
          f"forwards, {snap['batches_measured']} dynamic-I/O samples, "
          f"launches {launches}")
    check(launches == {"bsr_matmul": 0, "bsr_megakernel": 0,
                       "bsr_megakernel_gated":
                           forwards + snap["batches_measured"]},
          "gated forwards did not each launch the gated megakernel once")
    check(server.metrics.io_measure_failed == 0,
          f"{server.metrics.io_measure_failed} dynamic-I/O samples failed")
    check(snap["batches_measured"] == server.metrics.batches,
          "not every batch was sampled")
    # Gaussian traffic: every input tile live; hidden tiles that no weight
    # block writes are dead for every request
    per0, per1 = expected_dynamic(base, 0)
    n_gauss = gauss["batches_measured"]
    static = base.flat.rows.numel()
    check(gauss["dynamic_blocks"] == n_gauss * (per0 + per1)
          and gauss["static_scheduled"] == n_gauss * static,
          f"Gaussian traffic: {gauss['dynamic_blocks']} dynamic blocks in "
          f"{n_gauss} samples, expected {per0 + per1} of {static} each")
    print(f"gated Gaussian traffic: read fraction {gauss['read_fraction']} "
          f"({per0 + per1}/{static} blocks per batch; "
          f"{static - per0 - per1} skipped, all on hidden tiles no weight "
          "block writes)")
    # sparse traffic: the layer-0 blocks on the zero input tiles are skipped
    per0s, per1s = expected_dynamic(base, DEAD_IN_TILES)
    n_sparse = snap["batches_measured"] - n_gauss
    dyn_sparse = snap["dynamic_blocks"] - gauss["dynamic_blocks"]
    last = base.io.dynamic
    check(n_sparse > 0 and dyn_sparse == n_sparse * (per0s + per1s),
          f"sparse traffic: {dyn_sparse} dynamic blocks in {n_sparse} "
          f"samples, expected {per0s + per1s} each")
    check(last.per_layer_dynamic[0] == per0s < last.per_layer_static[0],
          f"sparse traffic: layer 0 read {last.per_layer_dynamic[0]} of "
          f"{last.per_layer_static[0]} blocks")
    print(f"gated sparse traffic: read fraction "
          f"{dyn_sparse / (n_sparse * static):.4f} "
          f"({per0s + per1s}/{static} blocks per batch); last sample: "
          f"{last.summary()}")
    x = np.concatenate([np.stack([report.inputs[r]
                                  for r in sorted(report.inputs)]), xs])
    y = np.stack([report.outputs[r] for r in sorted(report.inputs)]
                 + answers)
    y = torch.from_numpy(y)
    check(y.shape == (128, SIZES[-1]) and bool(torch.isfinite(y).all()),
          "gated answers are not finite [128, 1024]")
    y_ref = base.plain()(torch.from_numpy(x).cuda()).cpu()
    err, _ = rel_err(y, y_ref)
    check(err < TOL[torch.float32],
          f"gated answers vs plain version: error {err:.3e}")
    print(f"main path --gate answers vs plain (torch-backend) version: "
          f"error {err:.3e}")
    return launches["bsr_megakernel_gated"]


def moe_inputs(dtype, seed=0):
    """Granite-width expert inputs, made on the card from a seed: x ~ N(0, 1),
    weights scaled by 1/sqrt(fan-in)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((MOE_E, MOE_C, MOE_D), generator=g, device="cuda")
    wu = torch.randn((MOE_E, MOE_D, MOE_F), generator=g, device="cuda")
    wd = torch.randn((MOE_E, MOE_F, MOE_D), generator=g, device="cuda")
    return (x.to(dtype), (wu / MOE_D ** 0.5).to(dtype),
            (wd / MOE_F ** 0.5).to(dtype))


def phase_moe():
    """moe_ffn vs plain, one call through the entry point, then times.  It
    runs after the BSR timings, so that its seconds of heavy arithmetic do
    not precede them."""
    from repro_torch.kernels import bsr_matmul as K
    from repro_torch.kernels import moe_ffn as M

    worst, main_err = (0.0, 0.0), None
    for dtype in (torch.float32, torch.bfloat16):
        x, wu, wd = moe_inputs(dtype)
        for f_tile in MOE_F_TILES:
            before = M.moe_ffn.launches
            y = M.moe_ffn(x, wu, wd, "gelu", f_tile)
            check(M.moe_ffn.launches == before + 1,
                  "moe_ffn did not count its launch")
            y_ref = M.moe_ffn_plain(x, wu, wd, "gelu", f_tile)
            torch.cuda.synchronize()
            check(y.dtype == dtype and y.shape == x.shape
                  and bool(torch.isfinite(y).all()),
                  f"moe_ffn {dtype} f_tile={f_tile}: output dtype/shape")
            err, abs_err = rel_err(y, y_ref)
            check(err < MOE_TOL[dtype], f"moe_ffn {dtype} f_tile={f_tile}: "
                  f"error {err:.3e} >= {MOE_TOL[dtype]}")
            worst = max(worst, (err, abs_err))
            if (dtype, f_tile) == (torch.float32, MOE_F):
                main_err = abs_err
    # the other bf16 row tile, which phase 6 also times
    x, wu, wd = moe_inputs(torch.bfloat16)
    y = M.launch(x, wu, wd, K.activation_code("gelu"), M.moe_tile_plan(
        MOE_E, MOE_C, MOE_D, MOE_F, torch.bfloat16, rows=64))
    y_ref = M.moe_ffn_plain(x, wu, wd, "gelu", MOE_F)
    torch.cuda.synchronize()
    err, abs_err = rel_err(y, y_ref)
    check(err < MOE_TOL[torch.bfloat16],
          f"moe_ffn bf16, 64-row tiles: error {err:.3e}")
    worst = max(worst, (err, abs_err))
    print(f"moe_ffn vs plain: 5 comparisons passed (f32/bf16, f_tile in "
          f"{MOE_F_TILES}, bf16 with 64-row tiles); worst relative error {worst[0]:.3e}, worst abs "
          f"error {worst[1]:.3e} (tolerance f32 {MOE_TOL[torch.float32]}, "
          f"bf16 {MOE_TOL[torch.bfloat16]})")
    x, wu, wd = moe_inputs(torch.float32)
    M.moe_ffn.launches = 0
    y = M.moe_ffn(x, wu, wd)
    torch.cuda.synchronize()
    launches = M.moe_ffn.launches
    check(launches == 1 and bool(torch.isfinite(y).all()),
          f"moe_ffn entry point: {launches} launches")
    del x, wu, wd, y
    # times; the yardstick is bmm -> gelu -> bmm, three calls
    gelu = K.ACTIVATIONS["gelu"]
    main_row = None
    for dtype, f_tile, rows in ((torch.float32, MOE_F, None),
                                (torch.float32, 128, None),
                                (torch.bfloat16, MOE_F, None),
                                (torch.bfloat16, MOE_F, 64)):
        mx, wu, wd = moe_inputs(dtype)
        nbytes = mx.element_size() * (2 * mx.numel() + wu.numel()
                                      + wd.numel())
        nops = 4 * MOE_E * MOE_C * MOE_D * MOE_F
        b_ms, b_by = bound_ms(nbytes, nops, F32_OPS if dtype == torch.float32
                              else bf16_ops())
        plan = M.moe_tile_plan(MOE_E, MOE_C, MOE_D, MOE_F, dtype, rows)
        ctas = MOE_E * -(-MOE_C // plan.rows)
        # the entry point, or the kernel with the other bf16 row tile
        kernel = (lambda: M.moe_ffn(mx, wu, wd, "gelu", f_tile)) \
            if rows is None else (lambda: M.launch(
                mx, wu, wd, K.activation_code("gelu"), plan))
        row = timed(
            "moe_ffn", "f32" if dtype == torch.float32 else "bf16",
            f"E={MOE_E} C={MOE_C} d={MOE_D} f={MOE_F} f_tile={f_tile}, "
            f"{plan.rows} rows x {ctas} CTAs, f-chunk {plan.f_chunk}, "
            f"{plan.route}", kernel,
            lambda: M.moe_ffn_plain(mx, wu, wd, "gelu", f_tile),
            lambda: torch.bmm(gelu(torch.bmm(mx, wu)).to(dtype), wd),
            b_ms, b_by)
        print("time: " + json.dumps(row))
        if (dtype, f_tile) == (torch.float32, MOE_F):
            main_row = row
        del mx, wu, wd
    return launches, main_err, main_row


def timed(name, wdt, shape, kernel, plain, library, b_ms, b_by):
    """One timing row.  ``ms`` / ``library_ms``: device time per call
    (profiler); ``call_ms`` / ``library_call_ms``: per-call time between
    CUDA events, which adds the host time of the call (wrapper, launch);
    ``plain_ms``: per-call event time of the plain version, which is
    host-bound (one small launch per schedule step)."""
    k_dev, l_dev = device_ms(kernel), device_ms(library)
    k_call, l_call = median_ms(kernel), median_ms(library)
    return {
        "name": name, "weights": wdt, "shape": shape,
        "ms": k_dev if k_dev is not None else k_call, "call_ms": k_call,
        "plain_ms": median_ms(plain),
        "library_ms": l_dev if l_dev is not None else l_call,
        "library_call_ms": l_call,
        "bound_ms": b_ms, "bound_by": b_by,
        "timing": "profiler" if k_dev is not None else "events",
    }


def phase_times(plans, rng):
    from repro_torch.engine import tile_occupancy
    from repro_torch.kernels import bsr_matmul as K
    from repro_torch.kernels.ref import bsr_to_dense

    gelu = K.ACTIVATIONS["gelu"]
    x = torch.from_numpy(
        rng.standard_normal((MAIN_B, SIZES[0])).astype(np.float32)).cuda()
    detail = []
    entries = {}
    for wdt, plan in plans.items():
        layers, schs = plan.layers, plan.schedules
        biases = [torch.as_tensor(l.bias).cuda() for l in layers]
        itemsize = schs[0].blocks.element_size()
        per_block = BLOCK * BLOCK * itemsize + (4 if wdt != "f32" else 0)
        dense = []
        for lay, sch in zip(layers, schs):
            w = sch.blocks.float()
            if sch.scales is not None:
                w = w * sch.scales[:, None, None]
            dense.append(bsr_to_dense(sch.rows.cpu(), sch.cols.cpu(), w,
                                      lay.grid_in, lay.grid_out))
        h1 = K.bsr_matmul_plain(x, schs[0], biases[0], "gelu")
        # bsr_matmul on the final layer (4096 -> 1024, linear epilogue):
        # exactly one torch.addmm on the densified layer computes it
        lay = layers[1]
        nbytes = (h1.numel() * 4 + lay.nnz_blocks * per_block
                  + lay.n_out * 4 + MAIN_B * lay.n_out * 4)
        nops = 2 * MAIN_B * BLOCK * BLOCK * lay.nnz_blocks
        b_ms, b_by = bound_ms(nbytes, nops)
        row = timed(
            "bsr_matmul", wdt, "layer 1, 4096->1024",
            lambda: K.bsr_matmul(h1, schs[1], biases[1]),
            lambda: K.bsr_matmul_plain(h1, schs[1], biases[1]),
            lambda: torch.addmm(biases[1], h1, dense[1]), b_ms, b_by)
        detail.append(row)
        if wdt == "f32":
            # layer 0 (1024 -> 4096, gelu): addmm -> gelu, two calls
            lay = layers[0]
            nbytes = (x.numel() * 4 + lay.nnz_blocks * per_block
                      + lay.n_out * 4 + MAIN_B * lay.n_out * 4)
            nops = 2 * MAIN_B * BLOCK * BLOCK * lay.nnz_blocks
            detail.append(timed(
                "bsr_matmul", wdt, "layer 0, 1024->4096, gelu",
                lambda: K.bsr_matmul(x, schs[0], biases[0], "gelu"),
                lambda: K.bsr_matmul_plain(x, schs[0], biases[0], "gelu"),
                lambda: gelu(torch.addmm(biases[0], x, dense[0])),
                *bound_ms(nbytes, nops)))
        # the whole net: a dense chain addmm -> gelu -> addmm as yardstick,
        # and the two bsr_matmul launches that --no-fuse runs as the second
        chain = (lambda xx: torch.addmm(biases[1], gelu(torch.addmm(
            biases[0], xx, dense[0])), dense[1]))

        def two_layers(xx):
            return device_ms(lambda: K.bsr_matmul(K.bsr_matmul(
                xx, schs[0], biases[0], "gelu"), schs[1], biases[1]))
        nnz = sum(l.nnz_blocks for l in layers)
        act_bytes = (x.numel() * 4 + sum(l.n_out for l in layers) * 4
                     + MAIN_B * SIZES[-1] * 4)
        b_ms, b_by = bound_ms(act_bytes + nnz * per_block,
                              2 * MAIN_B * BLOCK * BLOCK * nnz)
        mrow = timed(
            "bsr_megakernel", wdt, "whole net",
            lambda: K.bsr_megakernel(x, plan.flat, "gelu", "none"),
            lambda: K.bsr_megakernel_plain(x, plan.flat, "gelu", "none"),
            lambda: chain(x), b_ms, b_by)
        mrow["two_bsr_matmul_ms"] = two_layers(x)
        mrow["grid"] = K.bsr_megakernel.grid
        detail.append(mrow)
        if wdt == "f32":
            entries["bsr_matmul"] = row
            entries["bsr_megakernel"] = mrow
            # the gated megakernel on the same net, at 0 % and at 50 % dead
            # input tiles; the bound counts the blocks on live input tiles
            flat = plan.flat
            xs = x.clone()
            xs[:, :DEAD_IN_TILES * BLOCK] = 0.0
            for dead, xx in ((0, x), (DEAD_IN_TILES, xs)):
                occ0 = tile_occupancy(xx, BLOCK, SIZES[0] // BLOCK)
                _, occ = K.bsr_megakernel(xx, flat, "gelu", "none",
                                          gate=True, occ0=occ0)
                occs = [occ0.cpu().numpy(), occ[0].cpu().numpy()]
                rows_np = flat.rows.cpu().numpy()
                live = sum(int(np.sum(occs[k][rows_np[s:e]] > 0))
                           for k, (s, e) in enumerate(flat.segments))
                b_ms, b_by = bound_ms(
                    act_bytes + live * per_block + occ0.numel() * 4
                    + occ.numel() * 4, 2 * MAIN_B * BLOCK * BLOCK * live)
                grow = timed(
                    "bsr_megakernel_gated", wdt,
                    f"whole net, {100 * dead // (SIZES[0] // BLOCK)} % dead "
                    f"input tiles, {live}/{rows_np.size} blocks live",
                    lambda: K.bsr_megakernel(xx, flat, "gelu", "none",
                                             gate=True, occ0=occ0),
                    lambda: K.bsr_megakernel_plain(xx, flat, "gelu", "none",
                                                   gate=True, occ0=occ0),
                    lambda: chain(xx), b_ms, b_by)
                grow["grid"] = K.bsr_megakernel.grid
                ungated = (lambda: K.bsr_megakernel(xx, flat, "gelu",
                                                    "none"))
                grow["ungated_ms"] = device_ms(ungated) or median_ms(ungated)
                grow["two_bsr_matmul_ms"] = two_layers(xx)
                detail.append(grow)
            entries["bsr_megakernel_gated"] = grow   # the 50 % row
    for row in detail:
        print("time: " + json.dumps(row))
    return entries


def phase_times_large():
    """The megakernel at LARGE_B rows on each of LARGE_NETS (f32 weights
    and x), against its plain version, timed beside its bound and the
    dense chain addmm -> act -> ... -> addmm; the row's ``walk`` is the
    route the call took (split-K where the tree has no row-tiled one).
    The bound counts the kept blocks' FLOPs and x, y, the kept blocks and
    the biases once, as the benchmark's roofline does."""
    from repro_torch.engine import Engine
    from repro_torch.kernels import bsr_matmul as K
    from repro_torch.kernels.ref import bsr_to_dense
    from repro_torch.launch.serve import make_ffnn_layers

    rows = []
    for name, (sizes, block, act) in LARGE_NETS.items():
        layers = make_ffnn_layers(sizes, DENSITY, block)
        plan = Engine(activation=act, reorder=True,
                      reorder_iters=REORDER_ITERS, device="cuda").compile(
                          layers)
        check(plan.fused, f"{name}: the plan did not fuse")
        flat = plan.flat
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (LARGE_B, sizes[0])).astype(np.float32)).cuda()
        y = K.bsr_megakernel(x, flat, act, "none")
        err, _ = rel_err(y, K.bsr_megakernel_plain(x, flat, act, "none"))
        check(err < TOL[torch.float32],
              f"bsr_megakernel {name} B={LARGE_B}: error {err:.3e}")
        biases = [torch.as_tensor(l.bias).cuda() for l in layers]
        dense = [bsr_to_dense(l.rows, l.cols,
                              torch.as_tensor(l.blocks).cuda(), l.grid_in,
                              l.grid_out) for l in layers]
        fn = K.ACTIVATIONS[act]

        def chain():
            h = x
            for k, (b, w) in enumerate(zip(biases, dense)):
                h = torch.addmm(b, h, w)
                if k < len(dense) - 1:
                    h = fn(h)
            return h

        kept = sum(l.nnz_blocks for l in layers)
        nbytes = 4 * (x.numel() + LARGE_B * sizes[-1] + kept * block * block
                      + sum(sizes[1:]))
        row = timed("bsr_megakernel", "f32", f"{name}, B={LARGE_B}",
                    lambda: K.bsr_megakernel(x, flat, act, "none"),
                    lambda: K.bsr_megakernel_plain(x, flat, act, "none"),
                    chain, *bound_ms(nbytes,
                                     2 * LARGE_B * block * block * kept))
        row["walk"] = "row-tiled" if getattr(K, "row_tiled", None) and \
            K.row_tiled(LARGE_B, flat) else "split-K"
        row["grid"] = K.bsr_megakernel.grid
        row["max_rel_err"] = err
        print("time: " + json.dumps(row), flush=True)
        rows.append(row)
        del x, y, dense
    return rows


def kernel_line(entries, launches, main_err, sharded_launches):
    """The ``kernels`` JSON rows, one per kernel, from its timing row;
    ``bsr_matmul``'s also carries its launches on the sharded main path
    (``serve --mesh 4x1``)."""
    rows = [{
        "name": name, "route": "cuda", "source": SOURCES[name],
        "replaces": TPU_KERNELS[name], "launches": launches[name],
        "max_abs_err": main_err[name], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
    } for name, row in entries.items()]
    for row in rows:
        if row["name"] == "bsr_matmul":
            row["sharded_launches"] = sharded_launches
    return rows


def adamw_kernel_row(train_row):
    """The fused AdamW kernel's ``kernels`` row from phase 10: its launches
    in ``main``'s full-width run (the training main path), 0 for the error
    (bit-equal to its plain version), its times over one whole update."""
    opt = train_row["adamw"]
    return {"name": "adamw", "route": "cuda", "source": SOURCES["adamw"],
            "replaces": TPU_KERNELS["adamw"],
            "launches": opt["main_launches"], "max_abs_err": 0.0,
            "ms": opt["ms"], "plain_ms": opt["plain_ms"],
            "bound_ms": opt["bound_ms"], "bound_by": opt["bound_by"],
            "library_ms": opt["library_ms"]}


def phase_trace(server, args):
    """Where the serving time goes: one more drive of the main path under
    torch.profiler; device busy share = GPU activity time / wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        report = serve.drive(server, args)
        torch.cuda.synchronize()
    wall_us = 1e6 * (time.perf_counter() - t0)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = e.name[:60]
            by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    print(f"serving window (profiled): {len(report.inputs)} requests, "
          f"{report.forwards} forwards, wall {wall_us / 1e3:.3f} ms, device "
          f"busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%); top: "
          + "; ".join(f"{n} {t / 1e3:.3f} ms" for n, t in top))


# --------------------------------------------------------------------------- #
# phase 7: the serving runtime
# --------------------------------------------------------------------------- #

def run_threads(fns, timeout=WAIT_S):
    """Run each function on its own thread; a failure in any fails the
    phase, and so does a thread still running after ``timeout``."""
    errors = []

    def guard(fn):
        try:
            fn()
        except BaseException as e:      # re-raised below, on this thread
            errors.append(e)

    threads = [threading.Thread(target=guard, args=(fn,), daemon=True)
               for fn in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    check(not any(t.is_alive() for t in threads),
          f"a thread was still running after {timeout} s")
    if errors:
        raise errors[0]


def runtime_args(store, *extra):
    """``serve --sparse-ffnn --gate --batch 32`` through the plan store."""
    from repro_torch.launch import serve

    return serve.parse_args(
        ["--sparse-ffnn", "--gate", "--ffnn-sizes", *map(str, SIZES),
         "--density", str(DENSITY), "--block", str(BLOCK), "--batch",
         str(RUNTIME_B), "--reorder-iters", str(REORDER_ITERS), "--requests",
         str(RUNTIME_REQUESTS), "--plan-store", store, *extra])


def mixed_rows(rng, n, seed_shift=0):
    """Gaussian rows, each with its own set of zero input tiles, so that
    gating decisions differ from row to row."""
    x = rng.standard_normal((n, SIZES[0])).astype(np.float32)
    grid = SIZES[0] // BLOCK
    for r in range(n):
        period = 2 + (r + seed_shift) % 3
        for t in range(grid):
            if (t + r + seed_shift) % period == 0:
                x[r, t * BLOCK:(t + 1) * BLOCK] = 0.0
    return x


def submit_all(runtime, xs, n_threads=SUBMITTERS, model=None, seed=0,
               closed=True):
    """``n_threads`` submitters share the rows ``xs``; each sends bursts of
    1..RUNTIME_B rows.  ``closed``: each burst's answers are waited for
    before the next burst (the batches then come in mixed sizes, and the
    rate is bound by the scheduler's wait-or-fire policy); otherwise every
    burst is sent at once and the answers are waited for at the end (the
    queue stays full: the rate is the runtime's capacity).  Returns the
    answers (row order) and the wall time from the first submit to the
    last answer."""
    answers = [None] * len(xs)

    def client(k):
        rng = np.random.default_rng(seed + k)
        mine = list(range(k, len(xs), n_threads))
        pos, sent = 0, []
        while pos < len(mine):
            burst = mine[pos:pos + int(rng.integers(1, RUNTIME_B + 1))]
            pos += len(burst)
            for i in burst:
                if model is None:
                    sent.append((i, (runtime.submit(xs[i]),)))
                else:
                    name = model(i)
                    sent.append((i, (name, runtime.submit(name, xs[i]))))
            if closed or pos == len(mine):
                for i, key in sent:
                    check(key[-1] is not None, "a request was not admitted")
                    answers[i] = runtime.wait(*key, timeout=WAIT_S)
                sent = []

    t0 = time.perf_counter()
    run_threads([lambda k=k: client(k) for k in range(n_threads)])
    wall = time.perf_counter() - t0
    check(all(y is not None for y in answers), "a request went unanswered")
    return np.stack(answers), wall


def twin_err(plans, xs, ys):
    """Relative error of served answers against the plan's plain
    (torch-backend) version."""
    ref = plans.base.plain()(torch.from_numpy(np.asarray(xs)).cuda())
    return rel_err(torch.from_numpy(np.asarray(ys)), ref.cpu())[0]


def concurrent_gated(K, flat, rng):
    """CONC_THREADS threads launch the gated megakernel CONC_LAUNCHES times
    each on one flat schedule, each thread on its own input (batch sizes
    1..33, different dead input tiles).  Returns (outputs not bit-equal to
    the ungated kernel's, occupancies unequal to the plain version's,
    launches)."""
    from repro_torch.engine import tile_occupancy

    sizes = (1, 4, 32, 33, 7, 16, 32, 33)
    cases = []
    for t in range(CONC_THREADS):
        x = torch.from_numpy(mixed_rows(rng, sizes[t % len(sizes)],
                                        seed_shift=t)).cuda()
        occ0 = tile_occupancy(x, BLOCK, SIZES[0] // BLOCK)
        y_ungated = K.bsr_megakernel(x, flat, "gelu", "none")
        _, occ_ref = K.bsr_megakernel_plain(x, flat, "gelu", "none",
                                            gate=True, occ0=occ0)
        cases.append((x, occ0, y_ungated, occ_ref))
    torch.cuda.synchronize()
    outs = [[] for _ in range(CONC_THREADS)]
    start = threading.Barrier(CONC_THREADS)

    def work(t):
        x, occ0, _, _ = cases[t]
        start.wait(timeout=WAIT_S)
        for _ in range(CONC_LAUNCHES):
            outs[t].append(K.bsr_megakernel(x, flat, "gelu", "none",
                                            gate=True, occ0=occ0))

    run_threads([lambda t=t: work(t) for t in range(CONC_THREADS)])
    torch.cuda.synchronize()
    bad_y = bad_occ = 0
    for (x, _, y_ungated, occ_ref), got in zip(cases, outs):
        for y, occ in got:
            bad_y += not torch.equal(y, y_ungated)
            bad_occ += not torch.equal(occ.cpu(), occ_ref.cpu())
    return bad_y, bad_occ, sum(len(o) for o in outs)


def phase_plan_store(store, rng):
    """The plan set built twice through one store: cold, then a hit."""
    from repro_torch.launch import serve

    args = runtime_args(store)
    cold, _ = serve.build_server(args)
    warm, _ = serve.build_server(args)
    check(not cold.cache_hit and cold.base.annealer_iters == REORDER_ITERS,
          f"first build: hit={cold.cache_hit}, "
          f"{cold.base.annealer_iters} annealer iters")
    check(warm.cache_hit and warm.base.annealer_iters == 0,
          f"second build: hit={warm.cache_hit}, "
          f"{warm.base.annealer_iters} annealer iters")
    x = torch.from_numpy(mixed_rows(rng, RUNTIME_B)).cuda()
    check(torch.equal(cold.base(x), warm.base(x)),
          "the warm plan's outputs are not bit-equal to the cold plan's")
    print(f"plan store: cold build {cold.compile_s:.3f} s "
          f"({cold.base.annealer_iters} annealer iters), warm build "
          f"{warm.compile_s:.3f} s (plan-store hit, "
          f"{warm.base.annealer_iters} iters); outputs bit-equal on the card")
    return warm


def phase_concurrent(flat, rng):
    from repro_torch.kernels import bsr_matmul as K

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)         # switch threads as often as it can
    try:
        bad_y, bad_occ, n = concurrent_gated(K, flat, rng)
    finally:
        sys.setswitchinterval(interval)
    print(f"concurrent gated launches: {CONC_THREADS} threads x "
          f"{CONC_LAUNCHES} on one flat schedule, {n} launches; outputs not "
          f"bit-equal to the ungated kernel: {bad_y}; occupancies unequal "
          f"to the plain version's: {bad_occ}")
    check(n == CONC_THREADS * CONC_LAUNCHES and bad_y == 0 and bad_occ == 0,
          "concurrent gated launches disagree with the ungated kernel")


def phase_pipeline(store, rng):
    """``--async --workers 4``: 256 requests from 4 submitters."""
    from repro_torch.kernels import bsr_matmul as K
    from repro_torch.launch import serve

    args = runtime_args(store, "--async", "--workers", "4")
    plans, server = serve.build_server(args)
    check(plans.cache_hit, "the pipeline's plan set missed the store")
    xs = mixed_rows(rng, RUNTIME_REQUESTS)
    calls0 = sum(plans.bucket_calls.values())
    server.start()
    K.reset_launches()
    try:
        ys, wall = submit_all(server, xs)
    finally:
        check(server.shutdown(drain=True, drain_timeout_s=WAIT_S),
              "the pipeline did not shut down")
    torch.cuda.synchronize()
    launches = {"bsr_matmul": K.bsr_matmul.launches,
                "bsr_megakernel": K.bsr_megakernel.launches,
                "bsr_megakernel_gated": K.bsr_megakernel.gated_launches}
    snap = server.snapshot()
    forwards, samples = snap["batches"], snap["io"]["batches_measured"]
    print(f"pipeline --workers 4: {server.metrics.summary()}; {forwards} "
          f"forwards, {samples} dynamic-I/O samples, launches {launches}, "
          f"bucket hist {snap['bucket_hist']}, wall {wall:.3f} s")
    check(snap["served"] == RUNTIME_REQUESTS and snap["batch_failures"] == 0
          and snap["degraded_batches"] == 0 and snap["io_measure_failed"] == 0,
          f"pipeline: served {snap['served']}, failures "
          f"{snap['batch_failures']}, degraded {snap['degraded_batches']}, "
          f"failed samples {snap['io_measure_failed']}")
    check(sum(plans.bucket_calls.values()) - calls0 == forwards,
          "bucket calls differ from the batches served")
    check(launches == {"bsr_matmul": 0, "bsr_megakernel": 0,
                       "bsr_megakernel_gated": forwards + samples},
          "gated launches differ from forwards plus dynamic-I/O samples")
    check(len(snap["bucket_hist"]) > 1, "every batch had one size")
    err = twin_err(plans, xs, ys)
    check(err < TOL[torch.float32], f"pipeline answers vs plain: {err:.3e}")
    print(f"pipeline answers vs plain (torch-backend) version: error "
          f"{err:.3e}")


def phase_swap(store, rng):
    """A swap to new weights (seed 1, built off the serving path) while 4
    threads keep submitting: every answer is the old or the new plan's."""
    from repro_torch.launch import serve

    args = runtime_args(store, "--async", "--workers", "4")
    plans, server = serve.build_server(args)
    xs = mixed_rows(rng, 16)
    want_old = plans.base.plain()(torch.from_numpy(xs).cuda()).cpu()
    results, mu, stop = [], threading.Lock(), threading.Event()

    def client(k):
        r = np.random.default_rng(50 + k)
        while not stop.is_set():
            i = int(r.integers(len(xs)))
            y = server.wait(server.submit(xs[i]), timeout=WAIT_S)
            with mu:
                results.append((i, y))

    def answered():
        with mu:
            return len(results)

    def until(n):
        deadline = time.monotonic() + WAIT_S
        while answered() < n and time.monotonic() < deadline:
            time.sleep(0.001)

    new_layers = serve.make_ffnn_layers(SIZES, DENSITY, BLOCK, seed=1)
    server.start()
    clients = threading.Thread(target=run_threads, daemon=True, args=(
        [lambda k=k: client(k) for k in range(SUBMITTERS)],))
    clients.start()
    try:
        until(64)
        t0 = time.perf_counter()
        old = server.swap(new_layers)
        swap_s = time.perf_counter() - t0
        until(answered() + 64)
    finally:
        stop.set()
        clients.join(WAIT_S)
        server.shutdown(drain=True, drain_timeout_s=WAIT_S)
    check(old is plans and not clients.is_alive(), "swap: clients hung")
    new = server.plans
    want_new = new.base.plain()(torch.from_numpy(xs).cuda()).cpu()
    counts = {"old": 0, "new": 0}
    for i, y in results:
        check(y is not None, "swap: a request went unanswered")
        y = torch.from_numpy(y)
        is_old = rel_err(y, want_old[i])[0] < TOL[torch.float32]
        is_new = rel_err(y, want_new[i])[0] < TOL[torch.float32]
        check(is_old != is_new, "swap: an answer matches neither or both "
              "weight sets")
        counts["old" if is_old else "new"] += 1
    m = server.metrics.snapshot()
    print(f"swap under traffic: {len(results)} answers, {counts['old']} on "
          f"the old weights, {counts['new']} on the new; swap call "
          f"{swap_s:.3f} s, of it the build {new.compile_s:.3f} s (cold, "
          f"{new.base.annealer_iters} annealer iters); swaps {m['swaps']}")
    check(counts["old"] > 0 and counts["new"] > 0 and m["swaps"] == 1,
          "swap: the swap did not show in the answers")
    return swap_s, new.compile_s


def phase_router(store, rng):
    """``--models 2``: each answer is its own model's."""
    from repro_torch.launch import serve

    args = runtime_args(store, "--async", "--workers", "4", "--models", "2")
    router = serve.build_router(args)
    check(all(s.plans.cache_hit for s in router.servers.values()),
          "the router's plan sets missed the store")
    xs = mixed_rows(rng, 128)
    router.start()
    try:
        ys, _ = submit_all(router, xs, model=lambda i: f"m{i % 2}")
    finally:
        check(router.shutdown(drain=True, drain_timeout_s=WAIT_S),
              "the router did not shut down")
    twins = [router.servers[f"m{k}"].plans.base.plain()(
        torch.from_numpy(xs).cuda()).cpu() for k in (0, 1)]
    worst = 0.0
    for i, y in enumerate(torch.from_numpy(ys)):
        own, other = twins[i % 2][i], twins[1 - i % 2][i]
        err = rel_err(y, own)[0]
        check(err < TOL[torch.float32]
              and rel_err(y, other)[0] > TOL[torch.float32],
              f"router: request {i} for m{i % 2} crossed models")
        worst = max(worst, err)
    snap = router.snapshot()
    print(f"router --models 2: served {snap['total']['served']} "
          f"({ {n: m['served'] for n, m in snap['models'].items()} }), every "
          f"answer its own model's (worst error {worst:.3e})")


def phase_breaker(store, rng):
    """Failures injected at ``server.run_batch`` trip ``--breaker 2``;
    degraded batches run on the safe twin — one ``bsr_matmul`` launch per
    layer, no megakernel; after the cool-down the probe launches the gated
    megakernel again."""
    from repro_torch.kernels import bsr_matmul as K
    from repro_torch.launch import serve
    from repro_torch.serving import FaultInjector

    args = runtime_args(store, "--breaker", "2", "--breaker-cooldown-ms",
                        "200")
    plans, server = serve.build_server(args)
    check(plans.safe is not None, "--breaker built no safe twin")
    inj = server.injector = FaultInjector()
    inj.inject("server.run_batch", error=RuntimeError("injected fault"),
               times=2)
    xs = mixed_rows(rng, 20)
    K.reset_launches()
    for i in range(2):                      # two failed batches: trip
        rid = server.submit(xs[i])
        server.step(flush=True)
        check(server.result(rid) is None, "a failed batch answered")
    check(server.snapshot()["breaker_state"] == "open",
          "the breaker did not trip")
    rids = [server.submit(x) for x in xs[2:14]]
    server.drain()
    degraded = [server.result(r) for r in rids]
    n_degraded = server.metrics.degraded_batches
    during = (K.bsr_megakernel.gated_launches, K.bsr_megakernel.launches,
              K.bsr_matmul.launches)
    time.sleep(0.25)                        # the cool-down
    rids = [server.submit(x) for x in xs[14:]]
    server.drain()
    probe = [server.result(r) for r in rids]
    snap = server.snapshot()
    after = (K.bsr_megakernel.gated_launches - during[0],
             K.bsr_matmul.launches - during[2])
    print(f"breaker: trips {snap['breaker_trips']}, degraded batches "
          f"{snap['degraded_batches']}, resets {snap['breaker_resets']}, "
          f"state {snap['breaker_state']}; while degraded: gated/ungated "
          f"megakernel launches {during[0]}/{during[1]}, bsr_matmul "
          f"launches {during[2]}; after the cool-down: gated megakernel "
          f"launches {after[0]}, bsr_matmul launches {after[1]}")
    check(snap["breaker_trips"] == 1 and n_degraded > 0
          and during == (0, 0, (len(SIZES) - 1) * n_degraded),
          "degraded batches did not run on the twin's bsr_matmul launches")
    check(snap["breaker_state"] == "closed" and snap["breaker_resets"] == 1
          and after[0] > 0 and after[1] == 0,
          "the megakernel launches did not resume after the cool-down")
    err = twin_err(plans, xs[2:], degraded + probe)
    check(err < TOL[torch.float32], f"breaker answers vs twin: {err:.3e}")


def phase_http(store, rng):
    """POSTs through the front door, then a GET of the metrics endpoint."""
    from repro_torch.launch import serve
    from repro_torch.obs import MetricsServer
    from repro_torch.serving import HttpFrontDoor

    args = runtime_args(store, "--workers", "2", "--http-port", "0",
                        "--http-clients", "4", "--metrics-port", "0",
                        "--requests", "64")
    plans, server = serve.build_server(args)
    server.start()
    metrics = MetricsServer(server.snapshot, port=0).start()
    front = HttpFrontDoor(server, port=0).start()
    try:
        report = serve.drive_http(front, server, args)
        with urllib.request.urlopen(metrics.url, timeout=30) as resp:
            text = resp.read().decode("utf-8")
    finally:
        front.stop()
        server.shutdown(drain=True, drain_timeout_s=WAIT_S)
        metrics.stop()
    keys = sorted(report.outputs)
    err = twin_err(plans, [report.inputs[k] for k in keys],
                   [report.outputs[k] for k in keys])
    lines = text.splitlines()
    print(f"http: codes {report.http_codes} over 4 clients, answers vs "
          f"twin {err:.3e}; metrics endpoint: {len(lines)} lines, e.g. "
          + "; ".join(ln for ln in lines if ln.startswith(
              ("repro_served ", "repro_batches "))))
    check(report.http_codes == {200: 64}, "not every POST was answered")
    check(err < TOL[torch.float32], f"http answers vs twin: {err:.3e}")
    check("# TYPE repro_served gauge" in lines and "repro_served 64" in lines,
          "the metrics endpoint did not return the Prometheus text")


def rate_window(server, xs, closed, seed, min_s):
    """Chunks of the rows ``xs`` through ``submit_all``, back to back, until
    ``min_s`` seconds have passed: (requests, wall seconds, batches)."""
    b0, n, k = server.metrics.batches, 0, 0
    t0 = time.perf_counter()
    while True:
        submit_all(server, xs, seed=seed + 1000 * k, closed=closed)
        n, k = n + len(xs), k + 1
        wall = time.perf_counter() - t0
        if wall >= min_s:
            return n, wall, server.metrics.batches - b0


def phase_rates(store, rng):
    """Requests per second with 0, 1 and 4 workers, two timed windows each
    of the closed load (burst, then wait) and of the open one (every burst
    of a chunk at once), and the card's busy share of one profiled
    open-load window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve

    xs = mixed_rows(rng, RATE_CHUNK)
    rows = []
    for workers in RATE_WORKERS:
        args = runtime_args(store, "--async", "--workers", str(workers))
        _, server = serve.build_server(args)
        server.start()
        try:
            rps = {}
            for closed in (True, False):
                runs = [rate_window(server, xs, closed, s, RATE_WINDOW_S)
                        for s in (0, 1)]
                rps["closed" if closed else "open"] = {
                    "rps": [n / w for n, w, _ in runs],
                    "requests": [n for n, _, _ in runs],
                    "seconds": [w for _, w, _ in runs],
                    "batches": [b for _, _, b in runs]}
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                n_p, wall_p, batches = rate_window(server, xs, False, 2,
                                                   PROFILED_WINDOW_S)
                torch.cuda.synchronize()
        finally:
            server.shutdown(drain=True, drain_timeout_s=WAIT_S)
        busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                      if e.device_type == DeviceType.CUDA)
        row = {"workers": workers, **rps,
               "profiled_open_rps": n_p / wall_p, "profiled_requests": n_p,
               "profiled_batches": batches,
               "device_busy_ms": busy_us / 1e3,
               "busy_share": busy_us / 1e6 / wall_p}
        rows.append(row)
        print("rate: " + json.dumps(row))
    return rows


def phase_runtime():
    """Phase 7: the serving runtime on the card, through one plan store."""
    rng = np.random.default_rng(7)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="plan_store_") as store:
        warm = phase_plan_store(store, rng)
        phase_concurrent(warm.base.flat, rng)
        phase_pipeline(store, rng)
        phase_swap(store, rng)
        phase_router(store, rng)
        phase_breaker(store, rng)
        phase_http(store, rng)
        phase_rates(store, rng)
    print(f"phase 7 took {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------------- #
# phase 8: sharded plans
# --------------------------------------------------------------------------- #

def launch_counts(K):
    """(bsr_matmul launches, megakernel launches of both instances)."""
    return (K.bsr_matmul.launches,
            K.bsr_megakernel.launches + K.bsr_megakernel.gated_launches)


def shard_counters_zero(plan):
    return all(not s.arrivals.any() for p in plan.shards
               for s in p.schedules)


def sharded_engine(Engine, **kw):
    return Engine(activation="gelu", reorder=True,
                  reorder_iters=REORDER_ITERS, device="cuda", **kw)


def phase_sharded_kernels(layers, rng, Engine, Mesh, unsharded):
    """Each mesh on the kernel route against its plain version; Mesh(1, 1)
    against the unsharded plan.  Returns the plans by mesh."""
    from repro_torch.kernels import bsr_matmul as K

    x_all = torch.from_numpy(rng.standard_normal(
        (34, SIZES[0])).astype(np.float32)).cuda()
    plans, worst, n = {}, {}, 0
    for mesh in SHARD_MESHES:
        plan = sharded_engine(Engine).compile(layers, mesh=Mesh(*mesh))
        check(plan.route == "bsr_matmul-per-shard",
              f"Mesh{mesh}: route {plan.route}")
        check(all(p.flat.blocks.device.type == "cpu" for p in plan.shards),
              f"Mesh{mesh}: a shard's flat schedule is on the card")
        plain = plan.plain()
        per_fwd = mesh[0] * plan.n_layers
        for xdt in (torch.float32, torch.bfloat16):
            xx = x_all.to(xdt)
            for B in SHARD_BATCHES:
                before = launch_counts(K)
                y = plan(xx[:B])
                torch.cuda.synchronize()
                after = launch_counts(K)
                check(after[0] - before[0] == per_fwd and after[1] == before[1],
                      f"Mesh{mesh} B={B}: {after[0] - before[0]} bsr_matmul "
                      f"and {after[1] - before[1]} megakernel launches, "
                      f"expected {per_fwd} and 0")
                check(shard_counters_zero(plan),
                      f"Mesh{mesh} B={B}: arrival counters not zero")
                check(y.shape == (B, SIZES[-1]) and y.dtype == xdt
                      and bool(torch.isfinite(y).all()),
                      f"Mesh{mesh} B={B}: output not finite [{B}, 1024]")
                err, abs_err = rel_err(y, plain(xx[:B]))
                check(err < TOL[xdt], f"Mesh{mesh} x {xdt} B={B}: error "
                      f"{err:.3e} >= {TOL[xdt]}")
                worst[xdt] = max(worst.get(xdt, (0.0, 0.0)), (err, abs_err))
                n += 1
            # a batch padded to the data axis (B = 3 and 33 under data 2)
            y_full = plan(xx)
            for B in (3, 33):
                check(torch.equal(plan(xx[:B]), y_full[:B]),
                      f"Mesh{mesh} x {xdt}: rows of a {B}-row batch not "
                      "bit-equal to those of the 34-row batch")
        plans[mesh] = plan
        print(f"sharded Mesh{mesh}: {plan.describe()}")
    unit = sharded_engine(Engine).compile(layers, mesh=Mesh(1, 1))
    check(unit._forward is unit.shards[0]._forward,
          "Mesh(1, 1) does not share the unsharded forward")
    x = x_all[:MAIN_B]
    before = launch_counts(K)
    y = unit(x)
    torch.cuda.synchronize()
    after = launch_counts(K)
    check((after[0] - before[0], after[1] - before[1]) == (0, 1),
          "Mesh(1, 1) did not launch the megakernel once per forward")
    check(torch.equal(y, unsharded(x)),
          "Mesh(1, 1) is not bit-equal to the unsharded plan")
    print(f"sharded kernel route vs plain: {n} comparisons passed (meshes "
          f"{list(SHARD_MESHES)}, x f32/bf16, B in {SHARD_BATCHES}), model x "
          f"layers bsr_matmul launches and no megakernel per forward, "
          f"counters zero, padded rows bit-equal; worst relative/abs error "
          + ", ".join(f"{str(k).split('.')[-1]} {e:.3e}/{a:.3e}"
                      for k, (e, a) in worst.items())
          + "; Mesh(1, 1): one megakernel launch, bit-equal to the "
          "unsharded plan")
    return plans


def phase_sharded_serve():
    """``serve --sparse-ffnn --mesh 4x1``, step-driven: the sharded main
    path.  Returns its bsr_matmul launches."""
    from repro_torch.kernels import bsr_matmul as K
    from repro_torch.launch import serve

    args = serve.parse_args(["--sparse-ffnn", "--ffnn-sizes",
                             *map(str, SIZES), "--density", str(DENSITY),
                             "--block", str(BLOCK), "--batch", str(MAIN_B),
                             "--requests", "64", "--reorder-iters",
                             str(REORDER_ITERS), "--mesh", "4x1"])
    plans, server = serve.build_server(args)
    K.reset_launches()
    report = serve.drive(server, args)
    torch.cuda.synchronize()
    launches = {"bsr_matmul": K.bsr_matmul.launches,
                "bsr_megakernel": K.bsr_megakernel.launches,
                "bsr_megakernel_gated": K.bsr_megakernel.gated_launches}
    per_fwd = 4 * plans.base.n_layers
    print(f"main path --mesh 4x1: {server.metrics.summary()}; "
          f"{report.forwards} forwards, launches {launches}")
    check(len(report.inputs) == 64 and all(
        y is not None for y in report.outputs.values()),
          "--mesh 4x1: a request went unanswered")
    check(launches == {"bsr_matmul": per_fwd * report.forwards,
                       "bsr_megakernel": 0, "bsr_megakernel_gated": 0}
          and report.forwards > 0,
          f"--mesh 4x1: launches {launches}, expected {per_fwd} bsr_matmul "
          "per forward and no megakernel")
    rids = sorted(report.inputs)
    x = torch.from_numpy(np.stack([report.inputs[r] for r in rids])).cuda()
    y = torch.from_numpy(np.stack([report.outputs[r] for r in rids]))
    err, _ = rel_err(y, plans.base.plain()(x).cpu())
    check(y.shape == (64, SIZES[-1]) and bool(torch.isfinite(y).all())
          and err < TOL[torch.float32],
          f"--mesh 4x1 answers vs plain version: error {err:.3e}")
    print(f"main path --mesh 4x1 answers vs plain (torch-backend) version: "
          f"error {err:.3e}")
    return launches["bsr_matmul"]


def phase_sharded_runtime(rng):
    """``--mesh 4x2 --gate --async --workers 2`` through a temporary plan
    store: cold, then warm (0 annealer iterations per shard, outputs
    bit-equal), then 64 requests through the warm server."""
    from repro_torch.kernels import bsr_matmul as K
    from repro_torch.launch import serve

    with tempfile.TemporaryDirectory(prefix="plan_store_") as store:
        args = runtime_args(store, "--mesh", "4x2", "--async", "--workers",
                            "2", "--requests", "64")
        cold, _ = serve.build_server(args)
        warm, server = serve.build_server(args)
    iters = ([s.annealer_iters for s in cold.base.shards],
             [s.annealer_iters for s in warm.base.shards])
    check(not cold.cache_hit and iters[0] == [REORDER_ITERS] * 4,
          f"--mesh 4x2 first build: hit={cold.cache_hit}, iters {iters[0]}")
    check(warm.cache_hit and iters[1] == [0] * 4,
          f"--mesh 4x2 second build: hit={warm.cache_hit}, iters {iters[1]}")
    x = torch.from_numpy(mixed_rows(rng, RUNTIME_B - 1)).cuda()
    check(torch.equal(cold.base(x), warm.base(x)),
          "--mesh 4x2: the warm plan's outputs are not bit-equal to the cold")
    server.start()
    K.reset_launches()
    try:
        report = serve.drive(server, args)
    finally:
        check(server.shutdown(drain=True, drain_timeout_s=WAIT_S),
              "--mesh 4x2: the pipeline did not shut down")
    torch.cuda.synchronize()
    launches = launch_counts(K)
    snap = server.snapshot()
    print(f"--mesh 4x2 --gate --async --workers 2: plan store cold "
          f"{cold.compile_s:.3f} s ({sum(iters[0])} annealer iters over 4 "
          f"shards), warm {warm.compile_s:.3f} s (0 iters), outputs "
          f"bit-equal; {server.metrics.summary()}; {report.forwards} "
          f"forwards, bsr_matmul/megakernel launches {launches}; "
          f"{warm.base.describe()}")
    check(len(report.inputs) == 64 and all(
        y is not None for y in report.outputs.values())
          and snap["batch_failures"] == 0,
          "--mesh 4x2: a request went unanswered")
    check(launches == (8 * report.forwards, 0),
          f"--mesh 4x2: launches {launches} for {report.forwards} forwards")
    check(snap["io"]["batches_measured"] == 0
          and snap["io_measure_failed"] == 0,
          "--mesh 4x2: the dynamic-I/O sampler ran on a sharded plan")
    keys = sorted(report.inputs)
    err = twin_err(warm, [report.inputs[k] for k in keys],
                   [report.outputs[k] for k in keys])
    check(err < TOL[torch.float32], f"--mesh 4x2 answers vs plain: {err:.3e}")


def phase_sharded_times(layers, shard_plans, unsharded, Engine):
    """Device time per forward and per-call time of the sharded loop beside
    the unsharded megakernel and --no-fuse, f32 x, B = 4."""
    from repro_torch.kernels import bsr_matmul as K

    layered = Engine(activation="gelu", reorder=True,
                     reorder_iters=REORDER_ITERS, fuse=False,
                     device="cuda").compile(layers)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (MAIN_B, SIZES[0])).astype(np.float32)).cuda()
    nnz = sum(l.nnz_blocks for l in layers)
    act_bytes = 4 * (x.numel() + MAIN_B * SIZES[-1])
    b_ms, b_by = bound_ms(act_bytes + nnz * BLOCK * BLOCK * 4,
                          2 * MAIN_B * BLOCK * BLOCK * nnz)
    rows = []
    for name, plan in (("Mesh(2, 1)", shard_plans[(2, 1)]),
                       ("Mesh(4, 1)", shard_plans[(4, 1)]),
                       ("unsharded megakernel", unsharded),
                       ("--no-fuse", layered)):
        before = launch_counts(K)
        plan(x)
        torch.cuda.synchronize()
        after = launch_counts(K)
        row = {"forward": name, "bsr_matmul_launches": after[0] - before[0],
               "megakernel_launches": after[1] - before[1],
               "ms": device_ms(lambda: plan(x)),
               "call_ms": median_ms(lambda: plan(x)),
               "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        print("time: " + json.dumps(row))
    return rows


GLOO_RANK = """
import json, sys
import numpy as np, torch
import torch.distributed as dist
rank, tmp, src = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sizes, density, block, iters = json.loads(sys.argv[4])
sys.path.insert(0, src)
dist.init_process_group("gloo", store=dist.FileStore(tmp + "/store", 2),
                        rank=rank, world_size=2)
out = {"rank": rank}
try:
    probe = torch.full((4,), float(rank), device="cuda")
    parts = [torch.empty_like(probe) for _ in range(2)]
    dist.all_gather(parts, probe)
    torch.cuda.synchronize()
    out["gloo_cuda"] = [float(p[0]) for p in parts] == [0.0, 1.0]
except (RuntimeError, ValueError) as e:
    out["gloo_cuda"], out["error"] = False, str(e)[:300]
if out["gloo_cuda"]:
    from repro_torch.engine import Engine, Mesh
    from repro_torch.kernels import bsr_matmul as K
    from repro_torch.launch.serve import make_ffnn_layers
    plan = Engine(activation="gelu", reorder=True, reorder_iters=iters,
                  device="cuda").compile(make_ffnn_layers(sizes, density,
                                                          block),
                                         mesh=Mesh(2, 1))
    coll = plan.with_process_group(dist.group.WORLD)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (33, sizes[0])).astype(np.float32)).cuda()
    y_loop = plan(x)
    torch.cuda.synchronize()
    K.reset_launches()
    y = coll(x)
    torch.cuda.synchronize()
    out["launches"] = K.bsr_matmul.launches
    out["bit_equal"] = bool(torch.equal(y, y_loop))
    out["route"] = coll.route
dist.destroy_process_group()
print("RESULT " + json.dumps(out))
"""


def phase_sharded_collective():
    """Mesh(2, 1) as two processes on the one card: each launches its
    shard's bsr_matmul per layer and all-gathers through gloo; the answer
    must be bit-equal to the sequential loop's.  Returns whether this
    torch's gloo all-gathers CUDA tensors."""
    with tempfile.TemporaryDirectory(prefix="gloo_") as tmp:
        cfg = json.dumps([SIZES, DENSITY, BLOCK, REORDER_ITERS])
        procs = [subprocess.Popen(
            [sys.executable, "-c", GLOO_RANK, str(r), tmp,
             str(ROOT / "src"), cfg], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        deadline = time.monotonic() + GLOO_TIMEOUT_S
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))[0])
        except subprocess.TimeoutExpired:
            raise SmokeFailure(f"the two-process gloo run did not end "
                               f"within {GLOO_TIMEOUT_S} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    check(all(p.returncode == 0 for p in procs),
          "the two-process gloo run failed:\n" + "\n".join(logs)[-2000:])
    results = [json.loads(next(ln for ln in log.splitlines()
                               if ln.startswith("RESULT "))[7:])
               for log in logs]
    if not all(r["gloo_cuda"] for r in results):
        print("sharded collective: this torch's gloo does not all-gather "
              f"CUDA tensors ({results[0].get('error', '')}); the "
              "two-process Mesh(2, 1) run is not possible here")
        return False
    print("sharded collective Mesh(2, 1), two processes on one card: "
          + json.dumps(results))
    check(all(r["bit_equal"] and r["launches"] == len(SIZES) - 1
              for r in results),
          "the gloo collective is not bit-equal to the loop, or a rank did "
          "not launch bsr_matmul once per layer")
    return True


def phase_sharded(layers, rng, Engine, unsharded):
    """Phase 8: sharded plans on the card."""
    from repro_torch.engine import Mesh

    t0 = time.perf_counter()
    shard_plans = phase_sharded_kernels(layers, rng, Engine, Mesh, unsharded)
    launches = phase_sharded_serve()
    phase_sharded_runtime(rng)
    phase_sharded_times(layers, shard_plans, unsharded, Engine)
    phase_sharded_collective()
    print(f"phase 8 took {time.perf_counter() - t0:.1f} s")
    return launches


# --------------------------------------------------------------------------- #
# phase 9: LM serving
# --------------------------------------------------------------------------- #

def kernel_counts():
    """Every hand-written kernel's launch counter."""
    from repro_torch.kernels import bsr_matmul as K
    from repro_torch.kernels import moe_ffn as M

    return (K.bsr_matmul.launches, K.bsr_megakernel.launches,
            K.bsr_megakernel.gated_launches, M.moe_ffn.launches)


def lm_args(*extra):
    from repro_torch.launch import serve

    return serve.parse_args(list(extra))


def lm_init(cfg, device="cuda"):
    """Random f32 weights from seed 0, drawn on ``device`` (what serve_lm
    draws when given none)."""
    from repro_torch.models import encdec, lm

    mod = encdec if cfg.family == "encdec" else lm
    return mod.init(torch.Generator(device=device).manual_seed(0), cfg,
                    dtype=torch.float32)


def lm_on_cpu(params, cfg):
    """The same weights in a module on the CPU."""
    cpu = type(params)(cfg, device="cpu", dtype=torch.float32)
    cpu.load_state_dict(params.state_dict())
    return cpu.requires_grad_(False)


def logit_err(a, b):
    """max |a - b| over max |b| (b on the CPU), and the abs error."""
    a, b = a.float().cpu(), b.float().cpu()
    abs_err = float((a - b).abs().max())
    return abs_err / max(float(b.abs().max()), 1e-30), abs_err


def lm_steps(params, cfg, prompt, steps, fed=None, enc_in=None):
    """Prefill logits, then ``steps`` decode steps, each fed ``fed[i]``
    when given, else the greedy token of the step before:
    ([logits of each step], [token fed to each decode step])."""
    from repro_torch.engine import Mesh
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import encdec, lm

    dev = next(params.parameters()).device
    S = prompt.shape[1]
    prompt = prompt.to(dev)
    if cfg.family == "encdec":
        logits, enc_out = make_prefill_step(cfg)(
            params, {"src_embeds": enc_in.to(dev), "tgt_tokens": prompt})
        caches = encdec.make_dec_caches(params, cfg, enc_out, S + steps,
                                        dtype=torch.float32)
    else:
        logits, caches = lm.prefill(params, cfg, tokens=prompt)
        caches = lm.grow_caches(cfg, caches, S + steps)
    out, tokens = [logits], []
    for i in range(steps):
        tok = (fed[i] if fed is not None
               else logits.argmax(-1).to(torch.int32)[:, None]).to(dev)
        tokens.append(tok.cpu())
        if cfg.family == "encdec":
            logits, caches = encdec.decode_step(params, cfg, tok, caches)
        else:
            logits, caches = lm.decode_step(params, cfg, tok, caches,
                                            mesh=Mesh(1, 1))
        out.append(logits)
    return out, tokens


def phase_lm_reduced(arch, requests):
    """One reduced arch: serve_lm on the card, then its prefill and first
    decode step against the same weights on the CPU."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import serve

    cfg = reduced(get_config(arch))
    args = lm_args("--arch", arch, "--batch", "4", "--prompt-len",
                   str(LM_PROMPT), "--gen", str(LM_GEN), "--requests",
                   str(requests))
    params = lm_init(cfg)
    report, replays = serve_captured(cfg, args, params)
    check(len(report.sequences) == requests and all(
        len(seq) == LM_GEN for seq in report.sequences)
        and report.tokens == requests * LM_GEN,
        f"{arch}: {len(report.sequences)} sequences, {report.tokens} tokens")
    same, graph_err, bit, _ = captured_vs_eager(params, cfg, 4, LM_PROMPT,
                                                LM_GEN)
    check(same and graph_err <= LM_GRAPH_TOL,
          f"{arch}: captured vs eager decode: tokens equal {same}, logits "
          f"{graph_err:.3e} of max |logit| (tolerance {LM_GRAPH_TOL})")
    rng = np.random.default_rng(2)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (4, LM_PROMPT)))
    enc_in = torch.from_numpy((rng.standard_normal(
        (4, LM_PROMPT, cfg.d_model)) * 0.05).astype(np.float32))
    with torch.inference_mode():
        on_card, fed = lm_steps(params, cfg, prompt, 1, enc_in=enc_in)
        on_cpu, _ = lm_steps(lm_on_cpu(params, cfg), cfg, prompt, 1, fed,
                             enc_in)
    errs = [logit_err(a, b)[0] for a, b in zip(on_card, on_cpu)]
    check(max(errs) <= LM_DEVICE_TOL,
          f"{arch}: card vs CPU logits, prefill {errs[0]:.3e}, decode "
          f"{errs[1]:.3e} (tolerance {LM_DEVICE_TOL})")
    return {"card_vs_cpu": max(errs), "tok_per_s":
            report.tokens / report.seconds, "graph_replays": replays,
            "graph_vs_eager_logits": graph_err, "graph_bit_equal": bit}


def serve_captured(cfg, args, params):
    """serve_lm on the card, which must decode through its CUDA graphs: one
    replay per generated token after the first of each batch, one capture
    per batch shape.  (report, replays)."""
    from repro_torch.launch import serve
    from repro_torch.launch.steps import CapturedServeStep

    CapturedServeStep.reset_counts()
    report = serve.serve_lm(cfg, args, params=params)
    batches = -(-args.requests // args.batch)
    shapes = 1 + (args.requests % args.batch != 0 and batches > 1)
    want = batches * (args.gen - 1)
    check(CapturedServeStep.replays == want
          and CapturedServeStep.captures == shapes,
          f"{cfg.name}: serve_lm replayed {CapturedServeStep.replays} decode "
          f"graphs ({want} expected) and captured "
          f"{CapturedServeStep.captures} ({shapes} expected)")
    return report, CapturedServeStep.replays


def lm_bytes(params, cfg, B, window):
    """Bytes a decode step must read: every f32 weight (the embedding is
    the tied unembedding, or only B rows of it are gathered; at B = 4 every
    expert holds a capacity slot, so each expert's weights are read), and
    the caches it reads and writes."""
    weights = sum(p.numel() * p.element_size() for name, p in
                  params.named_parameters()
                  if name != "embed" or not cfg.tie_embeddings)
    if cfg.tie_embeddings:
        weights += params.embed.numel() * params.embed.element_size()
    else:
        weights += B * cfg.d_model * params.embed.element_size()
    if cfg.family == "ssm":
        cache = 4 * cfg.n_layers * B * (
            cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state
            + (cfg.ssm_conv - 1) * (cfg.d_inner + 2 * cfg.ssm_state))
    else:
        cache = 4 * cfg.n_layers * B * window * 2 * cfg.n_kv_heads * cfg.hd
    return weights, 2 * cache


def lm_slot_bytes(cfg, B):
    """Bytes an in-place decode step must write into its f32 caches: each
    attention layer's slot of k and v, each SSM layer's conv window and
    state."""
    attn = {"dense": cfg.n_layers, "moe": cfg.n_layers, "ssm": 0,
            "hybrid": cfg.n_layers // max(cfg.attn_period, 1)}[cfg.family]
    ssm = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    return 4 * B * (attn * 2 * cfg.n_kv_heads * cfg.hd + ssm * (
        (cfg.ssm_conv - 1) * (cfg.d_inner + 2 * cfg.ssm_state)
        + cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state))


def lm_trace(fn, runs=2, device_top=None, host_launch=None):
    """Where a step's host time goes: from one torch.profiler trace of
    ``runs`` calls, the device activities per call and the host ops with
    the most self time (ms per call); with ``device_top`` (a dict), also
    fills it with the device kernels of the most total time (ms per
    call); with ``host_launch`` (a dict), with the launch API calls per
    call, as ``host_launches`` counts them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    dev = sum(e.device_type == DeviceType.CUDA for e in events)
    top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    if device_top is not None:
        # kernels named alike up to 100 characters count as one
        per_kernel = {}
        for e in events:
            if e.device_type == DeviceType.CUDA:
                key = e.name[:100]
                per_kernel[key] = per_kernel.get(key, 0.0) \
                    + e.time_range.elapsed_us()
        for name, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]:
            device_top[name] = round(us / 1e3 / runs, 3)
    if host_launch is not None:
        host_launch.update(_launch_calls(prof, runs))
    return dev / runs, {e.key: round(e.self_cpu_time_total / 1e3 / runs, 3)
                        for e in top[:8]}


def decode_setup(params, cfg, B, prompt_len, gen, seed):
    """B seeded prompts prefilled (encdec: encoded, the decoder started from
    token 0) and their caches grown to prompt_len + gen: (caches, first
    token, the family's model module)."""
    from repro_torch.models import encdec, lm

    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab,
                                           (B, prompt_len))).cuda()
    if cfg.family == "encdec":
        enc_in = torch.from_numpy((rng.standard_normal(
            (B, prompt_len, cfg.d_model)) * 0.05).astype(np.float32)).cuda()
        enc_out = encdec.encode(params, cfg, enc_in)
        caches = encdec.make_dec_caches(params, cfg, enc_out,
                                        prompt_len + gen, dtype=torch.float32)
        return caches, torch.zeros((B, 1), dtype=torch.int32,
                                   device="cuda"), encdec
    logits, caches = lm.prefill(params, cfg, tokens=prompt)
    caches = lm.grow_caches(cfg, caches, prompt_len + gen)
    return caches, logits.argmax(-1).to(torch.int32)[:, None], lm


def captured_vs_eager(params, cfg, B, prompt_len, gen, seed=3):
    """gen - 1 greedy decode steps from the same prefilled caches, eagerly
    (the functional step that make_serve_step runs) and through a
    CapturedServeStep: (tokens equal at every step, the worst step's
    max |logit difference| over max |eager logit|, logits bit-equal, the
    capture's seconds)."""
    from repro_torch.engine import Mesh
    from repro_torch.launch.steps import CapturedServeStep

    with torch.inference_mode():
        caches, cur, mod = decode_setup(params, cfg, B, prompt_len, gen,
                                        seed)
        eager_tok, eager_log, c, x = [], [], caches, cur
        for _ in range(gen - 1):
            lg, c = mod.decode_step(params, cfg, x, c, mesh=Mesh(1, 1))
            x = torch.argmax(lg, dim=-1).to(torch.int32)[:, None]
            eager_tok.append(x)
            eager_log.append(lg)
        del c
        cap = CapturedServeStep(cfg, params, Mesh(1, 1))
        toks = cap(caches, cur, gen - 1, keep_logits=True)
        same = all(torch.equal(a, b) for a, b in zip(toks, eager_tok))
        err = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                    1e-30)
                  for a, b in zip(cap.step_logits, eager_log))
        bit = all(torch.equal(a, b) for a, b in zip(cap.step_logits,
                                                    eager_log))
    return same, err, bit, cap.capture_s[0]


class CacheWrites(TorchDispatchMode):
    """Over one eager decode step: bytes it writes into its caches' storage
    in place (``index_copy_``, ``copy_``), bytes of out-of-place copies of
    a cache leaf (``index_copy``: a whole window each), and bytes of
    contiguous copies read from a cache."""

    def __init__(self, caches):
        super().__init__()
        self.storages = {t.untyped_storage().data_ptr()
                         for t in _cache_leaves(caches)}
        self.write = self.window_copies = self.layout_copies = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        first = args[0] if args else None
        if not (isinstance(first, torch.Tensor)
                and first.untyped_storage().data_ptr() in self.storages):
            return out
        if name in ("index_copy_", "copy_"):
            src = args[3] if name == "index_copy_" else first
            self.write += src.numel() * first.element_size()
        elif name == "index_copy":
            self.window_copies += out.numel() * out.element_size()
        elif name in ("clone", "_to_copy"):
            self.layout_copies += out.numel() * out.element_size()
        return out


def _cache_leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _cache_leaves(v)]
    return [] if tree is None else [tree]


def step_copies(params, cfg, caches, cur):
    """CacheWrites of one in-place step (what the graph replays) and of one
    functional step (what the eager serve step runs), on copies of
    ``caches``."""
    from repro_torch.engine import Mesh
    from repro_torch.models import encdec, lm

    mod = encdec if cfg.family == "encdec" else lm
    out = {}
    with torch.inference_mode():
        for name, fn in (("in_place", mod.decode_step_),
                         ("functional", mod.decode_step)):
            copy = {k: (None if v is None else {kk: vv.clone() for kk, vv
                                                in v.items()})
                    for k, v in caches.items()}
            with CacheWrites(copy) as cw:
                fn(params, cfg, cur, copy, mesh=Mesh(1, 1))
            out[name] = {"cache_write_bytes": cw.write,
                         "window_copy_bytes": cw.window_copies,
                         "layout_copy_bytes": cw.layout_copies}
            del copy
    return out


def host_launches(fn, runs=3):
    """Launch API calls (kernels, graphs, copies, memsets) the host makes
    per call of ``fn``, from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    names = _launch_calls(prof, runs)
    return sum(names.values()), names


def _launch_calls(prof, runs):
    """The launch API calls (kernels, graphs, copies, memsets) of a trace,
    per call."""
    return {e.key: e.count / runs for e in prof.key_averages()
            if e.key.startswith(("cudaLaunch", "cuLaunch", "cudaGraphLaunch",
                                 "cudaMemcpy", "cudaMemset"))}


def phase_lm_full(arch):
    """One model at full width, in f32: serving at the reference's
    defaults, the reference's consistency test, a CPU cross-check, and the
    figures of a decode step."""
    from repro_torch.configs import get_config
    from repro_torch.engine import Mesh
    from repro_torch.launch import serve
    from repro_torch.launch.steps import CapturedServeStep, make_serve_step
    from repro_torch.models import lm

    cfg = get_config(arch)
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = lm_init(cfg)
    n = sum(p.numel() for p in params.parameters())
    torch.cuda.synchronize()
    print(f"{arch}: {n} parameters ({4 * n} B in f32; cfg.n_params() "
          f"{cfg.n_params()}), drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    args = lm_args("--arch", arch)
    report, replays = serve_captured(cfg, args, params)
    check(len(report.sequences) == args.requests and all(
        len(seq) == args.gen for seq in report.sequences),
        f"{arch}: {len(report.sequences)} sequences served")
    rng = np.random.default_rng(1)
    with torch.inference_mode():
        # the reference's consistency test (tests/test_models.py:60-90)
        ccfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts)) \
            if cfg.family == "moe" else cfg
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32))).cuda()
        W = lm.unembed_matrix(params)
        full = lm.forward(params, ccfg, tokens=toks)[0][:, -1] @ W
        logits, caches = lm.prefill(params, ccfg, tokens=toks)
        e_pre = float((logits - full).abs().max())
        nxt = logits.argmax(-1)[:, None]
        caches = lm.grow_caches(ccfg, caches, 36)
        logits, _ = lm.decode_step(params, ccfg, nxt, caches, mesh=Mesh(1, 1))
        full = lm.forward(params, ccfg, tokens=torch.cat([toks, nxt], 1))[0][
            :, -1] @ W
        e_dec = float((logits - full).abs().max())
        tol = LM_CONSISTENCY_TOL
        check(bool(torch.allclose(logits, full, rtol=tol, atol=tol))
              and e_pre <= tol * (1 + float(full.abs().max())),
              f"{arch}: prefill/decode vs full forward: {e_pre:.3e}, "
              f"{e_dec:.3e} (tolerance {tol})")
        del caches, full, logits
        # the same weights on the CPU: B = 1, 8 prompt tokens, 2 greedy
        # decode steps on the card, the CPU fed the card's tokens
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 8)))
        card_logits, fed = lm_steps(params, cfg, prompt, LM_CPU_STEPS)
        cpu_logits, _ = lm_steps(lm_on_cpu(params, cfg), cfg, prompt,
                                 LM_CPU_STEPS, fed)
    worst, margin = 0.0, float("inf")
    for i, (a, b) in enumerate(zip(card_logits, cpu_logits)):
        err, abs_err = logit_err(a, b)
        check(err <= LM_FULL_TOL, f"{arch}: card vs CPU logits at step {i}: "
              f"{err:.3e} (tolerance {LM_FULL_TOL})")
        worst = max(worst, err)
        top2 = b.float().cpu().topk(2, dim=-1).values[0]
        gap = float(top2[0] - top2[1])
        margin = min(margin, gap)
        if gap > abs_err:
            check(int(a.argmax()) == int(b.argmax()),
                  f"{arch}: greedy token differs at step {i} (margin "
                  f"{gap:.3e} > error {abs_err:.3e})")
    peak = torch.cuda.max_memory_allocated()
    # figures of one decode step at the serving batch (B = 4, window
    # prompt + gen)
    B, window = args.batch, args.prompt_len + args.gen
    serve_step = make_serve_step(cfg, Mesh(1, 1))
    with torch.inference_mode():
        prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (B, args.prompt_len)))
        prompts = prompts.cuda()

        def prefill():
            return lm.prefill(params, cfg, tokens=prompts)

        pre_ms = median_ms(prefill, runs=5, warm=2)
        logits, caches = prefill()
        caches = lm.grow_caches(cfg, caches, window)
        cur = logits.argmax(-1).to(torch.int32)[:, None]

        def step():
            return serve_step(params, caches, cur)

        dev_ms = device_ms(step, runs=LM_PROFILED_STEPS, warm=2)
        call_ms = median_ms(step, runs=LM_TIMED_STEPS, warm=3)
        launches, host_top = lm_trace(step)
        eager_host, _ = host_launches(step)
        copies = step_copies(params, cfg, caches, cur)
        # the same step as one graph replay (and the token's copy out)
        cap = CapturedServeStep(cfg, params, Mesh(1, 1))
        cap(caches, cur, 1)
        g = next(iter(cap.graphs.values()))

        def replay():
            g.graph.replay()
            return g.tokens.clone()

        g_dev_ms = device_ms(replay, runs=LM_PROFILED_STEPS, warm=2)
        g_call_ms = median_ms(replay, runs=LM_TIMED_STEPS, warm=3)
        g_launches, _ = lm_trace(replay)
        g_host, g_host_names = host_launches(replay)
    same, graph_err, bit, capture_s = captured_vs_eager(
        params, cfg, B, args.prompt_len, args.gen)
    check(same and graph_err <= LM_GRAPH_TOL,
          f"{arch}: captured vs eager decode: tokens equal {same}, logits "
          f"{graph_err:.3e} of max |logit| (tolerance {LM_GRAPH_TOL})")
    slot_bytes = lm_slot_bytes(cfg, B)
    check(copies["in_place"]["window_copy_bytes"] == 0
          and copies["in_place"]["cache_write_bytes"] == slot_bytes,
          f"{arch}: the in-place step copied {copies['in_place']} bytes of "
          f"its caches ({slot_bytes} written expected: its slots, or the "
          f"SSM state)")
    w_bytes, c_bytes = lm_bytes(params, cfg, B, window)
    b_ms = 1e3 * w_bytes / hbm_bps()
    row = {"arch": arch, "params": n, "peak_bytes": peak,
           "prefill_ms": pre_ms, "decode_device_ms": dev_ms,
           "decode_call_ms": call_ms,
           "tok_per_s": report.tokens / report.seconds,
           "decode_tok_per_s": B / call_ms * 1e3,
           "bound_ms": b_ms, "weight_bytes": w_bytes, "cache_bytes": c_bytes,
           "bound_with_cache_ms": 1e3 * (w_bytes + c_bytes) / hbm_bps(),
           "device_launches_per_step": launches,
           "host_top_ms_per_step": host_top,
           "card_vs_cpu_worst": worst, "smallest_top2_margin": margin,
           "consistency_err": [e_pre, e_dec],
           "graph": {"serve_replays": replays, "capture_s": capture_s,
                     "device_ms": g_dev_ms, "call_ms": g_call_ms,
                     "device_launches_per_step": g_launches,
                     "host_launches_per_token": g_host,
                     "host_launch_calls": g_host_names,
                     "tokens_equal_eager": same,
                     "logits_vs_eager": graph_err,
                     "logits_bit_equal": bit},
           "eager_host_launches_per_token": eager_host,
           "cache_bytes_per_step": copies}
    print("lm: " + json.dumps(row))
    del params, caches, serve_step, cap, g
    torch.cuda.empty_cache()
    return row


def phase_lm():
    """Phase 9: every architecture reduced through serve_lm on the card and
    against the CPU, then mamba2-1.3b and granite-moe-1b-a400m at full
    width; no hand-written kernel may launch."""
    from repro_torch.configs import ARCH_IDS

    t0 = time.perf_counter()
    before = kernel_counts()
    for arch in ARCH_IDS:
        r = phase_lm_reduced(arch, LM_REDUCED_REQUESTS)
        print(f"lm reduced {arch}: card vs CPU logits {r['card_vs_cpu']:.3e}"
              f" (tolerance {LM_DEVICE_TOL}), {r['tok_per_s']:.1f} tok/s, "
              f"{r['graph_replays']} graph replays, captured vs eager logits "
              f"{r['graph_vs_eager_logits']:.3e} (bit-equal "
              f"{r['graph_bit_equal']})")
    rows = [phase_lm_full(arch) for arch in LM_FULL]
    check(kernel_counts() == before,
          f"a hand-written kernel launched during LM serving: "
          f"{before} -> {kernel_counts()}")
    print(f"phase 9 took {time.perf_counter() - t0:.1f} s; no hand-written "
          f"kernel launched")
    return rows


# --------------------------------------------------------------------------- #
# phase 10: training
# --------------------------------------------------------------------------- #

@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` for the block (the
    scatter-adds of the MoE combine and the embedding's backward then sort
    instead of using atomics)."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def train_batch(cfg, seed=0, b=4, s=20):
    """Seeded numpy inputs in the family's batch layout (f32 embeddings)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    t = torch.from_numpy
    if cfg.family == "encdec":
        return {"src_embeds": t((rng.standard_normal((b, s, cfg.d_model))
                                 * 0.05).astype(np.float32)),
                "tgt_tokens": t(toks[:, :s // 2]),
                "labels": t(toks[:, 1:s // 2 + 1])}
    if cfg.modality == "vision_stub":
        return {"embeds": t((rng.standard_normal((b, s, cfg.d_model))
                             * 0.05).astype(np.float32)),
                "labels": t(toks[:, 1:])}
    return {"tokens": t(toks[:, :-1]), "labels": t(toks[:, 1:])}


def to_device(batch, device):
    return {k: v.to(device) for k, v in batch.items()}


def loss_and_grads(params, cfg, batch, mesh=None):
    """(loss, gradient of every parameter; zeros where it is unused)."""
    from repro_torch.models import encdec, lm

    mod = encdec if cfg.family == "encdec" else lm
    plist = list(params.parameters())
    loss, _ = mod.loss_fn(params, cfg, batch, mesh)
    grads = torch.autograd.grad(loss, plist, allow_unused=True)
    return float(loss.detach()), [torch.zeros_like(p) if g is None else g
                                  for g, p in zip(grads, plist)]


def master_bound_err(card, cpu, lr, opt_cfg):
    """max over elements of |card - cpu| minus its bound after one AdamW
    step: 1e-2 * lr, plus ``lr * |dg| / eps`` (how far ``g / (|g| + eps)``
    moves when a near-zero gradient moves by dg; dg from the two mu's)."""
    worst = -float("inf")
    for name, m in card["master"].items():
        dg = (card["mu"][name].cpu() - cpu["mu"][name]).abs() / (1 - opt_cfg.b1)
        bound = 1e-2 * lr + lr * dg / opt_cfg.eps
        err = (m.cpu() - cpu["master"][name]).abs()
        worst = max(worst, float((err - bound).max()))
    return worst


def phase_train_reduced(arch):
    """One reduced arch, f32, remat on: one train step on the card (the
    captured step's first call: its eager warm-up step) against
    make_train_step on the CPU, and remat on against off on the card."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.engine import Mesh
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import OptConfig, adamw_init

    cfg = dataclasses.replace(reduced(get_config(arch)), remat=True)
    opt_cfg = OptConfig(**TRAIN_OPT)
    params, opt, step = train.build(cfg, Mesh(1, 1), opt_cfg,
                                    dtype=torch.float32, device="cuda")
    cpu_step = make_train_step(cfg, opt_cfg, Mesh(1, 1))
    cpu = lm_on_cpu(params, cfg).requires_grad_(True)
    cpu_opt = adamw_init(cpu)
    batch = train_batch(cfg)
    # remat on against off, on the card, before the step moves the weights
    on_loss, on_g = loss_and_grads(params, cfg, to_device(batch, "cuda"))
    off_loss, off_g = loss_and_grads(params, dataclasses.replace(
        cfg, remat=False), to_device(batch, "cuda"))
    remat_diff = max([abs(on_loss - off_loss)] + [
        float((a - b).abs().max()) for a, b in zip(on_g, off_g)])
    _, opt, m_card = step(params, opt, to_device(batch, "cuda"))
    _, cpu_opt, m_cpu = cpu_step(cpu, cpu_opt, batch)
    loss_err = abs(float(m_card["loss"]) - float(m_cpu["loss"])) / abs(
        float(m_cpu["loss"]))
    gnorm_err = abs(float(m_card["grad_norm"]) - float(m_cpu["grad_norm"])) \
        / float(m_cpu["grad_norm"])
    over = master_bound_err(opt, cpu_opt, float(m_cpu["lr"]), opt_cfg)
    check(loss_err <= TRAIN_LOSS_TOL and gnorm_err <= TRAIN_GNORM_TOL
          and over <= 0.0,
          f"{arch}: card vs CPU train step: loss {loss_err:.3e}, grad_norm "
          f"{gnorm_err:.3e}, master over its bound by {over:.3e}")
    return {"arch": arch, "loss_rel_err": loss_err, "gnorm_rel_err": gnorm_err,
            "master_over_bound": over, "remat_on_vs_off_max_abs": remat_diff}


def phase_train_graph(arch):
    """One reduced arch, f32, remat on, under deterministic algorithms:
    TRAIN_GRAPH_STEPS calls of ``train.build``'s captured step (one eager
    warm-up step, the capture, then replays) against as many eager steps
    from the same weights and batches.  Bit-equal (metrics and the whole
    state) where no atomics sum; for the MoE, whose combine scatter-adds,
    the loss within TRAIN_LOSS_TOL and ``grad_norm`` within
    TRAIN_GNORM_TOL."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.engine import Mesh
    from repro_torch.launch import train
    from repro_torch.launch.steps import CapturedTrainStep, make_train_step
    from repro_torch.optim import OptConfig

    cfg = dataclasses.replace(reduced(get_config(arch)), remat=True)
    opt_cfg = OptConfig(**TRAIN_OPT)
    replays = CapturedTrainStep.replays
    diffs = {"loss": [], "grad_norm": []}
    with deterministic():
        p, o, cap = train.build(cfg, Mesh(1, 1), opt_cfg,
                                dtype=torch.float32, device="cuda")
        q, qo, _ = train.build(cfg, Mesh(1, 1), opt_cfg,
                               dtype=torch.float32, device="cuda")
        eager = make_train_step(cfg, opt_cfg, Mesh(1, 1))
        check(isinstance(cap, CapturedTrainStep),
              f"{arch}: train.build on the card gave {type(cap).__name__}, "
              f"not a CapturedTrainStep")
        for i in range(TRAIN_GRAPH_STEPS):
            batch = to_device(train_batch(cfg, seed=10 + i), "cuda")
            _, _, m = cap(p, o, batch)
            _, qo, em = eager(q, qo, batch)
            for k in diffs:
                diffs[k].append(abs(float(m[k]) - float(em[k]))
                                / abs(float(em[k])))
        torch.cuda.synchronize()
    replays = CapturedTrainStep.replays - replays
    bit = same_state(p, o, q, qo) and not any(map(any, diffs.values()))
    check(replays == TRAIN_GRAPH_STEPS - 1 and len(cap.capture_s) == 1,
          f"{arch}: {replays} replays and {len(cap.capture_s)} captures in "
          f"{TRAIN_GRAPH_STEPS} calls (expected {TRAIN_GRAPH_STEPS - 1}, 1)")
    if cfg.family == "moe":
        check(max(diffs["loss"]) <= TRAIN_LOSS_TOL
              and max(diffs["grad_norm"]) <= TRAIN_GNORM_TOL,
              f"{arch}: captured vs eager train step: {diffs}")
    else:
        check(bit, f"{arch}: the captured train step is not bit-equal to "
              f"the eager one: {diffs}")
    capture_s = cap.capture_s[0]
    del p, o, q, qo, cap
    torch.cuda.empty_cache()
    return {"steps": TRAIN_GRAPH_STEPS, "replays": replays,
            "capture_s": capture_s, "bit_equal": bit,
            "loss_rel_diff": diffs["loss"],
            "gnorm_rel_diff": diffs["grad_norm"]}


def same_state(a_params, a_opt, b_params, b_opt):
    """Every parameter and optimizer-state tensor bit-equal."""
    if not all(torch.equal(x, y) for x, y in
               zip(a_params.parameters(), b_params.parameters())):
        return False
    if not torch.equal(a_opt["step"], b_opt["step"]):
        return False
    return all(torch.equal(a_opt[k][n], b_opt[k][n])
               for k in ("master", "mu", "nu") for n in a_opt[k])


def phase_train_entry_reduced():
    """The entry point reduced, with a fault at step 6 and without, under
    deterministic algorithms: bit-equal final states, and the checkpoint
    restored into a fresh model and state bit for bit."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.engine import Mesh
    from repro_torch.launch import train
    from repro_torch.optim import OptConfig

    args = ["--arch", TRAIN_FULL, "--reduced", "--steps", "12",
            "--ckpt-every", "4"]
    with tempfile.TemporaryDirectory() as d, deterministic():
        run = train.main(args + ["--inject-fault-at", "6",
                                 "--ckpt-dir", os.path.join(d, "a")])
        clean = train.main(args + ["--ckpt-dir", os.path.join(d, "b")])
        losses = run.summary["losses"]
        check(run.summary["restarts"] == 1 and clean.summary["restarts"] == 0,
              f"restarts {run.summary['restarts']}, "
              f"{clean.summary['restarts']} (expected 1, 0)")
        check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
              f"reduced entry point losses {losses}")
        for r in (run, clean):
            g, calls = r.summary["rank"]["graph"], len(r.summary["rank"][
                "step_s"])
            check(g["captures"] == 1 and g["replays"] == calls - 1,
                  f"the reduced entry point captured {g['captures']} graphs "
                  f"and replayed {g['replays']} in {calls} steps (expected "
                  f"1 and {calls - 1})")
        tr, ctr = run.trainer, clean.trainer
        check(same_state(tr.params, tr.opt_state, ctr.params, ctr.opt_state),
              "the run with a fault and the clean run ended in different "
              "states under deterministic algorithms")
        fresh_p, fresh_o, _ = train.build(run.cfg, Mesh(1, 1), OptConfig(),
                                          seed=3, device="cuda")
        CheckpointManager(os.path.join(d, "a")).restore(
            {"params": fresh_p, "opt": fresh_o})
        check(same_state(fresh_p, fresh_o, tr.params, tr.opt_state),
              "the reduced run's checkpoint did not restore bit for bit")
    return losses, run.summary["rank"]["graph"]


def train_bound(params, cfg, B, S):
    """The least time a training step could take (ms, "bytes" or
    "operations"), and its bytes and FLOPs.

    Bytes: the forward, the remat's recompute and the backward each read
    the weights, the update writes them; the f32 gradients are written and
    read; master, mu and nu are read and written in f32.  Activations are
    left out (about 0.1 % here).  FLOPs: the blocks' products run three
    times forward (forward, remat, the backward's two products count
    double) = 4x, the unembedding 3x; a token's experts are its top-k
    choices (as if no capacity slot dropped one); attention is causal."""
    N = sum(p.numel() for p in params.parameters())
    W = sum(p.numel() * p.element_size() for p in params.parameters())
    n_bytes = 4 * W + 8 * N + 24 * N
    d, hd = cfg.d_model, cfg.hd
    attn = 2 * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd \
        + 2 * cfg.n_heads * hd * d + 2 * 2 * cfg.n_heads * hd * (S + 1) / 2
    mult = 3 if cfg.activation == "swiglu" else 2
    ffn = (cfg.top_k + cfg.n_shared_experts) * mult * 2 * d * cfg.d_ff \
        + 2 * d * cfg.n_experts if cfg.family == "moe" \
        else mult * 2 * d * cfg.d_ff
    per_token = 4 * cfg.n_layers * (attn + ffn) + 3 * 2 * d * cfg.vocab
    flops = B * S * per_token
    ms, by = bound_ms(n_bytes, flops, bf16_ops())
    return ms, by, n_bytes, flops


def adamw_groups(params):
    """The optimizer's groups of leaves (names) for a module's
    parameters."""
    from repro_torch.optim import adamw as O

    names = [n for n, _ in params.named_parameters()]
    return [[names[i] for i in g] for g in O._groups(
        [p.numel() for _, p in params.named_parameters()])]


def phase_adamw(params, opt_state, cfg):
    """The fused AdamW kernel on TRAIN_FULL's full-width state: bit-equal
    to its plain version for one update of every group, with the model's
    parameter dtypes (bf16, and f32 where the model keeps it) and with
    every parameter f32; then the update's times over every group: the
    kernel, the plain version and ``torch._fused_adamw_`` (PyTorch's own
    fused AdamW on the same f32 master, mu and nu; a yardstick, never
    called by the port) beside the bytes bound.  Seeded gradients of
    1e-3 scale stand in for a step's."""
    from repro_torch.kernels import adamw as A
    from repro_torch.optim import OptConfig
    from repro_torch.optim import adamw as O

    t0 = time.perf_counter()
    opt_cfg = OptConfig(warmup_steps=10, total_steps=TRAIN_FULL_STEPS)
    named = dict(params.named_parameters())
    gen = torch.Generator(device="cuda").manual_seed(7)
    grads = {n: torch.randn(p.shape, generator=gen, device="cuda") * 1e-3
             for n, p in named.items()}
    step = opt_state["step"]
    lr = O.schedule(step, opt_cfg)
    gnorm = O.global_norm(grads)
    scale = torch.clamp(opt_cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    t = (step + 1).to(torch.float32)
    bc1, bc2 = 1 - opt_cfg.b1 ** t, 1 - opt_cfg.b2 ** t
    hp = dict(b1=opt_cfg.b1, b2=opt_cfg.b2, eps=opt_cfg.eps,
              weight_decay=opt_cfg.weight_decay)
    groups = adamw_groups(params)

    def args(gn, state, dtypes):
        return ([grads[n] for n in gn], [state["master"][n] for n in gn],
                [state["mu"][n] for n in gn], [state["nu"][n] for n in gn],
                dtypes, scale, lr, bc1, bc2)

    worst = {}
    for kind in ("model", "f32"):
        same = True
        for gn in groups:
            dts = [named[n].dtype if kind == "model" else torch.float32
                   for n in gn]
            a = {k: {n: opt_state[k][n].clone() for n in gn}
                 for k in ("master", "mu", "nu")}
            b = {k: {n: opt_state[k][n].clone() for n in gn}
                 for k in ("master", "mu", "nu")}
            before = A.adamw_fused.launches
            out_a = A.adamw_fused(*args(gn, a, dts), **hp)
            out_b = A.adamw_plain(*args(gn, b, dts), **hp)
            torch.cuda.synchronize()
            check(A.adamw_fused.launches == before + 1,
                  "the fused AdamW wrapper did not launch its kernel")
            same &= all(torch.equal(x, y) for x, y in zip(out_a, out_b))
            same &= all(torch.equal(a[k][n], b[k][n]) for k in a for n in gn)
            del a, b, out_a, out_b
        worst[kind] = same
    check(all(worst.values()), f"the fused AdamW kernel is not bit-equal to "
          f"its plain version: {worst}")
    dtypes = {n: p.dtype for n, p in named.items()}

    def kernel():
        for gn in groups:
            A.adamw_fused(*args(gn, opt_state, [dtypes[n] for n in gn]), **hp)

    def plain():
        for gn in groups:
            A.adamw_plain(*args(gn, opt_state, [dtypes[n] for n in gn]), **hp)

    names = list(named)
    # its bias correction reads each leaf's step count (>= 1)
    steps = [(step + 1).float() for _ in names]
    lr_f = float(lr)

    def library():
        torch._fused_adamw_(
            [opt_state["master"][n] for n in names],
            [grads[n] for n in names], [opt_state["mu"][n] for n in names],
            [opt_state["nu"][n] for n in names], [], steps, lr=lr_f,
            beta1=opt_cfg.b1, beta2=opt_cfg.b2,
            weight_decay=opt_cfg.weight_decay, eps=opt_cfg.eps,
            amsgrad=False, maximize=False)

    n_el = sum(p.numel() for p in named.values())
    out_bytes = sum(p.numel() * p.element_size() for p in named.values())
    n_bytes = 16 * n_el + 12 * n_el + out_bytes
    b_ms, b_by = bound_ms(n_bytes, 20 * n_el)
    k_dev = device_ms(kernel, runs=3, warm=1)
    k_call = median_ms(kernel, runs=3, warm=1)
    p_dev = device_ms(plain, runs=2, warm=1)
    p_call = median_ms(plain, runs=2, warm=1)
    l_dev = device_ms(library, runs=3, warm=1)
    l_call = median_ms(library, runs=3, warm=1)
    row = {"groups": len(groups), "leaves": len(names), "elements": n_el,
           "bit_equal_plain": worst, "ms": k_dev if k_dev is not None
           else k_call, "call_ms": k_call,
           "plain_ms": p_dev if p_dev is not None else p_call,
           "plain_call_ms": p_call,
           "library_ms": l_dev if l_dev is not None else l_call,
           "library_call_ms": l_call, "bound_ms": b_ms, "bound_by": b_by,
           "bound_bytes": n_bytes, "launches_per_step": len(groups),
           "timing": "profiler" if k_dev is not None else "events",
           "seconds": time.perf_counter() - t0}
    print("adamw: " + json.dumps(row))
    del grads, steps
    torch.cuda.empty_cache()
    return row


def phase_train_full():
    """TRAIN_FULL at full width through ``main`` at its defaults, which
    runs one eager warm-up step, captures the step and replays the graph
    in every later step; the final checkpoint restored; a card vs CPU
    check in f32 at B = 1; the figures of one step, the graph's (a replay
    through main's step) under ``graph`` and, timed in the same call, the
    eager ``make_train_step``'s on the same state (the row's own step
    figures and ``peak_bytes``, which phase 12's dry run models)."""
    from repro_torch.checkpoint import load_checkpoint, store
    from repro_torch.configs import get_config
    from repro_torch.engine import Mesh
    from repro_torch.kernels import adamw as A
    from repro_torch.launch import train
    from repro_torch.launch.steps import CapturedTrainStep, make_train_step
    from repro_torch.optim import OptConfig
    from repro_torch.optim.adamw import global_norm

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    saves, peaks = [], {}
    save_checkpoint = store.save_checkpoint
    capture = CapturedTrainStep._capture

    def timed_save(*a, **kw):
        t0 = time.perf_counter()
        path = save_checkpoint(*a, **kw)
        saves.append(time.perf_counter() - t0)
        return path

    def measured_capture(self, *a):
        # the warm-up step's peak, then the capture's alone
        peaks["warmup"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        capture(self, *a)
        peaks["capture"] = torch.cuda.max_memory_allocated()

    store.save_checkpoint = timed_save
    CapturedTrainStep._capture = measured_capture
    try:
        with tempfile.TemporaryDirectory() as d:
            # the main path of the fused optimizer: its count from 0
            A.adamw_fused.launches = 0
            run = train.main(["--arch", TRAIN_FULL, "--steps",
                              str(TRAIN_FULL_STEPS), "--ckpt-dir", d])
            main_launches = A.adamw_fused.launches
            peak = max(peaks["warmup"], torch.cuda.max_memory_allocated())
            graph = run.summary["rank"]["graph"]
            cfg, tr, losses = run.cfg, run.trainer, run.summary["losses"]
            restarts = run.summary["restarts"]
            run_s = time.perf_counter() - t_start
            ln_v = math.log(cfg.vocab)
            check(len(losses) == TRAIN_FULL_STEPS and all(
                math.isfinite(x) for x in losses) and losses[-1] < losses[0]
                and abs(losses[0] - ln_v) < 1.5,
                f"{TRAIN_FULL}: losses {losses} (first near ln V = {ln_v:.3f})")
            step_dir = os.path.join(d, f"step_{TRAIN_FULL_STEPS:08d}")
            ckpt_bytes = sum(f.stat().st_size for f in Path(step_dir).iterdir())
            disk = shutil.disk_usage(d)
            fresh_p, fresh_o, _ = train.build(cfg, Mesh(1, 1), OptConfig(),
                                              seed=1, device="cuda")
            t0 = time.perf_counter()
            load_checkpoint(d, {"params": fresh_p, "opt": fresh_o})
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            check(same_state(fresh_p, fresh_o, tr.params, tr.opt_state),
                  f"{TRAIN_FULL}: the final checkpoint did not restore bit "
                  f"for bit")
            del fresh_p, fresh_o
    finally:
        store.save_checkpoint = save_checkpoint
        CapturedTrainStep._capture = capture
    check(graph["captures"] == 1
          and graph["replays"] == TRAIN_FULL_STEPS - 1,
          f"{TRAIN_FULL}: main captured {graph['captures']} graphs and "
          f"replayed {graph['replays']} in {TRAIN_FULL_STEPS} steps "
          f"(expected 1 and {TRAIN_FULL_STEPS - 1})")
    t_figures = time.perf_counter()
    # the figures of one step, at main's batch (each call trains on)
    B, S = 8, 128
    batch = train.make_batches(cfg, B, S, "cuda")(0)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()

    def step():
        return tr.train_step(tr.params, tr.opt_state, batch)

    n_groups = len(adamw_groups(tr.params))
    check(main_launches == TRAIN_FULL_STEPS * n_groups,
          f"{TRAIN_FULL}: main launched the fused AdamW kernel "
          f"{main_launches} times ({TRAIN_FULL_STEPS} steps x {n_groups} "
          f"groups expected)")
    before = (A.adamw_fused.launches, CapturedTrainStep.replays)
    step()
    torch.cuda.synchronize()
    check(A.adamw_fused.launches - before[0] == n_groups
          and CapturedTrainStep.replays - before[1] == 1,
          f"train_step launched the fused AdamW kernel "
          f"{A.adamw_fused.launches - before[0]} times ({n_groups} groups) "
          f"in {CapturedTrainStep.replays - before[1]} replays (1)")
    g_dev_ms = device_ms(step, runs=TRAIN_GRAPH_PROFILED_STEPS, warm=1)
    g_call_ms = median_ms(step, runs=TRAIN_TIMED_STEPS, warm=1)
    g_host = {}
    g_launches, g_host_top = lm_trace(step, host_launch=g_host)
    # the eager step on the same state, as main ran it before the graph
    opt_cfg = OptConfig(lr=3e-4, warmup_steps=10,
                        total_steps=TRAIN_FULL_STEPS)
    eager = train._timed(make_train_step(cfg, opt_cfg, Mesh(1, 1)), [])

    def eager_step():
        return eager(tr.params, tr.opt_state, batch)

    torch.cuda.reset_peak_memory_stats()
    eager_step()
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated()
    dev_ms = device_ms(eager_step, runs=TRAIN_PROFILED_STEPS, warm=1)
    call_ms = median_ms(eager_step, runs=TRAIN_TIMED_STEPS, warm=1)
    device_top, host = {}, {}
    launches, host_top = lm_trace(eager_step, device_top=device_top,
                                  host_launch=host)
    b_ms, b_by, n_bytes, flops = train_bound(tr.params, cfg, B, S)
    n = sum(p.numel() for p in tr.params.parameters())
    del step, eager_step, eager, batch
    torch.cuda.empty_cache()
    opt_row = phase_adamw(tr.params, tr.opt_state, cfg)
    opt_row["main_launches"] = main_launches
    del run, tr
    torch.cuda.empty_cache()
    # card vs CPU in f32 at B = 1, S = 16, the same weights
    t0 = time.perf_counter()
    figures_s = t0 - t_figures
    params = lm_init(cfg).requires_grad_(True)
    cpu = lm_on_cpu(params, cfg).requires_grad_(True)
    batch = train_batch(cfg, seed=5, b=TRAIN_CPU_B, s=TRAIN_CPU_S)
    card_loss, card_g = loss_and_grads(params, cfg, to_device(batch, "cuda"),
                                       Mesh(1, 1))
    card_gn = float(global_norm(card_g))
    del card_g
    cpu_loss, cpu_g = loss_and_grads(cpu, cfg, batch, Mesh(1, 1))
    cpu_gn = float(global_norm(cpu_g))
    del cpu_g, cpu, params
    torch.cuda.empty_cache()
    cpu_s = time.perf_counter() - t0
    loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
    gnorm_err = abs(card_gn - cpu_gn) / cpu_gn
    check(loss_err <= TRAIN_LOSS_TOL and gnorm_err <= TRAIN_GNORM_TOL,
          f"{TRAIN_FULL} f32 card vs CPU: loss {loss_err:.3e}, grad_norm "
          f"{gnorm_err:.3e}")
    return {"arch": TRAIN_FULL, "params": n, "dtype": "bfloat16",
            "batch": B, "seq": S, "remat": cfg.remat,
            "graph": {"capture_s": graph["capture_s"],
                      "captures": graph["captures"],
                      "replays": graph["replays"],
                      "step_device_ms": g_dev_ms, "step_call_ms": g_call_ms,
                      "tok_per_s": B * S / g_call_ms * 1e3,
                      "launches_per_step": g_launches,
                      "host_launches_per_step": sum(g_host.values()),
                      "host_launch_calls": g_host,
                      "host_top_ms_per_step": g_host_top,
                      "peak_bytes": peaks["capture"],
                      "main_peak_bytes": peak,
                      "reserved_bytes": reserved},
            "peak_bytes": eager_peak,
            "step_device_ms": dev_ms, "step_call_ms": call_ms,
            "tok_per_s": B * S / call_ms * 1e3,
            "launches_per_step": launches,
            "host_launches_per_step": sum(host.values()),
            "host_top_ms_per_step": host_top,
            "device_top_ms_per_step": device_top, "adamw": opt_row,
            "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": n_bytes,
            "bound_flops": flops, "ckpt_bytes": ckpt_bytes,
            "save_s": saves, "save_gb_per_s": [ckpt_bytes / 1e9 / x
                                               for x in saves],
            "restore_s": restore_s,
            "restore_gb_per_s": ckpt_bytes / 1e9 / restore_s,
            "disk_free_after_bytes": disk.free,
            "restarts": restarts, "first_loss": losses[0],
            "last_loss": losses[-1], "losses": losses,
            "f32_card_vs_cpu": {"loss_rel_err": loss_err,
                                "gnorm_rel_err": gnorm_err},
            "seconds": {"main": run_s, "main_and_restore":
                        t_figures - t_start, "figures": figures_s,
                        "cpu_compare": cpu_s}}


def phase_train():
    """Phase 10: training; no hand-written kernel may launch."""
    t0 = time.perf_counter()
    before = kernel_counts()
    for arch in TRAIN_ARCHS:
        row = phase_train_reduced(arch)
        row["graph"] = phase_train_graph(arch)
        print("train reduced: " + json.dumps(row))
    t1 = time.perf_counter()
    losses, graph = phase_train_entry_reduced()
    t2 = time.perf_counter()
    print(f"train entry point reduced: 1 restart, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, {graph['replays']} graph replays after "
          f"{graph['captures']} capture ({graph['capture_s'][0]:.2f} s), "
          f"fault run bit-equal to the clean run, checkpoint restored bit "
          f"for bit ({t1 - t0:.1f} s for the reduced archs, {t2 - t1:.1f} s "
          f"for the entry point)")
    row = phase_train_full()
    print("train: " + json.dumps(row))
    check(kernel_counts() == before,
          f"a BSR or MoE kernel launched during training: "
          f"{before} -> {kernel_counts()}")
    print(f"phase 10 took {time.perf_counter() - t0:.1f} s; main replayed "
          f"{row['graph']['replays']} graphs; the fused AdamW "
          f"kernel ran every update ({row['adamw']['main_launches']} "
          f"launches in main); no other hand-written kernel launched")
    return row


# --------------------------------------------------------------------------- #
# phase 11: training on a data x model mesh, one process per mesh slot
# --------------------------------------------------------------------------- #

def _probe_rank(rank, device, names, out):
    """Which of ``names`` this torch's gloo takes on CUDA tensors (each
    tried once, directly; what it refuses is recorded, not worked round)."""
    import torch.distributed as dist

    took = {}
    for name in names:
        dt = torch.bfloat16 if name.endswith("bf16") else torch.float32
        x = torch.ones(8, dtype=dt, device=device)
        try:
            if name.startswith("all_reduce"):
                dist.all_reduce(x)
            elif name == "all_gather_into_tensor":
                dist.all_gather_into_tensor(torch.empty(16, device=device), x)
            elif name == "reduce_scatter_tensor":
                dist.reduce_scatter_tensor(torch.empty(4, device=device), x)
            elif name == "all_to_all_single":
                dist.all_to_all_single(torch.empty_like(x), x)
            else:
                reqs = dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, x, (rank + 1) % 2),
                    dist.P2POp(dist.irecv, torch.empty_like(x),
                               (rank + 1) % 2)])
                for req in reqs:
                    req.wait(datetime.timedelta(seconds=MESH_PROBE_WAIT_S))
            torch.cuda.synchronize()
            took[name] = True
        except Exception as e:  # noqa: BLE001 — the probe records refusals
            took[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    if rank == 0:
        with open(out, "w") as f:
            json.dump(took, f)


def phase_mesh_probe():
    """Which collectives gloo takes on CUDA tensors, in two ranks on the
    card: the ones ``models.sharding.GLOO_CUDA`` hands it directly in one
    world (each must take), every other one in a world of its own.  gloo's
    TCP transport reads a CUDA tensor's device pointer as host memory;
    the failing ``writev`` is raised in the caller or, when gloo's own
    thread writes, aborts the rank, so a dead world is recorded as that
    op's refusal."""
    import torch.multiprocessing as mp
    from repro_torch.launch.mesh import run_world
    from repro_torch.models.sharding import GLOO_CUDA

    direct = [n for n in MESH_PROBES if n.split()[0] in GLOO_CUDA]
    worlds = [direct] + [[n] for n in MESH_PROBES if n not in direct]
    took = {}
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "probe.json")
        for names in worlds:
            try:
                backend = run_world(_probe_rank, 2, "cuda", names, out)
            except mp.ProcessExitedException as e:
                if names is direct:
                    raise SmokeFailure(f"the gloo probe of {names} died: {e}")
                took[names[0]] = f"rank {e.error_index} died: {e}"
                continue
            with open(out) as f:
                took.update(json.load(f))
            os.remove(out)
    print(f"mesh: {backend} on CUDA tensors (2 ranks on one card) takes "
          f"{json.dumps(took)}")
    check(all(took[n] is True for n in direct),
          f"gloo refuses a collective GLOO_CUDA hands it: {took}")
    return took


def _mesh_data(mesh):
    """(data axes with more than one slot, their size)."""
    from repro_torch.launch.mesh import dp_axes, dp_size

    return [a for a in dp_axes(mesh) if mesh.axis_size(a) > 1], dp_size(mesh)


def ce_figures(params, cfg, batch, mesh=None):
    """(ce, aux, norm of the gradient of ce alone) of one batch, over the
    global batch on a mesh: the step's loss minus the aux loss, whose
    per-shard estimator (as the reference's a2a) differs from one
    device's."""
    from repro_torch.launch import partition, specs
    from repro_torch.models import encdec, lm
    from repro_torch.models.sharding import reduce_
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import global_norm

    mod = encdec if cfg.family == "encdec" else lm
    named = dict(params.named_parameters())
    _, met = mod.loss_fn(params, cfg, batch, mesh)
    gs = torch.autograd.grad(met["ce"], list(named.values()),
                             allow_unused=True)
    grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             if g is None else g.float() for (n, p), g in zip(named.items(),
                                                              gs)}
    ce, aux = met["ce"].detach(), met["aux"].detach()
    if mesh is None or mesh.size == 1:
        return float(ce), float(aux), float(global_norm(grads))
    dpa, dsz = _mesh_data(mesh)
    shape = specs.params_shape(cfg)
    o_specs = partition.opt_specs(mesh, adamw_init(shape),
                                  partition.params_specs(mesh, shape))
    o_specs = o_specs["master"]
    grads = partition.reduce_named(grads, o_specs, mesh, dpa)
    grads = {n: g / dsz for n, g in grads.items()}
    for a in dpa:
        ce, aux = reduce_(ce, mesh, a), reduce_(aux, mesh, a)
    return (float(ce) / dsz, float(aux) / dsz,
            float(global_norm(grads, mesh, o_specs)))


def no_drop(cfg):
    """A MoE config with capacity for every token (capacity factor = the
    expert count): a mesh's per-shard capacity then drops nothing that one
    device keeps, so the two compute the same function."""
    if cfg.family != "moe":
        return cfg
    return dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))


def _local_rows(batch, mesh, device):
    from repro_torch.launch import partition

    specs = partition.batch_specs(mesh, batch)
    return {k: partition.local_shard(v, specs[k], mesh).to(device)
            for k, v in batch.items()}


def _mesh_reduced_rank(rank, device, d):
    """Rank ``rank`` of the reduced 2x2 checks: one step per family from
    the parent's weights and batch, moe_a2a, the ring and quantized_psum;
    every hand-written kernel's counter unchanged."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import adamw as A
    from repro_torch.launch import partition
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import encdec, layers, lm
    from repro_torch.models.sharding import STATS
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.runtime import quantized_psum, ring_ag_matmul
    from repro_torch.launch import specs as lspecs

    before = kernel_counts()
    adamw_before = A.adamw_fused.launches
    mesh = make_test_mesh(2, 2).bind()
    res = {}
    for arch in MESH_ARCHS:
        cfg = no_drop(reduced(get_config(arch)))
        data = torch.load(os.path.join(d, f"{arch}.pt"))
        cls = encdec.EncDec if cfg.family == "encdec" else lm.LM
        model = cls(cfg, device=device, dtype=torch.float32)
        model.load_state_dict(data["state"])
        p_specs = partition.params_specs(mesh, model)
        partition.shard_module(model.requires_grad_(True), p_specs, mesh)
        o_specs = partition.opt_specs(
            mesh, adamw_init(lspecs.params_shape(cfg)), p_specs)
        opt = partition.opt_init(model, o_specs, mesh)
        batch = _local_rows(data["batch"], mesh, device)
        ce, aux, gn_ce = ce_figures(model, cfg, batch, mesh)
        step = make_train_step(cfg, OptConfig(**TRAIN_OPT), mesh,
                               grad_specs=o_specs["master"])
        _, opt, m = step(model, opt, batch)
        res[arch] = {"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "lr": float(m["lr"]), "ce": ce, "aux": aux,
                     "gn_ce": gn_ce}
        for key in ("master", "mu"):
            full = partition.gather_named(opt[key], o_specs[key], mesh)
            res[arch][key] = {n: t.cpu() for n, t in full.items()}
    mo = torch.load(os.path.join(d, "moe.pt"))
    cfg = dataclasses.replace(reduced(get_config(TRAIN_FULL)),
                              capacity_factor=4.0)
    p = layers.MoE(cfg, device, torch.float32)
    p.load_state_dict(mo["state"])
    partition.shard_module(p, partition.params_specs(mesh, p), mesh)
    y, _ = layers.moe_a2a(p, _local_rows({"x": mo["x"]}, mesh, device)["x"],
                          cfg, mesh)
    res["moe_y"] = y.detach().cpu()
    ring = torch.load(os.path.join(d, "ring.pt"))
    x, w = ring["x"].to(device), ring["w"].to(device)
    ref = torch.matmul(x, w)
    errs = {}
    for name, mm in (("2x2", mesh), ("1x4", make_test_mesh(1, 4).bind())):
        tp, i = mm.axis_size("model"), mm.coord("model")
        xl = x.chunk(mm.axis_size("data"), 0)[mm.coord("data")]
        want = ref.chunk(mm.axis_size("data"), 0)[mm.coord("data")]
        got = ring_ag_matmul(xl.chunk(tp, 1)[i].contiguous(),
                             w.chunk(tp, 1)[i].contiguous(), mm)
        errs[name] = float((got - want.chunk(tp, 2)[i]).abs().max())
    res["ring_err"] = errs
    mesh41 = make_test_mesh(4, 1).bind()
    g = ring["psum_g"].to(device)
    q = quantized_psum(g[mesh41.coord("data")], mesh41, "data")
    res["psum_rel"] = float(((q - g.sum(0)).abs() / (1 + g.sum(0).abs()))
                            .max())
    res["kernels_moved"] = kernel_counts() != before
    res["adamw_launches"] = A.adamw_fused.launches - adamw_before
    res["stats"] = STATS.snapshot()
    res["decode"] = mesh_decode_checks(mesh, device)
    torch.save(res, os.path.join(d, f"rank{rank}.pt"))


def mesh_decode_checks(mesh, device):
    """Decode on the 2x2 mesh against one device in this rank, from the
    same seeded weights and tokens, per family (and a KV window of 7 on
    model = 2, whole on every rank; mamba2 with H = 3 heads and Ch = 128
    conv channels): prefill on the mesh (its caches in cache_specs'
    layout), grow_caches on the mesh, three decode steps, the last past
    the window; each the max |logit| and cache error against one
    device's."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import partition
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import encdec, lm

    one = make_test_mesh(1, 1)
    B, P = 4, 6

    def rows(x):
        return partition.local_shard(
            x, partition.batch_specs(mesh, {"x": x})["x"], mesh).clone()

    def err(a, b):
        if isinstance(a, dict):
            return max([err(a[k], b[k]) for k in a if k != "window"] + [0.0])
        if a is None:
            return 0.0
        check(a.shape == b.shape, f"mesh decode: {a.shape} vs {b.shape}")
        return float((a.float() - b.float()).abs().max())

    out = {}
    for name, arch, changes, W in MESH_DECODE:
        cfg = dataclasses.replace(reduced(get_config(arch)), **changes)
        mod = encdec if cfg.family == "encdec" else lm
        full = mod.init(torch.Generator(device=device).manual_seed(0), cfg,
                        dtype=torch.float32)
        split = mod.init(torch.Generator(device=device).manual_seed(0), cfg,
                         dtype=torch.float32)
        partition.shard_module(split, partition.params_specs(mesh, split),
                               mesh)
        gen = torch.Generator(device=device).manual_seed(1)
        toks = torch.randint(0, cfg.vocab, (B, P + 3), generator=gen,
                             device=device)
        errs = {}
        with torch.no_grad():
            if cfg.family == "encdec":
                src = torch.randn(B, W, cfg.d_model, generator=gen,
                                  device=device)
                pre = {"src_embeds": src, "tgt_tokens": toks[:, :P]}
                lg1, e1 = make_prefill_step(cfg, one)(full, pre)
                caches = encdec.make_dec_caches(full, cfg, e1, W,
                                                dtype=torch.float32)
                lgm, em = make_prefill_step(cfg, mesh)(
                    split, {k: rows(v) for k, v in pre.items()})
                mine = encdec.make_dec_caches(split, cfg, em, W,
                                              dtype=torch.float32, mesh=mesh)
            else:
                pre = {"tokens": toks[:, :P]}
                lg1, caches = make_prefill_step(cfg, one)(full, pre)
                caches = lm.grow_caches(cfg, caches, W)
                lgm, mine = make_prefill_step(cfg, mesh)(
                    split, {k: rows(v) for k, v in pre.items()})
                mine = lm.grow_caches(cfg, mine, W, mesh=mesh)
            errs["prefill"] = err(lgm, rows(lg1))
            specs = partition.cache_specs(mesh, cfg, caches)
            for i in range(3):
                if i == 2:          # a position past the window: it clamps
                    for c in (caches, mine):
                        for sub in c.values():
                            if isinstance(sub, dict) and "pos" in sub:
                                sub["pos"] = sub["pos"] + W
                tok = toks[:, P + i:P + i + 1]
                lg1, caches = mod.decode_step(full, cfg, tok, caches, one)
                lgm, mine = mod.decode_step(split, cfg, rows(tok), mine, mesh)
                errs[f"decode{i}"] = err(lgm, rows(lg1))
                errs[f"caches{i}"] = err(
                    mine, partition.shard_caches(mesh, cfg, caches))
        out[name] = errs
    return out


def phase_mesh_reduced():
    """Reduced, f32, at 2x2 in four processes on the card: each family's
    step against the one-device step on the card from the same weights and
    batch; moe_a2a against the dense dispatch; the ring; quantized_psum."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import make_test_mesh, run_world
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import layers
    from repro_torch.optim import OptConfig, adamw_init

    opt_cfg = OptConfig(**TRAIN_OPT)
    one, rows = {}, {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        for arch in MESH_ARCHS:
            cfg = no_drop(reduced(get_config(arch)))
            params = lm_init(cfg).requires_grad_(True)
            batch = train_batch(cfg, seed=0, b=4, s=20)
            torch.save({"state": {k: v.cpu() for k, v in
                                  params.state_dict().items()},
                        "batch": batch}, os.path.join(d, f"{arch}.pt"))
            on = to_device(batch, "cuda")
            ce, aux, gn_ce = ce_figures(params, cfg, on, make_test_mesh(1, 1))
            opt = adamw_init(params)
            _, opt, m = make_train_step(cfg, opt_cfg, make_test_mesh(1, 1))(
                params, opt, on)
            one[arch] = {"loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"]),
                         "lr": float(m["lr"]), "ce": ce, "aux": aux,
                         "gn_ce": gn_ce,
                         "master": {n: t.cpu() for n, t in
                                    opt["master"].items()},
                         "mu": {n: t.cpu() for n, t in opt["mu"].items()}}
        cfg = dataclasses.replace(reduced(get_config(TRAIN_FULL)),
                                  capacity_factor=4.0)
        p = layers.MoE(cfg, "cuda", torch.float32)
        p.init_(torch.Generator(device="cuda").manual_seed(3))
        x = torch.randn((4, 16, cfg.d_model), generator=torch.Generator()
                        .manual_seed(4))
        dense, _ = layers.moe_dense(p, x.to("cuda"), cfg)
        torch.save({"state": {k: v.cpu() for k, v in p.state_dict().items()},
                    "x": x}, os.path.join(d, "moe.pt"))
        gen = torch.Generator().manual_seed(5)
        torch.save({"x": torch.randn((4, 16, 32), generator=gen),
                    "w": torch.randn((32, 64), generator=gen) * 0.1,
                    "psum_g": torch.randn((4, 256), generator=gen)},
                   os.path.join(d, "ring.pt"))
        t1 = time.perf_counter()
        run_world(_mesh_reduced_rank, 4, "cuda", d)
        ranks = [torch.load(os.path.join(d, f"rank{r}.pt"))
                 for r in range(4)]
    t2 = time.perf_counter()
    for arch in MESH_ARCHS:
        got, ref = ranks[0][arch], one[arch]
        check(all(r[arch]["loss"] == got["loss"] for r in ranks),
              f"{arch}: the ranks' losses differ")
        ce_err = abs(got["ce"] - ref["ce"]) / abs(ref["ce"])
        gn_ce_err = abs(got["gn_ce"] - ref["gn_ce"]) / ref["gn_ce"]
        if arch == TRAIN_FULL:
            # the aux loss is a per-shard estimator: the step's loss must
            # differ from one device's by 0.01 x the aux losses' difference
            loss_err = abs((got["loss"] - ref["loss"])
                           - 0.01 * (got["aux"] - ref["aux"])) / ref["loss"]
            gnorm_err, over = gn_ce_err, 0.0
        else:
            loss_err = abs(got["loss"] - ref["loss"]) / ref["loss"]
            gnorm_err = abs(got["grad_norm"] - ref["grad_norm"]) \
                / ref["grad_norm"]
            over = master_bound_err(got, ref, ref["lr"], opt_cfg)
        rows[arch] = {"loss_rel_err": loss_err, "gnorm_rel_err": gnorm_err,
                      "ce_rel_err": ce_err, "gn_ce_rel_err": gn_ce_err,
                      "master_over_bound": over}
        check(loss_err <= TRAIN_LOSS_TOL and gnorm_err <= TRAIN_GNORM_TOL
              and ce_err <= TRAIN_LOSS_TOL and gn_ce_err <= TRAIN_GNORM_TOL
              and over <= 0.0,
              f"{arch}: 2x2 vs one device on the card: {rows[arch]}")
    moe_err = max(float((r["moe_y"] - dense.cpu()[2 * (i // 2):
                                                  2 * (i // 2) + 2])
                        .abs().max()) for i, r in enumerate(ranks))
    ring_err = max(max(r["ring_err"].values()) for r in ranks)
    psum_rel = max(r["psum_rel"] for r in ranks)
    check(moe_err <= 1e-4 and ring_err <= 1e-5 and psum_rel < 0.05,
          f"moe_a2a vs dense {moe_err:.3e}, ring {ring_err:.3e}, "
          f"quantized_psum {psum_rel:.3e}")
    check(not any(r["kernels_moved"] for r in ranks),
          "a BSR or MoE kernel launched in a mesh rank")
    check(all(r["adamw_launches"] >= len(MESH_ARCHS) for r in ranks),
          f"a mesh rank's steps did not all go through the fused AdamW "
          f"kernel: {[r['adamw_launches'] for r in ranks]}")
    decode = {name: max(max(r["decode"][name].values()) for r in ranks)
              for name, *_ in MESH_DECODE}
    check(all(v <= MESH_DECODE_TOL for v in decode.values()),
          f"decode on the 2x2 mesh vs one device: {decode} (tolerance "
          f"{MESH_DECODE_TOL})")
    out = {"steps": rows, "moe_a2a_vs_dense": moe_err, "ring_err": ring_err,
           "quantized_psum_rel": psum_rel,
           "adamw_launches": [r["adamw_launches"] for r in ranks],
           "decode_vs_one_device": decode,
           "stats": [r["stats"] for r in ranks],
           "seconds": {"one_device": t1 - t0, "world": t2 - t1}}
    print("mesh reduced: " + json.dumps(out))
    return out


def _mesh_figures_rank(rank, device, d):
    """One rank of the full-width 2x2 step's figures: the device time of a
    step (``device_ms``: one step traced after one warm-up step), the
    collectives per step of the steps it ran, peak memory.  The call time
    per step is ``main``'s (its per-rank ``step_s``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.sharding import STATS
    from repro_torch.optim import OptConfig

    from repro_torch.kernels import adamw as A

    before = kernel_counts()
    torch.cuda.reset_peak_memory_stats(device)
    mesh = make_test_mesh(2, 2).bind()
    cfg = dataclasses.replace(get_config(TRAIN_FULL), microbatch=1)
    params, opt, step_fn = train.build(
        cfg, mesh, OptConfig(warmup_steps=10, total_steps=10), device=device)
    batch = train.make_batches(cfg, 8, 128, device, mesh=mesh)(0)
    state = {"p": params, "o": opt, "steps": 0}

    def step():
        _, state["o"], m = step_fn(state["p"], state["o"], batch)
        state["steps"] += 1
        return m

    STATS.reset()
    launches = A.adamw_fused.launches
    dev = device_ms(step, runs=1, warm=1)
    n = state["steps"]
    out = {"rank": rank, "step_device_ms": dev,
           "adamw_launches_per_step":
               (A.adamw_fused.launches - launches) / max(n, 1),
           "collectives_per_step": {
               "calls": {k: v / n for k, v in STATS.calls.items()},
               "bytes": {k: v / n for k, v in STATS.bytes.items()},
               "host_staged_bytes": STATS.host_staged_bytes / n},
           "peak_bytes": torch.cuda.max_memory_allocated(device),
           "kernels_moved": kernel_counts() != before}
    with open(os.path.join(d, f"fig{rank}.json"), "w") as f:
        json.dump(out, f)


def _mesh_reshard_rank(rank, device, ckpt_dir, d):
    """One of two ranks: the 2x2 run's last checkpoint resharded onto 2x1,
    and every slice held against the files, bit for bit."""
    from repro_torch.checkpoint import CheckpointManager, store
    from repro_torch.configs import get_config
    from repro_torch.launch import partition, specs
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import reshard_checkpoint, shardings_for

    mesh = make_test_mesh(2, 1).bind()
    cfg = get_config(TRAIN_FULL)
    shape = specs.params_shape(cfg)
    t0 = time.perf_counter()
    params, opt = reshard_checkpoint(CheckpointManager(ckpt_dir), cfg, mesh,
                                     shape, adamw_init(shape), device=device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    p_shard, o_shard = shardings_for(mesh, cfg, shape, adamw_init(shape))
    step = store.latest_step(ckpt_dir)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    index = {p: i for i, p in enumerate(manifest["extra"]["paths"])}
    same, n = True, 0
    for file_path, layer, t, ns in store._targets(
            {"params": params, "opt": opt},
            {"params": p_shard, "opt": o_shard}):
        rec = manifest["arrays"][index[file_path]]
        arr = np.load(os.path.join(path, rec["file"]), mmap_mode="r")
        if layer is not None:
            arr = arr[layer]
        spec = ns.spec[1:] if layer is not None else ns.spec
        want = np.array(arr[partition.slices(arr.shape, spec, mesh)])
        got = t.detach().cpu()
        if got.dtype == torch.bfloat16:
            got = got.view(torch.int16)
        same &= want.tobytes() == got.numpy().tobytes()
        n += 1
    with open(os.path.join(d, f"reshard{rank}.json"), "w") as f:
        json.dump({"rank": rank, "load_s": load_s, "leaves": n,
                   "bit_equal": bool(same)}, f)


def _mesh_f32_rank(rank, device, d):
    """One rank of the full-width f32 check (no-drop capacity): ce, aux
    and the gradient norm of ce, then one step, at 2x2."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim import OptConfig

    mesh = make_test_mesh(2, 2).bind()
    cfg = no_drop(dataclasses.replace(get_config(TRAIN_FULL), microbatch=1))
    params, opt, step = train.build(cfg, mesh, OptConfig(**TRAIN_OPT),
                                    dtype=torch.float32, device=device)
    batch = train.make_batches(cfg, MESH_F32_B, MESH_F32_S, device,
                               dtype=torch.float32, mesh=mesh)(0)
    ce, aux, gn_ce = ce_figures(params, cfg, batch, mesh)
    _, _, m = step(params, opt, batch)
    if rank == 0:
        with open(os.path.join(d, "f32.json"), "w") as f:
            json.dump({"ce": ce, "aux": aux, "gn_ce": gn_ce,
                       "loss": float(m["loss"]),
                       "grad_norm": float(m["grad_norm"])}, f)


def phase_mesh_full(probe):
    """TRAIN_FULL at full width on 2x2 through ``main`` at its defaults, a
    reshard of its checkpoint onto 2x1, the figures of one step, and an f32
    check against one device; the ``mesh train:`` line."""
    from repro_torch.configs import get_config
    from repro_torch.launch import specs, train
    from repro_torch.launch.mesh import make_test_mesh, run_world
    from repro_torch.optim import OptConfig

    torch.cuda.empty_cache()
    t_start = time.perf_counter()
    cfg = get_config(TRAIN_FULL)
    with tempfile.TemporaryDirectory() as d:
        ckpt_dir = os.path.join(d, "ckpt")
        run = train.main(["--arch", TRAIN_FULL, "--data-mesh", "2",
                          "--model-mesh", "2", "--steps",
                          str(TRAIN_FULL_STEPS), "--ckpt-dir", ckpt_dir])
        t_main = time.perf_counter()
        losses = run.summary["losses"]
        ln_v = math.log(cfg.vocab)
        check(len(losses) == TRAIN_FULL_STEPS and all(
            math.isfinite(x) for x in losses) and losses[-1] < losses[0]
            and abs(losses[0] - ln_v) < 1.5,
            f"{TRAIN_FULL} on 2x2: losses {losses} (first near ln V = "
            f"{ln_v:.3f})")
        step_dir = os.path.join(ckpt_dir, f"step_{TRAIN_FULL_STEPS:08d}")
        ckpt_bytes = sum(f.stat().st_size for f in Path(step_dir).iterdir())
        run_world(_mesh_reshard_rank, 2, "cuda", ckpt_dir, d)
        t_reshard = time.perf_counter()
        reshard = []
        for r in range(2):
            with open(os.path.join(d, f"reshard{r}.json")) as f:
                reshard.append(json.load(f))
        check(all(r["bit_equal"] for r in reshard),
              f"the 2x1 reshard of the 2x2 checkpoint is not bit-equal: "
              f"{reshard}")
        shutil.rmtree(ckpt_dir)
        run_world(_mesh_figures_rank, 4, "cuda", d)
        figures = []
        for r in range(4):
            with open(os.path.join(d, f"fig{r}.json")) as f:
                figures.append(json.load(f))
        t_figures = time.perf_counter()
        check(not any(f["kernels_moved"] for f in figures),
              "a BSR or MoE kernel launched in a full-width mesh rank")
        check(all(f["adamw_launches_per_step"] >= 1 for f in figures)
              and all(r["adamw_launches"] >= TRAIN_FULL_STEPS
                      for r in run.summary["ranks"]),
              f"a full-width mesh rank's updates did not all go through the "
              f"fused AdamW kernel: main "
              f"{[r['adamw_launches'] for r in run.summary['ranks']]}, "
              f"figures {[f['adamw_launches_per_step'] for f in figures]}")
        run_world(_mesh_f32_rank, 4, "cuda", d)
        with open(os.path.join(d, "f32.json")) as f:
            mesh_f32 = json.load(f)
    # the same weights and batch on one device, after the ranks have gone
    torch.cuda.empty_cache()
    one_cfg = no_drop(dataclasses.replace(cfg, microbatch=1))
    params, opt, step = train.build(one_cfg, make_test_mesh(1, 1),
                                    OptConfig(**TRAIN_OPT),
                                    dtype=torch.float32, device="cuda")
    batch = train.make_batches(one_cfg, MESH_F32_B, MESH_F32_S, "cuda",
                               dtype=torch.float32)(0)
    ce, aux, gn_ce = ce_figures(params, one_cfg, batch, make_test_mesh(1, 1))
    _, _, m = step(params, opt, batch)
    del params, opt, step
    torch.cuda.empty_cache()
    t_f32 = time.perf_counter()
    one_f32 = {"ce": ce, "aux": aux, "gn_ce": gn_ce, "loss": float(m["loss"]),
               "grad_norm": float(m["grad_norm"])}
    f32 = {"ce_rel_err": abs(mesh_f32["ce"] - ce) / ce,
           "gn_ce_rel_err": abs(mesh_f32["gn_ce"] - gn_ce) / gn_ce,
           "loss_minus_aux_rel_err": abs(
               (mesh_f32["loss"] - one_f32["loss"])
               - 0.01 * (mesh_f32["aux"] - aux)) / one_f32["loss"],
           "mesh": mesh_f32, "one_device": one_f32}
    check(f32["ce_rel_err"] <= TRAIN_LOSS_TOL
          and f32["gn_ce_rel_err"] <= TRAIN_GNORM_TOL
          and f32["loss_minus_aux_rel_err"] <= TRAIN_LOSS_TOL,
          f"{TRAIN_FULL} f32 2x2 vs one device: {f32}")
    b_ms, b_by, n_bytes, flops = train_bound(specs.params_shape(cfg), cfg,
                                             8, 128)
    ranks = run.summary["ranks"]
    return {"arch": TRAIN_FULL, "mesh": {"data": 2, "model": 2},
            "backend": run.backend, "gloo_cuda": probe,
            "params": sum(p.numel() for p in
                          specs.params_shape(cfg).parameters()),
            "dtype": "bfloat16", "batch": 8, "seq": 128, "remat": cfg.remat,
            "losses": losses, "restarts": run.summary["restarts"],
            "ranks": [{"rank": r, "peak_bytes": ranks[r]["peak_bytes"],
                       "step_call_s": ranks[r]["step_s"],
                       "adamw_launches": ranks[r]["adamw_launches"],
                       "adamw_launches_per_step":
                           figures[r]["adamw_launches_per_step"],
                       "run_collectives": ranks[r]["collectives"],
                       "figures_peak_bytes": figures[r]["peak_bytes"],
                       **{k: figures[r][k] for k in
                          ("step_device_ms", "collectives_per_step")}}
                      for r in range(4)],
            "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": n_bytes,
            "bound_flops": flops, "ckpt_bytes": ckpt_bytes,
            "save_s": ranks[0]["save_s"],
            "reshard_2x1_s": [r["load_s"] for r in reshard],
            "reshard_leaves": reshard[0]["leaves"], "f32_vs_one_device": f32,
            "seconds": {"main": t_main - t_start,
                        "reshard": t_reshard - t_main,
                        "figures": t_figures - t_reshard,
                        "f32": t_f32 - t_figures,
                        "phase": t_f32 - t_start}}


def phase_mesh():
    """Phase 11: training on a 2x2 mesh of processes on the one card; no
    hand-written kernel may launch."""
    t0 = time.perf_counter()
    before = kernel_counts()
    probe = phase_mesh_probe()
    phase_mesh_reduced()
    row = phase_mesh_full(probe)
    row["seconds"]["phase_11"] = time.perf_counter() - t0
    print("mesh train: " + json.dumps(row))
    check(kernel_counts() == before,
          f"a BSR or MoE kernel launched during phase 11: "
          f"{before} -> {kernel_counts()}")
    print(f"phase 11 took {time.perf_counter() - t0:.1f} s; every rank "
          f"updated through the fused AdamW kernel; no other hand-written "
          f"kernel launched in any rank")
    return row


# --------------------------------------------------------------------------- #
# phase 12: the dry run's cost analysis against the card
# --------------------------------------------------------------------------- #

def _meta_like(tree):
    if isinstance(tree, dict):
        return {k: _meta_like(v) for k, v in tree.items()}
    return None if tree is None else torch.empty_like(tree, device="meta")


def dry_step(cfg, kind, device):
    """(step, args) of one reduced ``kind`` step (train, prefill, decode):
    f32 weights from seed 0 and seeded inputs on ``device``; on ``meta``
    the same shapes."""
    from repro_torch.launch import specs
    from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                          make_train_step)
    from repro_torch.models import encdec, lm
    from repro_torch.optim import OptConfig, adamw_init

    on = (lambda t: _meta_like(t)) if device == "meta" else \
        (lambda t: to_device(t, device))
    params = specs.params_shape(cfg, dtype=torch.float32) \
        if device == "meta" else lm_init(cfg, device)
    batch = on(train_batch(cfg, seed=3, b=DRY_B, s=DRY_S))
    if kind == "train":
        params.requires_grad_(True)
        return make_train_step(cfg, OptConfig()), (params, adamw_init(params),
                                                    batch)
    params.requires_grad_(False)
    tok = batch.pop("labels")[:, :1].contiguous()
    if kind == "prefill":
        return make_prefill_step(cfg), (params, batch)
    if cfg.family == "encdec":
        with torch.no_grad():
            caches = encdec.make_dec_caches(params, cfg, batch["src_embeds"],
                                            DRY_W)
    else:
        caches = lm.make_caches(cfg, DRY_B, DRY_W, device=device)
    return make_serve_step(cfg), (params, caches, tok)


def dry_flops():
    """Each reduced arch's train, prefill and decode step: FlopCounterMode
    on the card's real step against ``analyze_step`` on meta."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import cost_analysis as ca

    rows = []
    for arch in DRY_ARCHS:
        cfg = dataclasses.replace(reduced(get_config(arch)), remat=True,
                                  microbatch=2, attn_chunk=8)
        for kind in ("train", "prefill", "decode"):
            grad = torch.enable_grad if kind == "train" else torch.no_grad
            step, args = dry_step(cfg, kind, "cuda")
            with grad(), FlopCounterMode(display=False) as counter:
                step(*args)
            torch.cuda.synchronize()
            del step, args
            step, args = dry_step(cfg, kind, "meta")
            with grad():
                cost, _ = ca.analyze_step(step, *args)
            rows.append({"arch": cfg.name, "kind": kind,
                         "card_flops": counter.get_total_flops(),
                         "meta_flops": cost.flops})
            check(cost.flops == counter.get_total_flops(),
                  f"dry run FLOPs of {cfg.name} {kind}: meta {cost.flops} "
                  f"!= card {counter.get_total_flops()}")
    return rows


def dry_trace(mesh_shape):
    """TRAIN_FULL at phase 10's and 11's setting (bf16, B = 8, S = 128,
    remat on, one microbatch) traced on meta as rank 0 of a fake world of
    ``data x model`` ranks: (cost, memory, roofline)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import cost_analysis as ca
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.sharding import axes_from_mesh, set_mesh

    cfg = dataclasses.replace(get_config(TRAIN_FULL), microbatch=1)
    shape = ShapeConfig("phase_10_11", 128, 8, "train")
    with dryrun.fake_world(mesh_shape[0] * mesh_shape[1]):
        mesh = make_test_mesh(*mesh_shape).bind()
        axes_from_mesh(mesh)
        set_mesh(mesh)
        step, args = dryrun.build_cell(cfg, shape, mesh)
        cost, mem = ca.analyze_step(step, *args)
        del step, args
    rl = ca.roofline(cost, ca.collective_stats(cost), mesh.size,
                     ca.model_flops_for(cfg, shape), mem)
    return cost, mem, rl


def phase_dryrun(train_row, mesh_row):
    """Phase 12: the dry run's cost analysis against what phases 10 and 11
    measured in this run, and FLOPs against real steps on the card; no
    hand-written kernel may launch."""
    from repro_torch.launch.cost_analysis import HLO_NAMES

    t0 = time.perf_counter()
    before = kernel_counts()
    cost22, mem22, rl22 = dry_trace((2, 2))
    rank0 = mesh_row["ranks"][0]["collectives_per_step"]
    card = {"calls": {HLO_NAMES[k]: v for k, v in rank0["calls"].items()},
            "bytes": {HLO_NAMES[k]: v for k, v in rank0["bytes"].items()}}
    line = {"check": "collectives", "mesh": "2x2", "rank": 0,
            "dry_run": {"calls": cost22.coll_calls,
                        "bytes": cost22.coll_by_op,
                        "total_bytes": cost22.coll_bytes},
            "phase_11": dict(card, total_bytes=sum(card["bytes"].values()))}
    print("dryrun: " + json.dumps(line))
    check(cost22.coll_calls == card["calls"]
          and cost22.coll_by_op == card["bytes"],
          f"dry run collectives differ from phase 11's rank 0: {line}")
    t1 = time.perf_counter()
    flops = dry_flops()
    print("dryrun: " + json.dumps({"check": "flops", "rows": flops}))
    t2 = time.perf_counter()
    cost11, mem11, rl11 = dry_trace((1, 1))
    measured = {"1x1": train_row["peak_bytes"],
                "2x2": max(r["peak_bytes"] for r in mesh_row["ranks"])}
    mems = []
    for name, mem in (("1x1", mem11), ("2x2", mem22)):
        ratio = mem.peak_bytes / measured[name]
        mems.append({"mesh": name, "predicted_peak_bytes": mem.peak_bytes,
                     "memory": mem.record(),
                     "max_memory_allocated": measured[name], "ratio": ratio})
    print("dryrun: " + json.dumps({"check": "memory", "rows": mems}))
    check(all(abs(m["ratio"] - 1) <= DRY_MEM_TOL for m in mems),
          f"dry run peak memory off by more than {DRY_MEM_TOL:.0%}: {mems}")
    roof = []
    for name, rl, dev, call in (
            ("1x1", rl11, [train_row["step_device_ms"]],
             [train_row["step_call_ms"]]),
            ("2x2", rl22, [r["step_device_ms"] for r in mesh_row["ranks"]],
             [1e3 * x for r in mesh_row["ranks"] for x in r["step_call_s"]])):
        roof.append({"mesh": name, "compute_ms": 1e3 * rl.compute_s,
                     "memory_ms": 1e3 * rl.memory_s,
                     "collective_ms": 1e3 * rl.collective_s,
                     "dominant": rl.dominant, "flops_per_dev": rl.flops_per_dev,
                     "useful_ratio": rl.useful_ratio,
                     "measured_device_ms": dev,
                     "measured_call_ms": [min(call), max(call)]})
    print("dryrun: " + json.dumps({"check": "roofline", "rows": roof}))
    check(kernel_counts() == before,
          f"a hand-written kernel launched during phase 12: {before} -> "
          f"{kernel_counts()}")
    took = time.perf_counter() - t0
    print("dryrun: " + json.dumps({
        "check": "time", "seconds": took, "collectives_s": t1 - t0,
        "flops_s": t2 - t1, "memory_s": time.perf_counter() - t2}))
    check(took <= DRY_BUDGET_S, f"phase 12 took {took:.1f} s, over its "
          f"{DRY_BUDGET_S:.0f} s")
    print(f"phase 12 took {took:.1f} s; no hand-written kernel launched")


def main() -> int:
    # cuBLAS's deterministic workspace setting (phase 10 turns on
    # deterministic algorithms); it must be set before CUDA starts, and
    # equals the default size on sm_90
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: src/repro_torch not found beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.engine import Engine
    from repro_torch.launch.serve import make_ffnn_layers

    try:
        smi = phase_env()
        phase_build()
        rng = np.random.default_rng(0)
        layers = make_ffnn_layers(SIZES, DENSITY, BLOCK)
        plans = compile_plans(layers, Engine)
        print(plans["f32"].describe())
        main_err = phase_kernels(plans, rng)
        main_err["bsr_megakernel_gated"] = phase_gated_kernels(layers, rng,
                                                               Engine)
        launches, server, args = phase_main_path(no_fuse=False)
        launches = dict(launches)
        launches["bsr_matmul"] = phase_main_path(no_fuse=True)[0]["bsr_matmul"]
        launches["bsr_megakernel_gated"] = phase_gated_main_path()
        entries = phase_times(plans, rng)
        phase_times_large()
        phase_trace(server, args)
        launches["moe_ffn"], main_err["moe_ffn"], entries["moe_ffn"] = \
            phase_moe()
        phase_runtime()
        sharded_launches = phase_sharded(layers, rng, Engine, plans["f32"])
        phase_lm()
        train_row = phase_train()
        mesh_row = phase_mesh()
        phase_dryrun(train_row, mesh_row)
        kernels = kernel_line(entries, launches, main_err, sharded_launches)
        kernels.append(adamw_kernel_row(train_row))
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
