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
     what ``--no-fuse`` runs) and the cooperative grid size; then one
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
     seconds each, and the card's busy share of a profiled window.

The last two lines are the card's name and power limit, then
``{"ok": true, "device": {...}}``; the line before them is the ``kernels``
JSON.  Without a CUDA device, or without ``src/repro_torch`` beside this
file, it exits non-zero before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
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
# H100 SXM data-sheet peaks: HBM bytes/s, f32 FMA operations/s outside the
# tensor cores (the kernels' arithmetic) and bf16 tensor-core operations/s.
HBM_BPS = 3.35e12
F32_OPS = 67e12
BF16_OPS = 989e12
TPU_KERNELS = {
    "bsr_matmul": "src/repro/kernels/bsr_matmul.py:81",
    "bsr_megakernel": "src/repro/kernels/bsr_matmul.py:279",
    "bsr_megakernel_gated": "src/repro/kernels/bsr_matmul.py:279",
    "moe_ffn": "src/repro/kernels/moe_ffn.py:47",
}
SOURCES = {
    "bsr_matmul": "src/repro_torch/kernels/csrc/bsr_matmul.cu",
    "bsr_megakernel": "src/repro_torch/kernels/csrc/bsr_kernels.cu",
    "bsr_megakernel_gated": "src/repro_torch/kernels/csrc/bsr_kernels.cu",
    "moe_ffn": "src/repro_torch/kernels/csrc/moe_ffn.cu",
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
    in it.  A trace now and then holds another trace's device activity and
    misses its own, so only activity that starts after the trace's first
    host event counts, and a trace whose activity is not a whole number per
    call is taken again, up to ``tries`` times.  None when no trace shows
    device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        t0 = min((e.time_range.start for e in events
                  if e.device_type == DeviceType.CPU), default=None)
        dev = [e for e in events if e.device_type == DeviceType.CUDA
               and (t0 is None or e.time_range.start >= t0)]
        if dev and len(dev) % runs == 0:
            return sum(e.time_range.elapsed_us() for e in dev) / 1e3 / runs
    return None


def bound_ms(n_bytes, n_ops, ops_rate=F32_OPS):
    t_bytes, t_ops = n_bytes / HBM_BPS, n_ops / ops_rate
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
               "moe_bf16_kernel", "moe_f32_kernel")


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
                              else BF16_OPS)
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


def kernel_line(entries, launches, main_err):
    """The ``kernels`` JSON rows, one per kernel, from its timing row."""
    return [{
        "name": name, "route": "cuda", "source": SOURCES[name],
        "replaces": TPU_KERNELS[name], "launches": launches[name],
        "max_abs_err": main_err[name], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
    } for name, row in entries.items()]


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


def main() -> int:
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
        phase_trace(server, args)
        launches["moe_ffn"], main_err["moe_ffn"], entries["moe_ffn"] = \
            phase_moe()
        phase_runtime()
        kernels = kernel_line(entries, launches, main_err)
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
