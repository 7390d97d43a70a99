#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port, on one H100.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

  1. environment: torch/CUDA versions, device capability (9, 0), the card's
     name and power limit from nvidia-smi;
  2. build: both CUDA kernels compiled with nvcc for sm_90a;
  3. kernel vs plain at the BERT-large FFNN shapes (1024 -> 4096 -> 1024,
     density 0.1, 128x128 tiles, gelu): ``bsr_matmul`` per layer and
     ``bsr_megakernel`` for the net, f32/bf16/fp8 weights, f32/bf16
     inputs, B in {1, 4, 32}, each against its plain PyTorch version;
  4. main path: ``repro_torch.launch.serve --sparse-ffnn --batch 4
     --requests 64 --reorder-iters 300`` in-process — every request answered,
     answers equal to the plan's torch-backend safe twin, and one megakernel
     launch per forward; again with ``--no-fuse``, one bsr_matmul launch per
     layer per forward;
  5. times of each kernel, its plain version and a dense PyTorch yardstick,
     beside the least time the card could take for the same work: device
     time per call from a torch.profiler trace of 30 calls, and per-call
     time between CUDA events (median of 30, after warm-up), which adds the
     host's share of the call; then one profiled serving window, for the
     device's busy share.

The last two lines are the card's name and power limit, then
``{"ok": true, "device": {...}}``; the line before them is the ``kernels``
JSON.  Without a CUDA device, or without ``src/repro_torch`` beside this
file, it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SIZES = [1024, 4096, 1024]
DENSITY, BLOCK, REORDER_ITERS = 0.1, 128, 300
BATCHES = (1, 4, 32)
MAIN_B = 4
# kernel vs plain on the same inputs: both accumulate in f32, in different
# orders (FMA chain vs per-block matmul) -> f32 outputs agree to 1e-4;
# bf16 outputs may round one bf16 ulp apart -> 3e-2 (as the reference's
# kernel tests).  Error = max |a - b| / (1 + |b|).
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# H100 SXM data-sheet peaks: HBM bytes/s and
# f32 FMA operations/s outside the tensor cores (the kernels' arithmetic).
HBM_BPS = 3.35e12
F32_OPS = 67e12
TPU_KERNELS = {
    "bsr_matmul": "src/repro/kernels/bsr_matmul.py:81",
    "bsr_megakernel": "src/repro/kernels/bsr_matmul.py:279",
}
SOURCE = "src/repro_torch/kernels/csrc/bsr_kernels.cu"


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


def device_ms(fn, runs=30, warm=5):
    """Device time per call (ms): the summed duration of the GPU activities
    (kernels, copies) that ``runs`` calls put on the card, from a
    torch.profiler trace, over ``runs``.  Host time between launches is not
    in it.  None when the trace shows no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / runs if us > 0 else None


def bound_ms(n_bytes, n_ops):
    t_bytes, t_ops = n_bytes / HBM_BPS, n_ops / F32_OPS
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


def phase_build():
    from repro_torch.kernels import _build

    path, seconds, log = _build.build()
    print(f"build: {path.name} in {seconds:.1f} s (nvcc, sm_90a)")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    _build.load()


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
    n = 0
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
                y_ref = K.bsr_megakernel_plain(x, plan.flat, "gelu", "none")
                torch.cuda.synchronize()
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
          f"(weights f32/bf16/fp8, x f32/bf16, B in {BATCHES})")
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
    y_ref = plans.base.safe_twin()(x).cpu()
    err, _ = rel_err(y, y_ref)
    check(y.shape == (64, SIZES[-1]) and bool(torch.isfinite(y).all()),
          "served answers are not finite [64, 1024]")
    check(err < TOL[torch.float32],
          f"served answers vs torch safe twin: error {err:.3e}")
    print(f"main path answers vs torch-backend safe twin: error {err:.3e}")
    return launches, server, args


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


def phase_times(plans, rng, launches, main_err):
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
        row["ms_layer0"] = device_ms(
            lambda: K.bsr_matmul(x, schs[0], biases[0], "gelu"))
        detail.append(row)
        # the whole net: a dense chain addmm -> gelu -> addmm as yardstick
        nnz = sum(l.nnz_blocks for l in layers)
        nbytes = (x.numel() * 4 + nnz * per_block
                  + sum(l.n_out for l in layers) * 4
                  + MAIN_B * SIZES[-1] * 4)
        nops = 2 * MAIN_B * BLOCK * BLOCK * nnz
        b_ms, b_by = bound_ms(nbytes, nops)
        mrow = timed(
            "bsr_megakernel", wdt, "whole net",
            lambda: K.bsr_megakernel(x, plan.flat, "gelu", "none"),
            lambda: K.bsr_megakernel_plain(x, plan.flat, "gelu", "none"),
            lambda: torch.addmm(biases[1], gelu(torch.addmm(
                biases[0], x, dense[0])), dense[1]), b_ms, b_by)
        detail.append(mrow)
        if wdt == "f32":
            entries["bsr_matmul"] = row
            entries["bsr_megakernel"] = mrow
    for row in detail:
        print("time: " + json.dumps(row))
    kernels = []
    for name in ("bsr_matmul", "bsr_megakernel"):
        row = entries[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": TPU_KERNELS[name], "launches": launches[name],
            "max_abs_err": main_err[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    return kernels


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
        launches, server, args = phase_main_path(no_fuse=False)
        launches = dict(launches)
        launches["bsr_matmul"] = phase_main_path(no_fuse=True)[0]["bsr_matmul"]
        kernels = phase_times(plans, rng, launches, main_err)
        phase_trace(server, args)
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
