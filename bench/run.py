"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python bench/run.py --workload bert-ffnn.online-poisson --seed 1 \
        --seconds 20 --trace 0

Run from the root of a checkout on a machine with a CUDA device; see
``bench/README.md``.
"""

import os
import sys
import time


def _process_age_s() -> float:
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_PROCESS = time.perf_counter() - _process_age_s()
BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)

if __name__ == "__main__":
    # every build and kernel cache at a fixed path inside the checkout
    os.environ["TRITON_CACHE_DIR"] = os.path.join(BENCH, ".cache", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BENCH, ".cache",
                                                      "torch_extensions")
    sys.path[:0] = [BENCH, os.path.join(ROOT, "src")]
    from sparsebench.cli import main

    sys.exit(main(t_process=T_PROCESS))
