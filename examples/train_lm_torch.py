"""Train a small LM for a few hundred steps with the full production stack,
on the PyTorch/CUDA port (twin of ``examples/train_lm.py``): sharded params,
AdamW + cosine schedule, deterministic data pipeline, async checkpointing,
fault injection, and automatic restart.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200 --arch zamba2-1.2b

Uses the reduced config of the chosen architecture; the same entry point scales
the full config on a mesh (see repro_torch.launch.train).  It trains on
``--device`` (``cuda`` unless given; ``--device cpu`` on a host without a
card), and checkpoints to ``repro_example`` in the temporary directory.
"""

import os
import subprocess
import sys
import tempfile


def main():
    args = sys.argv[1:]
    if not any(a.startswith("--steps") for a in args):
        args += ["--steps", "120"]
    if not any(a.startswith("--arch") for a in args):
        args += ["--arch", "zamba2-1.2b"]
    if not any(a.startswith("--device") for a in args):
        args += ["--device", "cuda"]
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
           "--batch", "8", "--seq", "64", "--ckpt-dir",
           os.path.join(tempfile.gettempdir(), "repro_example"),
           "--inject-fault-at", "40"] + args
    print("+", " ".join(cmd))
    raise SystemExit(subprocess.call(cmd))


if __name__ == "__main__":
    main()
