"""chip_smoke.py under PyTorch's deterministic algorithms.

When two runs, or two commits, read losses that differ in the last digits,
this run tells the port's kernels from PyTorch's own: with
torch.use_deterministic_algorithms(True, warn_only=True) every PyTorch op
that has a deterministic CUDA implementation uses it, and one that has
none warns once on stderr (naming itself) and runs as before.  cuBLAS
gets the fixed workspace it needs for that (CUBLAS_WORKSPACE_CONFIG).
The port's kernels run as they always do.  The device times this run
prints are not chip_smoke.py's: the deterministic implementations are
slower.

On a machine with the card, from the repository root:

    python3 tools/deterministic_smoke.py > smoke.log 2> warnings.log
"""
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main():
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)
    import torch
    torch.use_deterministic_algorithms(True, warn_only=True)
    import chip_smoke
    chip_smoke.main()


if __name__ == "__main__":
    main()
