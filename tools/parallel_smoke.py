"""chip_smoke.py's phase 21 (parallel) with only the phase it reads:
phase 7's batch of 32 utterances; then `chip_smoke.phase_parallel`, which
spawns two ranks (each on its own card over NCCL, or both on one card over
gloo where the machine has one).  Needs the card; from the repository
root:

    python3 tools/parallel_smoke.py

Prints the build time, the card's name and power limit, the phase's lines
and the total time; exits non-zero when a check fails.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import torch
    import chip_smoke as cs
    from simulst_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("parallel_smoke: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    print("build_s", time.perf_counter() - t0, flush=True)
    print(cs.gpu_name_and_power_limit(), flush=True)
    launches = cs.phase_parallel(dev, cs.asr_batch(dev))
    print("launches", {k: v for k, v in launches.items() if v}, flush=True)
    print("total_s", time.perf_counter() - t0, flush=True)


if __name__ == "__main__":
    main()
