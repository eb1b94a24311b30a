"""chip_smoke.py's phase 23 (the six (task, model, loss) triples) with only
the phases that make its encoder: phase 7's batch and phase 8's ASR
training steps (their own checks included), then
`chip_smoke.phase_triples` from phase 8's checkpoint.  Needs the card;
from the repository root:

    python3 tools/triples_smoke.py

Prints the build time, the card's name and power limit, the phases' lines
and the total time; exits non-zero when a phase fails.
"""
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import torch
    import chip_smoke as cs
    from simulst_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("triples_smoke: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    print("build_s", time.perf_counter() - t0, flush=True)
    print(cs.gpu_name_and_power_limit(), flush=True)
    with tempfile.TemporaryDirectory() as work:
        checkpoint = os.path.join(work, "asr_checkpoint_last")
        asr = cs.asr_batch(dev)
        cs.phase_asr_train(dev, asr, checkpoint)
        t1 = time.perf_counter()
        cs.phase_triples(dev, asr, checkpoint)
        print("phase23_s", time.perf_counter() - t1, flush=True)
    print("total_s", time.perf_counter() - t0, flush=True)


if __name__ == "__main__":
    main()
