"""chip_smoke.py's phase 15 (batched-serve) with only the phases that make
its checkpoints: phase 8's ASR training steps, phase 10's MMA and phase
13's CIF training steps from that encoder (their own checks included),
then `chip_smoke.phase_batched_serve` on the trained checkpoints, whose
traffic checks hold for these weights.  Needs the card; from the
repository root:

    python3 tools/batched_serve_smoke.py

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
    from simulst_tpu_torch import config as cfglib
    from simulst_tpu_torch.ops import _build
    from simulst_tpu_torch.train.checkpoint import save_checkpoint

    if not torch.cuda.is_available():
        raise SystemExit("batched_serve_smoke: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    print("build_s", time.perf_counter() - t0, flush=True)
    print(cs.gpu_name_and_power_limit(), flush=True)
    with tempfile.TemporaryDirectory() as work:
        checkpoints = {kind: os.path.join(work, f"{kind}_checkpoint")
                       for kind in ("asr", "mma", "cif")}
        asr = cs.asr_batch(dev)
        cs.phase_asr_train(dev, asr, checkpoints["asr"])
        _, mma_model = cs.phase_mma_train(dev, asr, checkpoints["asr"])
        save_checkpoint(checkpoints["mma"], mma_model.state_dict(),
                        {"model": "mma",
                         "config": cfglib.to_dict(mma_model.cfg)})
        del mma_model
        cs.phase_cif_train(dev, asr, checkpoints["asr"], checkpoints["cif"])
        del asr
        cs.phase_batched_serve(dev, work, checkpoints)
    print("total_s", time.perf_counter() - t0, flush=True)


if __name__ == "__main__":
    main()
