"""chip_smoke.py's phase 22 (widths) with only phase 7's batch before it:
the kernels at the corners of the widths they take against their plain
versions (kernels), at the widths the wrappers pad (padded), their times
at D 512, 16 and 200 (times), a 512-wide train step (train), JAX's
16-wide dry-run CIF model through a train step and fused streaming
(narrow), the tone-language CIF leg and the kernel convergence
trajectory.  Needs the card; from the repository root:

    python3 tools/widths_smoke.py [--parts kernels,padded,times,train,
                                           narrow,synthetic,trajectory]

--parts runs only those parts (all by default, when the 512-wide step
must launch every width-dependent kernel).  Prints the
build time, the card's name and power limit, the phase's lines and the
total time; exits non-zero when a part fails.
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PARTS = ("kernels", "padded", "times", "train", "narrow", "synthetic",
         "trajectory")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parts", default=",".join(PARTS))
    parts = set(ap.parse_args().parts.split(","))
    import torch
    import chip_smoke as cs
    from simulst_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("widths_smoke: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    print("build_s", time.perf_counter() - t0, flush=True)
    print(cs.gpu_name_and_power_limit(), flush=True)
    batch = cs.asr_batch(dev)
    with tempfile.TemporaryDirectory() as work:
        if parts == set(PARTS):
            cs.phase_widths(dev, batch, work)
        else:
            with torch.no_grad():
                if "kernels" in parts:
                    cs.phase_width_kernels(dev)
                if "padded" in parts:
                    cs.phase_width_kernels(dev, padded=True)
                if "times" in parts:
                    for key in cs.WIDTH_TIMED:
                        cs.phase_width_times(dev, batch, key)
            if "train" in parts:
                cs.phase_width_train(dev, batch)
            if "narrow" in parts:
                cs.phase_width_streaming_cif(dev)
            if "synthetic" in parts:
                cs.phase_synthetic(work)
            if "trajectory" in parts:
                cs.phase_convergence(dev)
    print("total_s", time.perf_counter() - t0, flush=True)


if __name__ == "__main__":
    main()
