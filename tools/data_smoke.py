"""chip_smoke.py's phase 19 (data to score) with only the batches it reads:
phase 7's ASR batch and phase 3's offline batch; then
`chip_smoke.phase_data`.  Needs the card; from the repository root:

    python3 tools/data_smoke.py

Prints the build time, the card's name and power limit, the phase's lines
and the total time; exits non-zero when the phase fails.
"""
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import numpy as np
    import torch
    import chip_smoke as cs
    from simulst_tpu_torch.ops import _build
    from simulst_tpu_torch.ops.fbank import fbank_batch, utterance_cmvn

    if not torch.cuda.is_available():
        raise SystemExit("data_smoke: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    print("build_s", time.perf_counter() - t0, flush=True)
    print(cs.gpu_name_and_power_limit(), flush=True)
    with tempfile.TemporaryDirectory() as work:
        asr = cs.asr_batch(dev)
        with torch.no_grad():
            wavs = torch.from_numpy(cs.synthetic_audio(
                np.random.RandomState(cs.SEED), cs.N_UTT,
                cs.N_FRAMES)).to(dev)
            speech = {"feats": utterance_cmvn(fbank_batch(wavs)),
                      "feat_lengths": torch.full((cs.N_UTT,), cs.N_FRAMES,
                                                 dtype=torch.int64,
                                                 device=dev)}
        launches = cs.phase_data(dev, work, asr, speech, {})
    print("launches", launches, flush=True)
    print("total_s", time.perf_counter() - t0, flush=True)


if __name__ == "__main__":
    main()
