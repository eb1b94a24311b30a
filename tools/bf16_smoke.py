"""chip_smoke.py's phase 20 (bf16 compute, remat and the model options)
with only the phases it reads: phase 3's offline batch and its fp32
beam-5 tokens, phase 7's batch and phase 8's fp32 ASR training steps
(their own checks included), whose numbers phase 20 prints beside its
bf16 ones; then `chip_smoke.phase_bf16`.  Needs the card; from the
repository root:

    python3 tools/bf16_smoke.py

Prints the build time, the card's name and power limit, the phases' lines
and the total time; exits non-zero when a phase fails.
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
    from simulst_tpu_torch.cli.generate import decode_batch
    from simulst_tpu_torch.decode.beam import BeamConfig
    from simulst_tpu_torch.models import s2t_emformer as s2t
    from simulst_tpu_torch.ops import _build
    from simulst_tpu_torch.ops.fbank import fbank_batch, utterance_cmvn

    if not torch.cuda.is_available():
        raise SystemExit("bf16_smoke: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    print("build_s", time.perf_counter() - t0, flush=True)
    print(cs.gpu_name_and_power_limit(), flush=True)
    with torch.inference_mode():
        wavs = torch.from_numpy(cs.synthetic_audio(
            np.random.RandomState(cs.SEED), cs.N_UTT, cs.N_FRAMES)).to(dev)
        speech = {"feats": utterance_cmvn(fbank_batch(wavs)),
                  "feat_lengths": torch.full((cs.N_UTT,), cs.N_FRAMES,
                                             dtype=torch.int64, device=dev)}
        model = s2t.S2TEmformerModel(
            s2t.S2TEmformerConfig(),
            generator=torch.Generator().manual_seed(cs.SEED), device=dev)
        model.eval()
        tokens, _ = decode_batch(model, speech, BeamConfig(
            beam_size=cs.BEAM, max_len=cs.MAX_LEN))
        del model
    with tempfile.TemporaryDirectory() as work:
        asr = cs.asr_batch(dev)
        _, _, fp32 = cs.phase_asr_train(
            dev, asr, os.path.join(work, "asr_checkpoint_last"))
        cs.phase_bf16(dev, asr, speech, tokens, fp32)
    print("total_s", time.perf_counter() - t0, flush=True)


if __name__ == "__main__":
    main()
