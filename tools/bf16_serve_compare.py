"""bf16 serving of one checkout, for comparing two trees in one call:
phase 3's batch and its fp32 beam-5 tokens, made as tools/bf16_smoke.py
makes them, then that checkout's `chip_smoke.phase_bf16_serve` (beam 5
per batch, the streaming chunk at B = 1) under torch.no_grad.  Needs the
card; from the repository root, with another checkout unpacked in a
directory that .gitignore lists, in turns:

    python3 tools/bf16_serve_compare.py archive_check/parent
    python3 tools/bf16_serve_compare.py .

Prints the checkout, the card's name and power limit, phase 20's
"serving bf16" line and the seconds it took.
"""
import os
import sys
import time


def main(root):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch
    import chip_smoke as cs
    from simulst_tpu_torch.cli.generate import decode_batch
    from simulst_tpu_torch.decode.beam import BeamConfig
    from simulst_tpu_torch.models import s2t_emformer as s2t
    from simulst_tpu_torch.ops import _build
    from simulst_tpu_torch.ops.fbank import fbank_batch, utterance_cmvn

    if not torch.cuda.is_available():
        raise SystemExit("bf16_serve_compare: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build()
    _build.library()
    print("tree", root, cs.gpu_name_and_power_limit(), flush=True)
    with torch.no_grad():
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
        t0 = time.perf_counter()
        cs.phase_bf16_serve(dev, speech, tokens)
        print("serve_s", time.perf_counter() - t0, flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else ".")
