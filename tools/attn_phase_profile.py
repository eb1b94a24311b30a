"""Cycles per phase of the grouped-attention kernels (csrc/emformer_attn.cu)
at chip_smoke.py's train shape, q3 (32, 2, 200, 256), rates 0 and 0.1.

Copies the package into simulst_tpu_torch/_build/phase_profile/, puts
clock64() probes between the kernels' phases (thread 0 of each block adds
each phase's cycles, after a block-wide barrier, to a device counter),
builds that copy and prints the mean cycles per block of each phase.  The
barriers it adds cost a little, so the phases sum to slightly more than an
unprobed launch.  Needs the card; from the repository root:

    python3 tools/attn_phase_profile.py
"""
import ctypes
import json
import os
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
COPY = ROOT / "simulst_tpu_torch" / "_build" / "phase_profile"

PROBES = """__device__ unsigned long long g_phase[16];
extern "C" int simulst_attn_phases(unsigned long long* host, int reset) {
  unsigned long long zero[16] = {0};
  return (int)(reset ? cudaMemcpyToSymbol(g_phase, zero, sizeof(zero))
                     : cudaMemcpyFromSymbol(host, g_phase, sizeof(zero)));
}
#define PHASE_T0 long long phase_t = clock64();
#define PHASE(k)                                                        \\
  do {                                                                  \\
    __syncthreads();                                                    \\
    if (threadIdx.x == 0) {                                             \\
      const long long t = clock64();                                    \\
      atomicAdd(&g_phase[k], (unsigned long long)(t - phase_t));        \\
      phase_t = t;                                                      \\
    }                                                                   \\
  } while (0)
namespace {
"""
# (text in csrc/emformer_attn.cu, text to put before it); each must occur once
MARKS = [
    ("  __syncthreads();\n  const auto q_off", "  PHASE_T0\n"),
    ("  const float scale = 1.0f / sqrtf((float)g.hd);\n  for (int r0",
     "  PHASE(0);\n"),
    ("  // the row softmax, a warp on", "  PHASE(1);\n"),
    ("  const int jn = (g.C + 3) & ~3;  // columns past C hold zeros",
     "  PHASE(2);\n"),
    ("  for (int i = 0; i < g.G; ++i) {\n    unit_columns", "  PHASE_T0\n"),
    ("    // scores and dO . v", "    PHASE(4);\n"),
    ("    // per row, a warp on kBwdRows", "    PHASE(5);\n"),
    ("    // dq = ds K, straight into", "    PHASE(6);\n"),
    ("    __syncthreads();  // the next segment restages the tiles",
     "    PHASE(7);\n"),
    # (one block of dK / dV features at head dim 64: one walk per block)
    ("    // this block's features of the group's (ctx, dim) fp32 partials",
     "    PHASE(8);\n"),
]
FWD_END = ("          store4(out + q_off(r) + fb + 4 * tx, o[a]);\n"
           "      }\n    }\n}")
NAMES = {0: "forward staging", 1: "forward scores",
         2: "forward row softmax", 3: "forward P.V",
         4: "backward staging", 5: "backward scores and dO.v",
         6: "backward row softmax and ds", 7: "backward dq and probs",
         8: "backward dK / dV walks"}


def instrumented_copy():
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "simulst_tpu_torch", COPY / "simulst_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = COPY / "simulst_tpu_torch" / "csrc" / "emformer_attn.cu"
    text = src.read_text().replace("namespace {\n", PROBES, 1)
    for mark, probe in MARKS + [(FWD_END, "")]:
        if text.count(mark) != 1:
            raise SystemExit(f"attn_phase_profile: {mark!r} is not in the "
                             "kernel source once; update MARKS")
        if probe:
            text = text.replace(mark, probe + mark)
    text = text.replace(FWD_END, FWD_END[:-1] + "  PHASE(3);\n}")
    src.write_text(text)


def main():
    instrumented_copy()
    sys.path.insert(0, str(COPY))
    sys.path.insert(1, str(ROOT))
    import torch
    import chip_smoke as cs
    from simulst_tpu_torch.ops import _build
    from simulst_tpu_torch.ops import emformer_attn as ea
    print(cs.gpu_name_and_power_limit(), flush=True)
    lib = ctypes.CDLL(str(_build.build()))
    counts = (ctypes.c_ulonglong * 16)()
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(cs.SEED)
    geom = ea.AttnGeom(U=256, seg=16, lc=32, rc=8, max_mem=5, G=8,
                       num_heads=4)
    b, d = cs.ASR_UTT, 256

    def randn(*shape):
        return torch.randn(shape, generator=g).to(dev)

    q3, dout = randn(b, geom.ng, geom.nq, d), randn(b, geom.ng, geom.nq, d)
    k, v = randn(b, geom.tk, d), randn(b, geom.tk, d)
    lengths = torch.randint(180, 257, (b,), generator=g).to(
        device=dev, dtype=torch.int32)
    args = (q3, k, v, lengths)
    blocks = {"forward": b * geom.ng * geom.num_heads * geom.G,
              "backward": b * geom.ng * geom.num_heads}
    for rate in (0.0, 0.1):
        for reset in (True, False):  # a warm-up launch, then the counted one
            lib.simulst_attn_phases(counts, 1)
            ea.emformer_grouped_attention_forward(*args, geom, rate, 5)
            ea.emformer_grouped_attention_backward(*args, dout, geom, rate, 5)
            torch.cuda.synchronize()
        lib.simulst_attn_phases(counts, 0)
        print(json.dumps({"rate": rate, "cycles_per_block": {
            name: counts[i] / blocks[name.split()[0]]
            for i, name in NAMES.items()}}), flush=True)


if __name__ == "__main__":
    main()
