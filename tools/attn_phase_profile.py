"""Cycles per phase of the grouped-attention kernels (csrc/emformer_attn.cu,
fp32, and the bf16 backward on the tensor cores, csrc/emformer_attn_bwd.cu)
at chip_smoke.py's train shape, q3 (32, 2, 200, 256), rates 0 and 0.1.

Copies the package into simulst_tpu_torch/_build/phase_profile/, puts
clock64() probes between the kernels' phases (thread 0 of each block adds
each phase's cycles, after a block-wide barrier, to a device counter),
builds that copy and prints the mean cycles per block of each phase (the
tensor-core backward's summed over a block's segment units).  The
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
extern "C" int SIMULST_PHASES(unsigned long long* host, int reset) {
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
    ("  const float scale = 1.0f / sqrtf((float)(kExact ? kHeadDim : "
     "g.hd_real));\n  for (int r0", "  PHASE(0);\n"),
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
# the same for csrc/emformer_attn_bwd.cu's kernel
TC_MARKS = [
    ("  columns(0, 0);\n  stage(0, 0);", "  PHASE_T0\n"),
    ("    const bf16* qs = stages + s * stage_elems;", "    PHASE(0);\n"),
    ("      // the quarter's row max, sum of e", "      PHASE(1);\n"),
    ("      // the row's max M, sum S and Delta over", "      PHASE(2);\n"),
    ("    // dQ = dS K: 16 rows x 16 features an item", "    PHASE(3);\n"),
    ("    // dK = dS^T Q and dV = (P m)^T dO", "    PHASE(4);\n"),
    ("  }\n  __syncthreads();   // the last unit's dK / dV are in",
     "    PHASE(5);\n"),
]
TC_END = "    put(out_of(c), f, pk[0], pk[1], pv[0], pv[1]);\n  }\n}"
TC_NAMES = {0: "the wait for the unit's rows, the next unit's tables and "
               "copies",
            1: "S and dP products", 2: "softmax statistics (quarters)",
            3: "p, ds and round(p m) into shared memory", 4: "dQ = dS K",
            5: "dK, dV and their slots", 6: "memory slots written"}
NAMES = {0: "forward staging", 1: "forward scores",
         2: "forward row softmax", 3: "forward P.V",
         4: "backward staging", 5: "backward scores and dO.v",
         6: "backward row softmax and ds", 7: "backward dq and probs",
         8: "backward dK / dV walks"}


def _probe(src, entry, marks, end, end_phase):
    """Put the probes (their C entry named `entry`) into source `src`."""
    probes = PROBES.replace("SIMULST_PHASES", entry).replace(
        "g_phase", f"{entry}_counts")   # a device symbol of each source
    text = src.read_text().replace("namespace {\n", probes, 1)
    for mark, probe in marks + [(end, "")]:
        if text.count(mark) != 1:
            raise SystemExit(f"attn_phase_profile: {mark!r} is not in "
                             f"{src.name} once; update its marks")
        if probe:
            text = text.replace(mark, probe + mark)
    text = text.replace(end, end[:-1] + f"  PHASE({end_phase});\n}}")
    src.write_text(text)


def instrumented_copy():
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "simulst_tpu_torch", COPY / "simulst_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = COPY / "simulst_tpu_torch" / "csrc"
    _probe(csrc / "emformer_attn.cu", "simulst_attn_phases", MARKS, FWD_END,
           3)
    _probe(csrc / "emformer_attn_bwd.cu", "simulst_attn_tc_phases",
           TC_MARKS, TC_END, 6)


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
    # the bf16 backward on the tensor cores, on the same inputs in bf16
    bf = tuple(t.bfloat16() for t in args[:3]) + args[3:]
    for rate in (0.0, 0.1):
        for reset in (True, False):
            lib.simulst_attn_tc_phases(counts, 1)
            ea.emformer_grouped_attention_backward(*bf, dout.bfloat16(), geom,
                                                   rate, 5)
            torch.cuda.synchronize()
        lib.simulst_attn_tc_phases(counts, 0)
        print(json.dumps({"rate": rate, "bf16 tensor-core backward":
                          {"cycles_per_block": {
                              name: counts[i] / blocks["backward"]
                              for i, name in TC_NAMES.items()}}}),
              flush=True)


if __name__ == "__main__":
    main()
