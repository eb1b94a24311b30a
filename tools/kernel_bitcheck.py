"""Bit-for-bit check of two builds of the CUDA kernels on the card: this
checkout's `simulst_tpu_torch/csrc/` against that of another git revision.

The revision's sources (read with `git show REV:simulst_tpu_torch/csrc/...`)
are built, with the same nvcc flags, into
`simulst_tpu_torch/_build/bitcheck_<REV>/` beside the current build; both
libraries are loaded, the same C entries of both run on the same seeded
inputs, and each output is compared with torch.equal:

  simulst_ffn            y of ln_res 1 (fused_ln_ffn_res) and ln_res 0
                         (fused_ffn), this checkout's entry called twice,
                         on its fused row-block path and on its tiled path
                         (each call with its own build's C signature and
                         scratch: a revision without the tiled path takes
                         no xn / h, one before the bf16 tensor-core path
                         fp32 ones); fp32 and bf16, gelu and relu, dropout
                         0 and 0.1, at 1, 24, 40, 300, 3072, 4,133, 8192 and
                         12,288 rows (D 256, FFN 2048).  The bf16 tiled
                         path (its products on the tensor cores) is held
                         to the plain version at chip_smoke's
                         BF16_TOL instead, its largest differences from the
                         plain version and from the revision printed beside
                         it; where the revision's tiled path runs on the
                         tensor cores too, both bf16 paths are held to the
                         revision's, bit for bit
  simulst_ffn_bwd        dx, dW1, db1, dW2, db2, each build's C entry
                         called with its own signature and scratch (a
                         revision before the bf16 tensor-core backward
                         takes no h_d and dh and fp32 du, g), at the same
                         cases; bf16 (the five products on the tensor
                         cores) held to the plain version at BF16_TOL
                         (weight and bias gradients within 1e-2 of their
                         largest entry; relu under this build's relu mask,
                         chip_smoke.kernel_ffn_relu_mask), the largest
                         differences printed beside it
  simulst_ln_ffn_bwd     dx, dgamma, dbeta, dW1, db1, dW2, db2, each
                         build's C entry called with its own signature and
                         scratch (a revision before the bf16 tensor-core
                         path takes no h_d and fp32 xn, g, du, one before
                         its hidden-gradient pass no dh); fp32 and
                         bf16, gelu and relu, dropout 0 and 0.1, at 1, 300,
                         4,133 and 12,288 rows (bf16 LN parameters: each
                         build takes them in its own dtype, fp32 from the
                         build whose LN-FFN reads fp32 ones, with the same
                         values).  bf16 (the five products on the tensor
                         cores) is held to the plain version at BF16_TOL
                         (weight and LN gradients within 1e-2 of their
                         largest entry; relu under this build's relu mask,
                         chip_smoke.kernel_relu_mask) and, where the
                         revision's products run on the tensor cores too,
                         to the revision's bit for bit, the largest
                         differences printed beside it
  simulst_cif_integrate  out and delays at the shapes of
                         tests/test_torch_port_cuda.py's CIF cases (a
                         revision whose entry takes cprev gets csum - alpha
                         from torch, one rounding, as its wrapper computed
                         it)
  simulst_linear_res_bwd dh, dW, db, each build's C entry with its own
                         scratch (du fp32 in a revision before the bf16
                         tensor-core backward, of the activation dtype
                         since); fp32 and bf16, dropout 0 and 0.1, every
                         row a residual row and the Emformer
                         out-projection's gate (period 200, 192 residual
                         rows), at 1, 24, 300, 2,304, 8192 and 12,800 rows
                         (256 x 256); bf16 (both products on the tensor
                         cores) held to the plain version at BF16_TOL
  simulst_linear_res     y, this checkout's entry called on each of its
                         paths (the row kernel and the two tiled ones) and
                         the revision's with its own C signature (one
                         without the path argument takes none, one before
                         the bf16 tiled paths' fp32 scratch no u); fp32
                         and bf16, dropout 0 and 0.1, period 0 and the
                         Emformer gate 200 / 192, at 1, 24, 40, 300,
                         2,304, 3,200, 8192 and 12,800 rows (256 x 256).
                         The bf16 tiled paths (the product on the tensor
                         cores, then the epilogue pass) are held to the
                         plain version at BF16_TOL and to each other bit
                         for bit, their largest differences from the plain
                         version and the revision printed; the row kernel
                         to the revision bit for bit
  simulst_mha_fwd        out and lse, this checkout's entry on both of its
                         kernels (decode and training tiles), the
                         revision's with its own signature; fp32 and bf16,
                         dropout 0 and 0.1, at the MHA_CASES below and the
                         decoder step's Tq = 1 cross-attention (40, 1, 256,
                         ragged, one row all masked), the self-attention
                         cache's (40, 1, 64) and a multi-row decode (5, 6,
                         77) causal
  simulst_mha_bwd        dq, dk, dv, each revision's entry called with its
                         own C signature (a revision without the delta / dS
                         scratch takes none), on this checkout's forward;
                         fp32 and bf16, dropout 0 and 0.1, at the MT shapes
                         (B 64, Tq = Tk = 128: causal decoder self, encoder
                         self, cross with ragged key masks), the ASR
                         decoder's (32, 72, 72) causal and (32, 72, 256),
                         and (3, 50, 77) causal and not, with one row's keys
                         all masked
  simulst_alignment_fwd  alphas, each revision's C entry on the same
                         seeded panels (chip_smoke.alignment_panels): the
                         MMA recipe's pooled (N, U, S) = (128, 72, 32),
                         unpooled (128, 72, 256), ragged (128, 1, 29), S 1,
                         S 33 (two groups, one lane of the second), S 200,
                         S 257 and (7, 5, 700) (more than one 256-wide
                         tile), U 2 and wait-k's one-hot rows (128, 72, 32)
  simulst_alignment_bwd  d_prefix and d_denom at the same cases, on the
                         revision's alphas, each revision's C entry called
                         with its own signature (a revision with the (N, S)
                         carry scratch takes it)
  simulst_emformer_attn  the grouped attention's out and (simulst_emformer_
  _bwd                   attn_bwd) dq, dk, dv through ops/emformer_attn.py's
                         wrappers; fp32 and bf16, dropout 0 and 0.1, with
                         and without the example-id gate, at ATTN_CASES.
                         The bf16 backward, on the tensor cores
                         (simulst_emformer_attn_bwd_tc, `bwd_plan`), is
                         held to the plain version (dq at BF16_TOL, dk
                         and dv within 1e-2 of their largest entry), its
                         largest differences from the revision printed; a
                         revision without that entry runs its units
                         backward (`library_of`)
  simulst_convpos_wgrad  dw through ops/conv_pos.py's wrapper; fp32 and
                         bf16, K 64, D 256, at (B, T) = (32, 256), (3, 50),
                         (33, 1) (7 batch slices of 5, the last of 3) and
                         (5, 300)
  simulst_ctc_alpha      alphas, each revision's C entry, at CTC_CASES: the
                         ASR recipe's (T, B, S) = (256, 32, 129) with
                         lengths 192-256, the card test's (60, 4, 17) with
                         an example whose target cannot fit its frames and
                         frames past the input length, S 33, 65, 257 and
                         1023, and T 1 (one warp at S 17; halo warps, one
                         exchange every 4 steps, at S 33-257; an exchange
                         every step at S 1023)
  simulst_ctc_d_em       d_em at the same cases on the revision's alphas,
                         on the same block shapes; then both above S 1024
                         (CTC_WIDE_CASES: S 1025 and 2049, 2 and 4 states
                         a thread), this checkout alone, held to the plain
                         DP (finite entries within F32_TOL, the -1e30
                         sentinels equal)

Then a determinism check of this checkout alone: every C entry, through
its wrapper, runs twice on the same inputs at a train shape (the two
forwards also at a decoder-step shape, on their other path; the bf16
grouped-attention backward dense and gated, and the bf16 linear-res
forward's tiled path, on the tensor cores), and each
output of the second call must equal the first's (torch.equal).  Then the
widths the revision may not take (WIDTH_CASES), this checkout alone: the
FFN forward's fused and tiled paths at D 64, 128 and 512 (1, 40 and 300
rows, both ln_res, fp32 and bf16, rate 0.1; in bf16 within BF16_TOL of
each other, the tiled products on the tensor cores) and the MHA forward's
decode and training kernels at head dims 16, 32, 96 and 128 (Tq 1 and 2
over 77 keys, causal and not) must give the same bits, and the FFN,
LN-FFN, MHA, grouped-attention and conv-pos entries the same bits twice
at D 64 to 2048 (the walking LN rows from 1280), head dims 16 to 256 (the
grouped backward's split dK / dV walks at 128, the wide kernels at 160
and 256) and 4, 64, 96, 128 and 1 channels per group.  The determinism
check adds the bf16 LN-FFN forward (tiled) and backward.
A revision whose C entries take no real widths (the widths of a call
zero-padded to the kernels' widths: `REAL_WIDTH_ARGS`) is called with
this checkout's argument lists less those arguments, which equal the
padded widths at every width such a revision takes.  The width cases add
D 16, 48 and 200 (hidden 32, 48 and 800) and head dims 4, 12, 50 and
100, which reach the kernels padded.
--only ENTRY[,ENTRY...] restricts the bit check, and --time, to those
entries.

With --time it also times both builds in one process, in turns (revision,
this checkout, this checkout, revision), with CUDA events: the LN-FFN
forward at 12,288 rows (gelu, rate 0.1) and the FFN forward at 8192 rows
(relu, rate 0.1), the revision's C entry against this checkout's on the
path its wrapper takes, and both again in bf16 (rows 1 / 1b: this
checkout's products on the tensor cores, a revision's on the CUDA cores,
the LN-FFN backward through each build's C entry); the linear-res
forward's C entry at 8192 rows,
12,800 and 3,200 rows with the Emformer gate, 2,304, 40 and 1 rows, and
the grouped attention forward and backward through the wrappers at
chip_smoke.py's ASR shape (q3 (32, 2, 200, 256), rate 0.1), the MHA
forward's at the MT shapes (64, 128, 128) causal, self and cross,
the ASR decoder's (32, 72, 72) causal and (32, 72, 256), the decoder
step's (40, 1, 256) and the self-cache (40, 1, 64), all rate 0.1 (the
decoder step 0), this checkout's on the path its plan picks, and in bf16
at its tiled rows (row 4: this checkout's product on the tensor cores);
the grouped attention backward in bf16 (rows 3b / 3bg: this checkout's
on the tensor cores) at the ASR shape and at asr-pack's packed rows
(16, 4, 175, 256) with the gate at G 7; the FFN backward's C entry at 8192 rows (relu,
rate 0.1), and in bf16 at 2,304 (gelu) and 8192 rows (relu), and the
LN-FFN backward at 12,288 rows (gelu, rate 0.1) through the wrappers;
the CIF C entry at (32, 256, 256, 72); the linear-res backward's C entry
at 8192 rows, 12,800 rows with the Emformer gate and 2,304 rows (rate
0.1), fp32 and bf16; the MHA backward's C entry at the MT shape (64,
128, 128) causal and the ASR decoder's (32, 72, 72) causal and (32, 72,
256), rate 0.1; the alignment forward's and backward's C entries at the
pooled (128, 72, 32), unpooled (128, 72, 256) and S 257 (two tiles)
shapes; the conv-pos weight gradient's C entry at xp (32, 319, 256), dy
(32, 256, 256); the CTC alpha's and d_em's C entries at the ASR shape
(256, 32, 129).  Then each build's
device time per call by kernel (torch.profiler), and this checkout's
forward on both of its paths from 24 to 3072 rows (fp32, dropout 0: the
serving and offline row counts), which places ops/ffn.py's TILED_MIN_ROWS,
and in bf16 (BF16_TILED_MIN_ROWS),
the linear-res forward on each path from 1 to 12,800 rows (fp32, rate
0.1), which places ops/linear_res.py's TILED_MIN_ROWS and WIDE_MIN_ROWS,
and the MHA forward on both kernels at Tq 1 to 64 over 256 keys (B 40,
rate 0) and at the timed shapes, which places ops/mha.py's
DECODE_MAX_TQ; the alpha's and d_em's C entries of both builds, in
turns, at S 33, 65, 129, 257 and 1023 (T 256, B 32), this checkout's
alone at S 1025 and 2049; and the CTC
recursions' chain floor (chip_smoke.ctc_chain_floor: one warp's T
dependent LSE pairs on registers, with and without the two shuffles).

On a machine with the card, from the repository root:

    python3 tools/kernel_bitcheck.py --rev REV [--time] [--only ENTRIES]

A copy without git (the card machine's) reads the sources that
`python3 tools/kernel_bitcheck.py --rev REV --export` wrote there
beforehand, in a git checkout, without building.  Prints the card's name
and power limit, one JSON line per case and a summary line; exits 1 if
any output differs or any C entry is not deterministic.
"""
import argparse
import concurrent.futures
import contextlib
import ctypes
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CSRC = "simulst_tpu_torch/csrc"
LN_ROWS = (1, 300, 4133, 12288)
FFN_ROWS = (1, 24, 40, 300, 3072, 4133, 8192, 12288)
CROSSOVER_ROWS = (24, 40, 128, 256, 384, 512, 544, 768, 1024, 3072)
# (label, B, S, C, T, beta, how alpha is made)
CIF_CASES = (
    ("cif-train (32,256,256,65)", 32, 256, 256, 65, 1.0, "sigmoid"),
    ("train (32,256,256,72)", 32, 256, 256, 72, 1.0, "sigmoid"),
    ("stream (1,17,256,19)", 1, 17, 256, 19, 1.0, "sigmoid"),
    ("ragged (4,29,256,1)", 4, 29, 256, 1, 1.0, "sigmoid"),
    ("long (2,512,256,300)", 2, 512, 256, 300, 1.0, "sigmoid"),
    ("beta 0.8 (8,256,256,80)", 8, 256, 256, 80, 0.8, "sigmoid"),
    ("C 300 (3,40,300,12)", 3, 40, 300, 12, 1.0, "sigmoid"),
    ("three buckets (4,64,256,40)", 4, 64, 256, 40, 1.0, "wide"),
    ("T > S (2,12,256,40)", 2, 12, 256, 40, 1.0, "t_over_s"),
    ("zero runs (4,128,256,48)", 4, 128, 256, 48, 1.0, "zero_runs"),
    ("S 1100 (2,1100,256,300)", 2, 1100, 256, 300, 1.0, "sigmoid"),
    ("C 130 (3,40,130,12)", 3, 40, 130, 12, 1.0, "sigmoid"),
    ("csum dips one ulp (2,64,256,24)", 2, 64, 256, 24, 1.0, "dip"),
)


LR_ROWS = (1, 24, 300, 2304, 8192, 12800)
# (period, residual rows): every row a residual row (the decoder), and the
# Emformer out-projection's gate at s2t_emformer_s (groups of 8 segments:
# 8 x (rc 8 + seg 16) residual rows, then 8 summary rows)
LR_GATES = ((0, 0), (200, 192))
# (label, B, Tq, Tk, causal, key mask): "full", "ragged" (lengths from Tk /
# 2 to Tk) or "masked row" (ragged, and example 1 sees no key)
MHA_CASES = (
    ("MT decoder self (64,128,128) causal", 64, 128, 128, True, "ragged"),
    ("MT encoder self (64,128,128)", 64, 128, 128, False, "full"),
    ("MT cross (64,128,128) ragged", 64, 128, 128, False, "masked row"),
    ("ASR decoder self (32,72,72) causal", 32, 72, 72, True, "ragged"),
    ("ASR cross (32,72,256)", 32, 72, 256, False, "ragged"),
    ("odd (3,50,77) causal", 3, 50, 77, True, "masked row"),
    ("odd (3,50,77)", 3, 50, 77, False, "masked row"),
)
MHA_TIMED = {"mha_bwd_mt_ms": 0, "mha_bwd_asr_self_ms": 3,
             "mha_bwd_asr_cross_ms": 4}
# the forward's further cases: the decoder step (Tq 1), cross-attention
# over 256 encoder frames and self-attention over a 64-slot cache, and
# rows of one head shared by a decode block
MHA_FWD_CASES = MHA_CASES + (
    ("decoder step cross (40,1,256)", 40, 1, 256, False, "masked row"),
    ("decoder step self cache (40,1,64)", 40, 1, 64, False, "ragged"),
    ("decode rows (5,6,77) causal", 5, 6, 77, True, "masked row"),
)
# name -> (index in MHA_FWD_CASES, rate)
MHA_FWD_TIMED = {"mha_fwd_mt_ms": (0, 0.1), "mha_fwd_mt_self_ms": (1, 0.1),
                 "mha_fwd_mt_cross_ms": (2, 0.1),
                 "mha_fwd_asr_self_ms": (3, 0.1),
                 "mha_fwd_asr_cross_ms": (4, 0.1),
                 "mha_fwd_step_cross_ms": (7, 0.0),
                 "mha_fwd_step_self_ms": (8, 0.0)}
LR_FWD_ROWS = (1, 24, 40, 300, 2304, 3200, 8192, 12800)
# name -> (rows, period, residual rows)
LR_FWD_TIMED = {"linear_res_8192_ms": (8192, 0, 0),
                "linear_res_12800_gate_ms": (12800, 200, 192),
                "linear_res_3200_gate_ms": (3200, 200, 192),
                "linear_res_2304_ms": (2304, 0, 0),
                "linear_res_40_ms": (40, 0, 0), "linear_res_1_ms": (1, 0, 0)}
LR_CROSSOVER_ROWS = (1, 24, 40, 64, 128, 256, 512, 1024, 1536, 2048, 2304,
                     3200, 8192, 12800)
MHA_CROSSOVER_TQ = (1, 2, 4, 8, 12, 16, 32, 64)
# (label, N, U, S, wait-k's one-hot rows)
ALIGN_CASES = (
    ("pooled (128,72,32)", 128, 72, 32, False),
    ("unpooled (128,72,256)", 128, 72, 256, False),
    ("ragged (128,1,29)", 128, 1, 29, False),
    ("S 1 (128,72,1)", 128, 72, 1, False),
    ("S 33 (128,72,33)", 128, 72, 33, False),
    ("S 200 (128,72,200)", 128, 72, 200, False),
    ("S 257 (128,72,257)", 128, 72, 257, False),
    ("S 700 (7,5,700)", 7, 5, 700, False),
    ("U 2 (128,2,32)", 128, 2, 32, False),
    ("waitk one-hot (128,72,32)", 128, 72, 32, True),
)
ALIGN_TIMED = {"alignment_{}_pooled_ms": 0, "alignment_{}_unpooled_ms": 1,
               "alignment_{}_s257_ms": 6}
# (B, T) of the conv-pos weight gradient at K 64, D 256
CONVPOS_CASES = ((32, 256), (3, 50), (33, 1), (5, 300))
# (B, AttnGeom fields) of the grouped attention's bit check (4 heads of
# 64): s2t_emformer_s's geometry and a small one (rc 4, seg 8, 3 memory
# slots)
ATTN_CASES = ((8, dict(U=256, seg=16, lc=32, rc=8, max_mem=5, G=8,
                       num_heads=4)),
              (3, dict(U=32, seg=8, lc=16, rc=4, max_mem=3, G=2,
                       num_heads=4)))
# (label, T, B, S, how the lengths are made)
CTC_CASES = (
    ("ASR (256,32,129)", 256, 32, 129, "asr"),
    ("card test (60,4,17)", 60, 4, 17, "card"),
    ("S 33 (100,8,33)", 100, 8, 33, "ragged"),
    ("S 65 (100,8,65)", 100, 8, 65, "ragged"),
    ("S 257 (300,4,257)", 300, 4, 257, "ragged"),
    ("S 1023 (600,2,1023)", 600, 2, 1023, "ragged"),
    ("T 1 (1,4,17)", 1, 4, 17, "ragged"),
)
D_EM_TIMED_S = (33, 65, 129, 257, 1023)
# above S 1024 (2 and 4 states a thread): this checkout alone, vs plain
# (the frames leave room for every target: posteriors to compare)
CTC_WIDE_CASES = (
    ("S 1025 (1400,2,1025)", 1400, 2, 1025, "ragged"),
    ("S 2049 (2600,2,2049)", 2600, 2, 2049, "ragged"),
)
CTC_WIDE_TIMED_S = (1025, 2049)
# timed name prefix -> the C entry it times (first match)
TIMED_ENTRIES = (("ln_ffn_fwd", "simulst_ffn"), ("ffn_fwd", "simulst_ffn"),
                 ("ffn_bwd", "simulst_ffn_bwd"),
                 ("ln_ffn_bwd", "simulst_ln_ffn_bwd"),
                 ("cif", "simulst_cif_integrate"),
                 ("linear_res_bwd", "simulst_linear_res_bwd"),
                 ("linear_res", "simulst_linear_res"),
                 ("mha_bwd", "simulst_mha_bwd"),
                 ("mha_fwd", "simulst_mha_fwd"),
                 ("emformer_attn_fwd", "simulst_emformer_attn"),
                 ("emformer_attn_bwd", "simulst_emformer_attn_bwd"),
                 ("alignment_fwd", "simulst_alignment_fwd"),
                 ("alignment_bwd", "simulst_alignment_bwd"),
                 ("convpos", "simulst_convpos_wgrad"),
                 ("ctc_alpha", "simulst_ctc_alpha"),
                 ("ctc_d_em", "simulst_ctc_d_em"))


def cif_inputs(torch, b, s, c, how, seed):
    """(x, alpha, csum) on the card, seeded: alpha = sigmoid(noise) with
    row 0's second half zero (padding), as the card tests make it, or one
    of the stressed forms of `how`."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, s, c, generator=g)
    alpha = torch.sigmoid(torch.randn(b, s, generator=g))
    alpha[0, s // 2:] = 0.0
    if how == "wide":            # frames wider than two buckets
        alpha[:, 3::7] = 2.0 + torch.rand(b, len(range(3, s, 7)), generator=g)
    elif how == "t_over_s":      # every frame spans about three buckets
        alpha = 2.5 + torch.rand(b, s, generator=g)
    elif how == "zero_runs":     # zero-weight runs inside rows, a zero row
        alpha[:, 10:30] = 0.0
        alpha[:, 70:75] = 0.0
        alpha[-1] = 0.0
    x, alpha = x.cuda(), alpha.cuda()
    csum = torch.cumsum(alpha, dim=1)
    if how == "dip":             # csum falls by one ulp at a few frames
        for row, k in ((0, 5), (1, 20), (1, 41)):
            csum[row, k] = torch.nextafter(csum[row, k - 1],
                                           torch.tensor(-1.0, device="cuda"))
    return x, alpha, csum


def export(rev, dest):
    """Write REV's csrc/*.cu and *.cuh into dest/csrc."""
    names = subprocess.run(["git", "ls-tree", "--name-only", f"{rev}:{CSRC}"],
                           cwd=ROOT, check=True, capture_output=True,
                           text=True).stdout.split()
    out = dest / "csrc"
    out.mkdir(parents=True, exist_ok=True)
    for name in names:
        if name.endswith((".cu", ".cuh")):
            blob = subprocess.run(["git", "show", f"{rev}:{CSRC}/{name}"],
                                  cwd=ROOT, check=True,
                                  capture_output=True).stdout
            (out / name).write_bytes(blob)
    return out


def source(csrc, name):
    """A source file of `csrc` with every run of whitespace one space, so
    that a signature reads the same however its lines are broken."""
    return " ".join((csrc / name).read_text().split())


def takes_f32_ln(csrc):
    """Whether the build of `csrc` reads the LN-FFN's LN parameters in
    fp32 whatever the activation dtype (before that, in its dtype)."""
    return "const float* __restrict__ ln_g" in source(csrc, "ffn.cu")


def ln_params_for(f32_ln, ws):
    """(ln_g, ln_b, w1, b1, w2, b2) with the LN parameters in the dtype a
    build takes: fp32 (the same values) for one that reads fp32."""
    return (ws[0].float(), ws[1].float(), *ws[2:]) if f32_ln else ws


@contextlib.contextmanager
def ln_check_of(ffn, f32_ln):
    """For a build whose LN-FFN takes its LN parameters in the activation
    dtype, the wrapper's fp32 check is lifted."""
    saved = ffn._check_ln
    if not f32_ln:
        ffn._check_ln = lambda *a: None
    try:
        yield
    finally:
        ffn._check_ln = saved


@contextlib.contextmanager
def library_of(_build, lib):
    """Route the wrappers' launches to `lib`; a build without the bf16
    grouped-attention backward on the tensor cores
    (simulst_emformer_attn_bwd_tc) runs its units backward in bf16 too."""
    from simulst_tpu_torch.ops import emformer_attn as ea
    saved = _build.library, ea.bwd_plan
    _build.library = lambda: lib
    if not hasattr(lib, "simulst_emformer_attn_bwd_tc"):
        ea.bwd_plan = lambda *a: "units"
    try:
        yield
    finally:
        _build.library, ea.bwd_plan = saved


def ln_ffn_inputs(torch, rows, dtype, seed):
    """x, (ln_g, ln_b, w1, b1, w2, b2), dy on the card, seeded."""
    g = torch.Generator().manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).cuda().to(dtype)

    x, dy = randn(rows, 256), randn(rows, 256)
    ws = (1 + randn(256, scale=0.1), randn(256, scale=0.1),
          randn(256, 2048, scale=0.03), randn(2048, scale=0.02),
          randn(2048, 256, scale=0.03), randn(256, scale=0.02))
    return x, ws, dy


def ffn_entry(torch, _build, ffn, lib, takes_scratch, ln_res, act, x, ws,
              rate, tiled, takes_real=True, act_scratch=True):
    """simulst_ffn of `lib` bound to its arguments and called once, with
    its build's signature (takes_scratch: xn and h, null for the fused
    path; takes_real: the real widths; act_scratch: xn and h of the
    activation dtype, else fp32, as builds before the bf16 tensor-core
    path take them); `.y` is the output.  A call costs the host little
    beside the launch, so that CUDA events time the kernels."""
    n = x.shape[0]
    f32 = dict(dtype=torch.float32, device=x.device)
    scratch = dict(dtype=x.dtype if act_scratch else torch.float32,
                   device=x.device)
    plan = ffn.slice_plan(n, 2048, ffn._sm_count(x.device.index), 256)
    y = torch.empty_like(x)
    partial = torch.empty(plan.splits, n, 256, **f32)
    xn = torch.empty(n, 256, **scratch) if tiled and ln_res else None
    h = torch.empty(n, 2048, **scratch) if tiled else None
    scratch = (ffn._ptr(xn), ffn._ptr(h)) if takes_scratch else ()
    call = functools.partial(
        lib.simulst_ffn, _build.dtype_code(x), ln_res,
        ffn.ACTIVATION_CODES[act], x.data_ptr(),
        *(w.data_ptr() for w in ws), y.data_ptr(), partial.data_ptr(),
        *scratch, n, 256, 2048, plan.splits,
        *((256, 2048) if takes_real else ()),
        *ffn._dropout_sites(rate, rate, 29), _build.stream_of(x))
    call.y, call.keep = y, (partial, xn, h, ws)
    if call():
        raise RuntimeError("simulst_ffn: CUDA error")
    return call


def ln_ffn_bwd_entry(torch, _build, lib, takes_hd, takes_dh, x, ws, dy, act,
                     rate, takes_real=True):
    """simulst_ln_ffn_bwd of `lib` bound to its arguments (D 256, hidden
    2048) and called once, with its build's signature and scratch:
    takes_hd, builds since the bf16 tensor-core path, takes h_d apart from
    u and reads xn, g, du and h_d in the activation dtype; a build before
    takes them all in fp32 (h_d overwriting u).  takes_dh, this
    checkout's and later builds', also takes the bf16 path's fp32 dh.
    `.outs` is (dx, dgamma, dbeta, dW1, db1, dW2, db2), the wrapper's
    order."""
    n, d, hid = x.shape[0], 256, 2048
    f32 = dict(dtype=torch.float32, device=x.device)
    act_dtype = dict(dtype=x.dtype if takes_hd else torch.float32,
                     device=x.device)
    o_dw2, o_db1 = d * hid, 2 * d * hid
    o_db2 = o_db1 + hid
    grads = torch.zeros(o_db2 + 3 * d, **f32)
    dx = torch.zeros_like(x)
    from simulst_tpu_torch.ops import ffn
    splits = ffn.slice_plan(n, hid, ffn._sm_count(x.device.index), d,
                            x.dtype).bwd_splits
    xn, g = (torch.empty(n, d, **act_dtype) for _ in range(2))
    dn = torch.empty(n, d, **f32)
    u = torch.empty(n, hid, **f32)
    du = torch.empty(n, hid, **act_dtype)
    hd = torch.empty(n, hid, **act_dtype) if takes_hd else None
    dh = torch.empty(n, hid, **f32) if x.dtype == torch.bfloat16 else None
    stats = torch.empty(n, 2, **f32)
    partial = torch.zeros(splits, grads.numel(), **f32)
    ptrs = [xn, stats, u] + ([hd] if takes_hd else []) + [du, g, dn] + \
        ([dh] if takes_dh else []) + [partial]
    call = functools.partial(
        lib.simulst_ln_ffn_bwd, _build.dtype_code(x),
        ffn.ACTIVATION_CODES[act], x.data_ptr(),
        *(w.data_ptr() for w in ws[:5]), dy.data_ptr(), dx.data_ptr(),
        grads.data_ptr(), *(ffn._ptr(t) for t in ptrs), n, d, hid, splits,
        *((d, hid) if takes_real else ()),
        *ffn._dropout_sites(rate, rate, 29), _build.stream_of(x))
    call.outs = (dx, grads[o_db2 + d:o_db2 + 2 * d],
                 grads[o_db2 + 2 * d:o_db2 + 3 * d],
                 grads[:o_dw2].view(d, hid), grads[o_db1:o_db1 + hid],
                 grads[o_dw2:o_db1].view(hid, d), grads[o_db2:o_db2 + d])
    call.keep = ptrs
    if call():
        raise RuntimeError("simulst_ln_ffn_bwd: CUDA error")
    return call


def ffn_bwd_entry(torch, _build, lib, takes_hd, x, ws, dy, act, rate,
                  takes_real=True):
    """simulst_ffn_bwd of `lib` bound to its arguments (D 256, hidden 2048;
    ws = w1, b1, w2) and called once, with its build's signature and
    scratch: takes_hd, this checkout's and later builds', takes h_d and
    the bf16 path's fp32 dh apart from u and reads g, du and h_d in the
    activation dtype; a build before takes u, du and g in fp32 (h_d
    overwriting u).  `.outs` is (dx, dW1, db1, dW2, db2), the wrapper's
    order."""
    from simulst_tpu_torch.ops import ffn
    n, d, hid = x.shape[0], 256, 2048
    f32 = dict(dtype=torch.float32, device=x.device)
    act_dtype = dict(dtype=x.dtype if takes_hd else torch.float32,
                     device=x.device)
    grads = torch.zeros(2 * d * hid + hid + d, **f32)
    dx = torch.zeros_like(x)
    splits = ffn.slice_plan(n, hid, ffn._sm_count(x.device.index), d,
                            x.dtype).bwd_splits
    u = torch.empty(n, hid, **f32)
    du, g = torch.empty(n, hid, **act_dtype), torch.empty(n, d, **act_dtype)
    bf16 = x.dtype == torch.bfloat16
    hd = torch.empty(n, hid, **act_dtype) if bf16 else u
    dh = torch.empty(n, hid, **f32) if bf16 else None
    ptrs = [u] + ([hd] if takes_hd else []) + [du, g] + \
        ([dh] if takes_hd else [])
    partial = torch.zeros(splits, grads.numel(), **f32)
    call = functools.partial(
        lib.simulst_ffn_bwd, _build.dtype_code(x), ffn.ACTIVATION_CODES[act],
        x.data_ptr(), *(w.data_ptr() for w in ws[:3]), dy.data_ptr(),
        dx.data_ptr(), grads.data_ptr(), *(ffn._ptr(t) for t in ptrs),
        partial.data_ptr(), n, d, hid, splits,
        *((d, hid) if takes_real else ()),
        *ffn._dropout_sites(rate, rate, 29), _build.stream_of(x))
    o_dw2, o_db1 = d * hid, 2 * d * hid
    call.outs = (dx, grads[:o_dw2].view(d, hid), grads[o_db1:o_db1 + hid],
                 grads[o_dw2:o_db1].view(hid, d), grads[o_db1 + hid:])
    call.keep = ptrs + [partial]
    if call():
        raise RuntimeError("simulst_ffn_bwd: CUDA error")
    return call


def linear_res_bwd_entry(torch, _build, lib, act_du, h, w, dy, period,
                         res_rows, rate, takes_real=True):
    """simulst_linear_res_bwd of `lib` bound to its arguments (the
    wrapper's K slices) and called once, with its build's scratch: act_du,
    this checkout's and later builds', takes du of the activation dtype, a
    build before fp32.  `.outs` is (dh, dW, db)."""
    from simulst_tpu_torch.ops import ffn
    n, din = h.shape
    dout = w.shape[1]
    f32 = dict(dtype=torch.float32, device=h.device)
    length = din * dout + dout
    grads, dh = torch.empty(length, **f32), torch.empty_like(h)
    splits = ffn.k_splits(n, -(-din // ffn.WGRAD_TILE)
                          * -(-dout // ffn.WGRAD_TILE), h.device)
    du = torch.empty(n, dout, dtype=h.dtype if act_du else torch.float32,
                     device=h.device)
    partial = torch.zeros(splits, length, **f32)
    call = functools.partial(
        lib.simulst_linear_res_bwd, _build.dtype_code(h), h.data_ptr(),
        w.data_ptr(), dy.data_ptr(), dh.data_ptr(), grads.data_ptr(),
        du.data_ptr(), partial.data_ptr(), n, din, dout,
        *((dout,) if takes_real else ()), period, res_rows, splits,
        *_build.dropout_args(rate, 7), _build.stream_of(h))
    call.outs = (dh, grads[:din * dout].view(din, dout), grads[din * dout:])
    call.keep = (du, partial)
    if call():
        raise RuntimeError("simulst_linear_res_bwd: CUDA error")
    return call


def bf16_close(torch, got, want, weight=False):
    """Within chip_smoke's BF16_TOL of the plain version (weight=True:
    1e-2 of its largest entry, a weight gradient's bound)."""
    import chip_smoke as cs
    got, want = got.float(), want.float()
    if weight:
        return bool((got - want).abs().max() <=
                    1e-2 * want.abs().max())
    return bool(torch.isclose(got, want, **cs.BF16_TOL).all())


def max_diff(a, b):
    return (a.float() - b.float()).abs().max().item()


def mha_inputs(torch, b, tq, tk, mask, dtype, seed):
    """q, k, v, dout (D 256, 4 heads) and the int32 key mask on the card,
    seeded."""
    g = torch.Generator().manual_seed(seed)
    q, dout = (torch.randn(b, tq, 256, generator=g) for _ in range(2))
    k, v = (torch.randn(b, tk, 256, generator=g) for _ in range(2))
    kmask = torch.ones(b, tk, dtype=torch.int32)
    if mask != "full":
        lengths = torch.randint(tk // 2, tk + 1, (b,), generator=g)
        kmask = (torch.arange(tk)[None, :] < lengths[:, None]).to(torch.int32)
    if mask == "masked row":
        kmask[1] = 0
    return [t.to(dtype).cuda() for t in (q, k, v, dout)] + [kmask.cuda()]


def linear_res_entry(torch, _build, lib, takes_path, h, w, b, res, period,
                     res_rows, rate, path, takes_real=True, takes_u=True):
    """simulst_linear_res of `lib` bound to its arguments and called once,
    with its build's signature (takes_path: the path argument; takes_real:
    the real D_out; takes_u: the fp32 scratch of the bf16 tiled paths,
    rows x D_out); `.y` is the output (NaN where the kernel writes
    nothing)."""
    n, dout = res.shape
    y = torch.full_like(res, float("nan"))
    u = torch.empty(n, dout, dtype=torch.float32, device=h.device) \
        if takes_u and h.dtype == torch.bfloat16 else None
    call = functools.partial(
        lib.simulst_linear_res, _build.dtype_code(h), h.data_ptr(),
        w.data_ptr(), b.data_ptr(), res.data_ptr(), y.data_ptr(),
        *((None if u is None else u.data_ptr(),) if takes_u else ()), n,
        h.shape[1], dout, *((dout,) if takes_real else ()), period,
        res_rows, *((path,) if takes_path else ()),
        *_build.dropout_args(rate, 7), _build.stream_of(h))
    call.y, call.keep = y, u
    if call():
        raise RuntimeError("simulst_linear_res: CUDA error")
    return call


def mha_fwd_entry(torch, _build, lib, takes_path, q, k, v, kmask, causal,
                  rate, path, takes_real=True):
    """simulst_mha_fwd of `lib` bound to its arguments and called once,
    with its build's signature (takes_path: the path argument; takes_real:
    the real head dim); `.outs` is (out, lse), NaN where the kernel writes
    nothing."""
    b, tq, d = q.shape
    out = torch.full_like(q, float("nan"))
    lse = torch.full((b, 4, tq), float("nan"), device=q.device)
    call = functools.partial(
        lib.simulst_mha_fwd, _build.dtype_code(q),
        *(t.data_ptr() for t in (q, k, v, kmask, out, lse)), b, tq,
        k.shape[1], d, 4, *((d // 4,) if takes_real else ()), int(causal),
        *((path,) if takes_path else ()),
        *_build.dropout_args(rate, 4321), _build.stream_of(q))
    call.outs = (out, lse)
    if call():
        raise RuntimeError("simulst_mha_fwd: CUDA error")
    return call


def mha_bwd_entry(torch, _build, mha, lib, takes_scratch, q, k, v, kmask,
                  out, lse, dout, causal, rate, takes_real=True):
    """simulst_mha_bwd of `lib` bound to its arguments and called once,
    with its build's signature (takes_scratch: the delta and dS scratch;
    takes_real: the real head dim); `.outs` is (dq, dk, dv)."""
    b, tq, d = q.shape
    tk = k.shape[1]
    outs = tuple(torch.empty_like(t) for t in (q, k, v))
    scratch = tuple(torch.empty(shape, dtype=torch.float32, device=q.device)
                    for shape in mha.backward_scratch_shapes(b, 4, tq, tk)) \
        if takes_scratch else ()
    call = functools.partial(
        lib.simulst_mha_bwd, _build.dtype_code(q),
        *(t.data_ptr() for t in (q, k, v, kmask, out, lse, dout, *outs,
                                 *scratch)),
        b, tq, tk, d, 4, *((d // 4,) if takes_real else ()), int(causal),
        *_build.dropout_args(rate, 4321), _build.stream_of(q))
    call.outs, call.keep = outs, scratch
    if call():
        raise RuntimeError("simulst_mha_bwd: CUDA error")
    return call


def alignment_entries(torch, _build, lib, takes_carry, prefix, denom, g,
                      alphas=None):
    """(forward, backward): simulst_alignment_fwd and _bwd of `lib` bound
    to their arguments and called once, each with its build's signature
    (takes_carry: the (N, S) carry scratch); `.outs` are (alphas,) and
    (d_prefix, d_denom), NaN where the kernel writes nothing.  The
    backward takes `alphas`, or else the forward's."""
    n, u, s = prefix.shape
    stream = _build.stream_of(prefix)
    out = torch.full_like(prefix, float("nan"))
    fwd = functools.partial(lib.simulst_alignment_fwd, prefix.data_ptr(),
                            denom.data_ptr(), out.data_ptr(), n, u, s, stream)
    fwd.outs = (out,)
    alphas = out if alphas is None else alphas
    grads = tuple(torch.full_like(prefix, float("nan")) for _ in range(2))
    carry = torch.empty(n, s, device=prefix.device) if takes_carry else None
    bwd = functools.partial(
        lib.simulst_alignment_bwd, prefix.data_ptr(), denom.data_ptr(),
        alphas.data_ptr(), g.data_ptr(), *(t.data_ptr() for t in grads),
        *((carry.data_ptr(),) if takes_carry else ()), n, u, s, stream)
    bwd.outs, bwd.keep = grads, carry
    for call, name in ((fwd, "fwd"), (bwd, "bwd")):
        if call():
            raise RuntimeError(f"simulst_alignment_{name}: CUDA error")
    return fwd, bwd


def ctc_inputs(torch, ctc, t, b, s, how, seed):
    """(em, can_skip, input_lengths, target_lengths, scale) on the card,
    seeded: em the label scores of log_softmax'd random logits over a
    4100-word vocabulary ("asr": targets of 38 to 64 labels, S 129, 192-256
    frames) or log_softmax'd (T, B, S) noise (as the card test makes it;
    "card": its lengths, one example whose target cannot fit its frames,
    one with an empty target; "ragged": lengths from half to all of T and
    of the labels); some labels repeat their predecessor (no skip)."""
    g = torch.Generator().manual_seed(seed)
    L = (s - 1) // 2
    targets = torch.randint(4, 4100 if how == "asr" else 9, (b, L),
                            generator=g)
    if how == "asr":
        tl = torch.randint(38, L + 1, (b,), generator=g)
        il = torch.randint(192, t + 1, (b,), generator=g)
    elif how == "card":
        tl, il = torch.tensor([8, 5, 8, 0]), torch.tensor([60, 41, 5, 60])
        targets[1, 3] = targets[1, 2]
    else:
        tl = torch.randint(L // 2, L + 1, (b,), generator=g)
        il = torch.randint(max(t // 2, 1), t + 1, (b,), generator=g)
    targets = torch.where(torch.arange(L)[None] < tl[:, None], targets,
                          torch.ones_like(targets)).cuda()
    _, can_skip = ctc._ctc_masks(targets, 0)
    if how == "asr":
        logits = torch.randn(b, t, 4100, generator=g).cuda()
        labels = ctc.ctc_labels(targets, 0)
        em = (ctc._emissions(logits, labels) -
              torch.logsumexp(logits, -1).T[:, :, None]).contiguous()
    else:
        em = torch.log_softmax(torch.randn(t, b, s, generator=g), -1).cuda()
    scale = -torch.rand(b, generator=g)
    scale[0] = 0.0
    return em, can_skip.to(torch.int32), il.to(torch.int32).cuda(), \
        tl.to(torch.int32).cuda(), scale.cuda()


def ctc_entries(torch, _build, lib, em, skip, il, tl, scale, alphas=None,
                nll=None):
    """(alpha, d_em): simulst_ctc_alpha and simulst_ctc_d_em of `lib` bound
    to their arguments and called once; `.outs` are (alphas,) and (d_em,), NaN where the
    kernel writes nothing.  d_em takes `alphas` and `nll`, or else the alpha
    entry's and the nll it gives."""
    t, b, s = em.shape
    stream = _build.stream_of(em)
    out = torch.full_like(em, float("nan"))
    alpha = functools.partial(lib.simulst_ctc_alpha, em.data_ptr(),
                              skip.data_ptr(), il.data_ptr(), tl.data_ptr(),
                              out.data_ptr(), t, b, s, stream)
    alpha.outs = (out,)
    if alpha():
        raise RuntimeError("simulst_ctc_alpha: CUDA error")
    if alphas is None:
        from simulst_tpu_torch.ops import ctc
        alphas, nll = out, ctc._nll_from_alpha(out[-1], tl)
    d = torch.full_like(em, float("nan"))
    d_em = functools.partial(
        lib.simulst_ctc_d_em, em.data_ptr(), alphas.data_ptr(),
        skip.data_ptr(), il.data_ptr(), tl.data_ptr(), scale.data_ptr(),
        nll.data_ptr(), d.data_ptr(), t, b, s, stream)
    d_em.outs, d_em.keep = (d,), (alphas, nll)
    if d_em():
        raise RuntimeError("simulst_ctc_d_em: CUDA error")
    return alpha, d_em


def convpos_entry(torch, _build, lib, xp, dy):
    """simulst_convpos_wgrad of `lib` bound to its arguments (K 64, 16
    groups, the wrapper's batch slices) and called once; `.dw` is the
    output."""
    from simulst_tpu_torch.ops import conv_pos
    b, t_in, d = xp.shape
    t = dy.shape[1]
    splits = min(conv_pos.BATCH_SPLITS, b)
    splits = -(-b // -(-b // splits))
    dw = torch.empty(d, 16, 64, device=xp.device)
    partial = torch.empty(splits, d, 16, 64, device=xp.device)
    call = functools.partial(
        lib.simulst_convpos_wgrad, _build.dtype_code(xp), xp.data_ptr(),
        dy.data_ptr(), dw.data_ptr(), partial.data_ptr(), b, t, 64, d, 16,
        splits, _build.stream_of(xp))
    call.dw, call.keep = dw, partial
    if call():
        raise RuntimeError("simulst_convpos_wgrad: CUDA error")
    return call


def determinism_calls(torch):
    """C entry -> a call of its wrapper at a train shape, on seeded
    inputs, returning its outputs."""
    import chip_smoke as cs
    from simulst_tpu_torch.ops import (cif_integrate, conv_pos, ctc, ffn,
                                       linear_res, mha, monotonic_align)
    from simulst_tpu_torch.ops import emformer_attn as ea

    g = torch.Generator().manual_seed(3)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).cuda()

    d, hid = 256, 2048
    x, dy = randn(12288, d), randn(12288, d)
    lnw = (1 + randn(d, scale=0.1), randn(d, scale=0.1),
           randn(d, hid, scale=0.03), randn(hid, scale=0.02),
           randn(hid, d, scale=0.03), randn(d, scale=0.02))
    xb, dyb = x.bfloat16(), dy.bfloat16()
    lnwb = lnw[:2] + tuple(w.bfloat16() for w in lnw[2:])
    h, res, dyl = randn(12800, d), randn(12800, d), randn(12800, d)
    wl, bl = randn(d, d, scale=0.06), randn(d, scale=0.02)
    q, k, v, dout, kmask = mha_inputs(torch, 64, 128, 128, "ragged",
                                      torch.float32, 5)
    geom = ea.AttnGeom(U=256, seg=16, lc=32, rc=8, max_mem=5, G=8,
                       num_heads=4)
    lengths = torch.randint(192, 257, (32,), generator=g).to(torch.int32)
    attn = (randn(32, geom.ng, geom.nq, d), randn(32, geom.tk, d),
            randn(32, geom.tk, d), lengths.cuda())
    attn_dout = randn(32, geom.ng, geom.nq, d)
    attn_b = tuple(t.bfloat16() for t in attn[:3]) + attn[3:]
    attn_gate = cs.segment_gate(ea, geom, 32, g, "cuda")
    xp, dyc = randn(32, 319, d), randn(32, 256, d)
    targets = torch.randint(4, 4100, (32, 64), generator=g)
    tl = torch.randint(38, 65, (32,), generator=g)
    targets = torch.where(torch.arange(64)[None] < tl[:, None], targets,
                          torch.ones_like(targets)).cuda()
    tl = tl.cuda()
    labels, can_skip = ctc._ctc_masks(targets, 0)
    logits = randn(32, 256, 4100)
    em = (ctc._emissions(logits, labels) -
          torch.logsumexp(logits, -1).T[:, :, None]).contiguous()
    alphas = ctc.alphas_plain(em, can_skip, lengths.cuda(), tl)
    nll = ctc._nll_from_alpha(alphas[-1], tl)
    scale = -torch.ones(32, device="cuda")
    prefix, denom, ga = cs.alignment_panels("cuda", 128, 72, 32)
    al = monotonic_align.alignment_fwd_plain(prefix, denom)
    xc, alpha, _ = cif_inputs(torch, 32, 256, 256, "sigmoid", 7)
    with torch.no_grad():
        out, lse = mha.fused_mha_forward(q, k, v, kmask, 4, True, 0.1, 9)
    return {
        "simulst_ffn (fused path, 300 rows)": lambda: (
            ffn.fused_ln_ffn_res_forward(x[:300], *lnw, "gelu", 0.1, 0.1,
                                         29),),
        "simulst_ffn (tiled path)": lambda: (ffn.fused_ffn_forward(
            x, *lnw[2:], "relu", 0.1, 0.1, 29),),
        "simulst_ffn_bwd": lambda: ffn.fused_ffn_backward(
            x[:8192], *lnw[2:5], dy[:8192], "relu", 0.1, 0.1, 29),
        "simulst_ln_ffn_bwd": lambda: ffn.fused_ln_ffn_res_backward(
            x, *lnw[:5], dy, "gelu", 0.1, 0.1, 29),
        # bf16: the products on the tensor cores
        "simulst_ffn (tiled path, bf16)": lambda: (
            ffn.fused_ln_ffn_res_forward(xb, *lnwb, "gelu", 0.1, 0.1, 29),),
        "simulst_ln_ffn_bwd (bf16)": lambda: ffn.fused_ln_ffn_res_backward(
            xb, *lnwb[:5], dyb, "gelu", 0.1, 0.1, 29),
        "simulst_ffn_bwd (bf16)": lambda: ffn.fused_ffn_backward(
            xb[:2304], *lnwb[2:5], dyb[:2304], "gelu", 0.1, 0.1, 29),
        "simulst_linear_res_bwd (bf16)": lambda: (
            linear_res.fused_linear_res_backward(
                h.bfloat16(), wl.bfloat16(), dyl.bfloat16(), 200, 192, 0.1,
                7)),
        "simulst_linear_res": lambda: (linear_res.fused_linear_res_forward(
            h, wl, bl, res, 200, 192, 0.1, 7),),
        "simulst_linear_res_bwd": lambda: linear_res.fused_linear_res_backward(
            h, wl, dyl, 200, 192, 0.1, 7),
        "simulst_linear_res (rows path, 40 rows)": lambda: (
            linear_res.fused_linear_res_forward(h[:40], wl, bl, res[:40], 0,
                                                0, 0.1, 7),),
        "simulst_mha_fwd": lambda: mha.fused_mha_forward(
            q, k, v, kmask, 4, True, 0.1, 9),
        "simulst_mha_fwd (decode, Tq 1)": lambda: mha.fused_mha_forward(
            q[:40, :1], k[:40], v[:40], kmask[:40], 4, False, 0.1, 9),
        "simulst_mha_bwd": lambda: mha.fused_mha_backward(
            q, k, v, kmask, out, lse, dout, 4, True, 0.1, 9),
        "simulst_emformer_attn": lambda: (
            ea.emformer_grouped_attention_forward(*attn, geom, 0.1, 23),),
        "simulst_emformer_attn_bwd": lambda: (
            ea.emformer_grouped_attention_backward(*attn, attn_dout, geom,
                                                   0.1, 23)),
        # bf16 on the tensor cores, dense and gated
        "simulst_emformer_attn_bwd (bf16)": lambda: (
            ea.emformer_grouped_attention_backward(
                *attn_b, attn_dout.bfloat16(), geom, 0.1, 23)),
        "simulst_emformer_attn_bwd (bf16, gated)": lambda: (
            ea.emformer_grouped_attention_backward(
                *attn_b, attn_dout.bfloat16(), geom, 0.1, 23, attn_gate)),
        "simulst_linear_res (tiled path, bf16)": lambda: (
            linear_res.fused_linear_res_forward(
                h.bfloat16(), wl.bfloat16(), bl.bfloat16(), res.bfloat16(),
                200, 192, 0.1, 7),),
        "simulst_convpos_wgrad": lambda: (
            conv_pos.convpos_wgrad(xp, dyc, 64, 16),),
        "simulst_ctc_alpha": lambda: (ctc.ctc_alphas(
            em, can_skip, lengths.cuda(), tl),),
        "simulst_ctc_d_em": lambda: (ctc.ctc_d_em(
            em, alphas, can_skip, lengths.cuda(), tl, scale, nll),),
        "simulst_alignment_fwd": lambda: (
            monotonic_align.alignment_fwd(prefix, denom),),
        "simulst_alignment_bwd": lambda: monotonic_align.alignment_bwd(
            prefix, denom, al, ga),
        "simulst_cif_integrate": lambda: cif_integrate.cif_integrate_forward(
            xc, alpha, 1.0, 72),
    }


# (D, hidden) of the FFN paths' bit check at the new widths; (D, heads) of
# the MHA kernels'
WIDTH_FFN = ((64, 256), (128, 512), (512, 2048), (16, 32), (48, 48),
             (200, 800))
WIDTH_MHA = ((64, 4), (128, 4), (384, 4), (512, 4), (16, 4), (48, 4),
             (200, 4), (100, 1))
# C entry -> (index, count) of the real-width arguments in its argument
# list (ops/_build.py SIGNATURES)
REAL_WIDTH_ARGS = {"simulst_ffn": (18, 2), "simulst_ffn_bwd": (19, 2),
                   "simulst_ln_ffn_bwd": (22, 2),
                   "simulst_linear_res": (10, 1),
                   "simulst_linear_res_bwd": (11, 1),
                   "simulst_mha_fwd": (12, 1), "simulst_mha_bwd": (18, 1),
                   "simulst_emformer_attn": (13, 1),
                   "simulst_emformer_attn_bwd": (19, 1)}


class WithoutRealWidths:
    """A build whose C entries take no real-width arguments, called with
    this checkout's argument lists (through the wrappers): each call of
    an entry of REAL_WIDTH_ARGS drops them.  Declares those entries'
    argument types without them on the build's library."""

    def __init__(self, _build, lib):
        self.lib = lib
        for name, (at, count) in REAL_WIDTH_ARGS.items():
            types = _build.SIGNATURES[name]
            getattr(lib, name).argtypes = types[:at] + types[at + count:]

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if name not in REAL_WIDTH_ARGS:
            return fn
        at, count = REAL_WIDTH_ARGS[name]
        return lambda *args: fn(*args[:at], *args[at + count:])


def width_cases(torch):
    """(entry, case, fn) at the new widths: fn returns {name: (a, b)}, two
    results that must be equal bit for bit (two paths, or two calls)."""
    from simulst_tpu_torch.ops import conv_pos, ffn, mha
    from simulst_tpu_torch.ops import emformer_attn as ea

    g = torch.Generator().manual_seed(17)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g) * scale).to(dtype).cuda()

    def twice(fn):
        def run():
            first = [t.clone() for t in fn()]
            torch.cuda.synchronize()
            return {f"output {j}": (a, b) for j, (a, b) in
                    enumerate(zip(first, fn()))}
        return run

    def ffn_paths(ln_res, x, ws):
        def run():
            outs = {}
            saved = ffn.TILED_MIN_ROWS, ffn.BF16_TILED_MIN_ROWS
            for path, min_rows in (("fused", 10 ** 9), ("tiled", 0)):
                ffn.TILED_MIN_ROWS = ffn.BF16_TILED_MIN_ROWS = min_rows
                try:
                    outs[path] = (ffn.fused_ln_ffn_res_forward(
                        x, *ws, "gelu", 0.1, 0.1, 29) if ln_res else
                        ffn.fused_ffn_forward(x, *ws[2:], "relu", 0.1, 0.1,
                                              29))
                finally:
                    ffn.TILED_MIN_ROWS, ffn.BF16_TILED_MIN_ROWS = saved
            # bf16: the tiled path's products on the tensor cores, within
            # BF16_TOL of the fused kernel's (no longer bit for bit)
            name = "y fused vs tiled" + (
                " within BF16_TOL" if x.dtype == torch.bfloat16 else "")
            return {name: (outs["fused"], outs["tiled"])}
        return run

    def mha_paths(q, k, v, kmask, heads, causal):
        def run():
            outs = {}
            for path, max_tq in (("decode", 2), ("tiles", 0)):
                saved, mha.DECODE_MAX_TQ = mha.DECODE_MAX_TQ, max_tq
                try:
                    outs[path] = mha.fused_mha_forward(q, k, v, kmask, heads,
                                                       causal, 0.1, 9)
                finally:
                    mha.DECODE_MAX_TQ = saved
            return {f"{n} decode vs tiles": (a, b) for n, a, b in
                    zip(("out", "lse"), outs["decode"], outs["tiles"])}
        return run

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for d, hid in WIDTH_FFN:
            for rows in (1, 40, 300):
                x = randn(rows, d, dtype=dtype)
                ws = (1 + randn(d, scale=0.1), randn(d, scale=0.1),
                      randn(d, hid, scale=d ** -0.5, dtype=dtype),
                      randn(hid, scale=0.02, dtype=dtype),
                      randn(hid, d, scale=hid ** -0.5, dtype=dtype),
                      randn(d, scale=0.02, dtype=dtype))
                for ln_res in (1, 0):
                    cases.append((f"simulst_ffn ln_res {ln_res} paths",
                                  f"{str(dtype)[6:]} D {d} rows {rows}",
                                  ffn_paths(ln_res, x, ws)))
        for d, heads in WIDTH_MHA:
            for tq, causal in ((1, False), (2, True)):
                q = randn(5, tq, d, dtype=dtype)
                k, v = (randn(5, 77, d, dtype=dtype) for _ in range(2))
                kmask = torch.ones(5, 77, dtype=torch.int32, device="cuda")
                kmask[1, 50:] = 0
                cases.append(("simulst_mha_fwd paths",
                              f"{str(dtype)[6:]} head dim {d // heads} Tq "
                              f"{tq}", mha_paths(q, k, v, kmask, heads,
                                                 causal)))
    for d, hid, rows in ((64, 256, 12288), (512, 2048, 4133),
                         (1024, 4096, 1000)):
        x, dy = randn(rows, d), randn(rows, d)
        ws = (1 + randn(d, scale=0.1), randn(d, scale=0.1),
              randn(d, hid, scale=d ** -0.5), randn(hid, scale=0.02),
              randn(hid, d, scale=hid ** -0.5), randn(d, scale=0.02))
        case = f"D {d} hidden {hid} rows {rows}"
        cases += [
            ("simulst_ffn", case, twice(lambda x=x, ws=ws: (
                ffn.fused_ln_ffn_res_forward(x, *ws, "gelu", 0.1, 0.1, 29),))),
            ("simulst_ffn_bwd", case, twice(
                lambda x=x, ws=ws, dy=dy: ffn.fused_ffn_backward(
                    x, *ws[2:5], dy, "relu", 0.1, 0.1, 29))),
            ("simulst_ln_ffn_bwd", case, twice(
                lambda x=x, ws=ws, dy=dy: ffn.fused_ln_ffn_res_backward(
                    x, *ws[:5], dy, "gelu", 0.1, 0.1, 29)))]
    for d, heads in ((64, 4), (512, 4), (1024, 8)):
        q, dout = (randn(32, 72, d) for _ in range(2))
        k, v = (randn(32, 72, d) for _ in range(2))
        kmask = torch.ones(32, 72, dtype=torch.int32, device="cuda")
        with torch.no_grad():
            out, lse = mha.fused_mha_forward(q, k, v, kmask, heads, True,
                                             0.1, 9)
        cases.append(("simulst_mha_bwd", f"head dim {d // heads}", twice(
            lambda q=q, k=k, v=v, km=kmask, o=out, l=lse, do=dout, h=heads:
            mha.fused_mha_backward(q, k, v, km, o, l, do, h, True, 0.1, 9))))
    geom = ea.AttnGeom(U=256, seg=16, lc=32, rc=8, max_mem=5, G=8,
                       num_heads=4)
    for d in (64, 512):
        lengths = torch.randint(192, 257, (8,), generator=g).to(
            torch.int32).cuda()
        attn = (randn(8, geom.ng, geom.nq, d), randn(8, geom.tk, d),
                randn(8, geom.tk, d), lengths)
        dout = randn(8, geom.ng, geom.nq, d)
        case = f"head dim {d // 4}"
        cases += [
            ("simulst_emformer_attn", case, twice(lambda a=attn: (
                ea.emformer_grouped_attention_forward(*a, geom, 0.1, 23),))),
            ("simulst_emformer_attn_bwd", case, twice(
                lambda a=attn, do=dout: ea.emformer_grouped_attention_backward(
                    *a, do, geom, 0.1, 23)))]
    # above the old maxima: D 1280 (the walking LN row passes), head dims
    # 160 and 256 (the wide attention kernels), 96 and 128 channels
    for d, hid, rows in ((1280, 2560, 1000), (2048, 1024, 300)):
        x, dy = randn(rows, d), randn(rows, d)
        ws = (1 + randn(d, scale=0.1), randn(d, scale=0.1),
              randn(d, hid, scale=d ** -0.5), randn(hid, scale=0.02),
              randn(hid, d, scale=hid ** -0.5), randn(d, scale=0.02))
        case = f"D {d} hidden {hid} rows {rows}"
        cases += [
            ("simulst_ffn", case, twice(lambda x=x, ws=ws: (
                ffn.fused_ln_ffn_res_forward(x, *ws, "gelu", 0.1, 0.1, 29),))),
            ("simulst_ln_ffn_bwd", case, twice(
                lambda x=x, ws=ws, dy=dy: ffn.fused_ln_ffn_res_backward(
                    x, *ws[:5], dy, "gelu", 0.1, 0.1, 29)))]
    for d, heads in ((1280, 8), (1024, 4)):
        q, dout = (randn(8, 40, d) for _ in range(2))
        k, v = (randn(8, 40, d) for _ in range(2))
        kmask = torch.ones(8, 40, dtype=torch.int32, device="cuda")
        with torch.no_grad():
            out, lse = mha.fused_mha_forward(q, k, v, kmask, heads, True,
                                             0.1, 9)
        cases += [
            ("simulst_mha_fwd", f"head dim {d // heads}", twice(
                lambda q=q, k=k, v=v, km=kmask, h=heads:
                mha.fused_mha_forward(q, k, v, km, h, True, 0.1, 9))),
            ("simulst_mha_bwd", f"head dim {d // heads}", twice(
                lambda q=q, k=k, v=v, km=kmask, o=out, l=lse, do=dout,
                h=heads: mha.fused_mha_backward(q, k, v, km, o, l, do, h,
                                                True, 0.1, 9)))]
    for d in (640, 1024):
        lengths = torch.randint(192, 257, (2,), generator=g).to(
            torch.int32).cuda()
        attn = (randn(2, geom.ng, geom.nq, d), randn(2, geom.tk, d),
                randn(2, geom.tk, d), lengths)
        dout = randn(2, geom.ng, geom.nq, d)
        case = f"head dim {d // 4}"
        cases += [
            ("simulst_emformer_attn", case, twice(lambda a=attn: (
                ea.emformer_grouped_attention_forward(*a, geom, 0.1, 23),))),
            ("simulst_emformer_attn_bwd", case, twice(
                lambda a=attn, do=dout: ea.emformer_grouped_attention_backward(
                    *a, do, geom, 0.1, 23)))]
    for d, groups in ((64, 16), (1024, 16), (256, 256), (1536, 16),
                      (2048, 16)):
        xp, dy = randn(32, 319, d), randn(32, 256, d)
        cases.append(("simulst_convpos_wgrad",
                      f"{d // groups} channels a group", twice(
                          lambda xp=xp, dy=dy, gr=groups: (
                              conv_pos.convpos_wgrad(xp, dy, 64, gr),))))
    return cases


def device_ms(torch, fn, calls):
    """Device time per call of fn() by kernel, from torch.profiler."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    def short(key):
        for noise in ("void ", "simulst::", "(anonymous namespace)::"):
            key = key.replace(noise, "")
        return key[:200]

    return {short(e.key): e.self_device_time_total / 1e3 / calls
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rev", required=True, help="git revision to compare")
    ap.add_argument("--export", action="store_true",
                    help="only write the revision's sources under _build/")
    ap.add_argument("--time", action="store_true",
                    help="also time both builds in turns")
    ap.add_argument("--only", default="",
                    help="comma-separated C entries to bit-check (all)")
    args = ap.parse_args()

    from simulst_tpu_torch.ops import _build
    ref_dir = _build.BUILD_DIR / f"bitcheck_{args.rev}"
    if args.export or not (ref_dir / "csrc").is_dir():
        ref_csrc = export(args.rev, ref_dir)
    else:
        ref_csrc = ref_dir / "csrc"
    if args.export:
        print(f"wrote {ref_csrc}")
        return 0

    import torch
    import chip_smoke as cs
    from simulst_tpu_torch.ops import ffn, linear_res, mha

    if not torch.cuda.is_available():
        print("kernel_bitcheck: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(cs.gpu_name_and_power_limit(), flush=True)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        paths = [pool.submit(_build.build, *where) for where in
                 ((ref_csrc, ref_dir), (_build.CSRC, _build.BUILD_DIR))]
        ref_path, cur_path = (p.result() for p in paths)
    libs = {"rev": _build.open_library(ref_path, every_entry=False),
            "this": _build.open_library(cur_path)}
    ref_takes_cprev = "const void* cprev" in \
        source(ref_csrc, "cif.cu")
    ref_takes_scratch = "void* xn, void* h" in \
        source(ref_csrc, "ffn.cu")
    f32_ln = {"rev": takes_f32_ln(ref_csrc), "this": True}
    _P, _I = _build._P, _build._I
    if not ref_takes_scratch:    # simulst_ffn before the tiled path
        libs["rev"].simulst_ffn.argtypes = (
            [_I] * 3 + [_P] * 9 + [_I] * 4 + _build._DROP
            + _build._DROP[1:] + [_P])
    ref_mha_scratch = "void* delta, void* ds" in \
        source(ref_csrc, "mha.cu")
    if not ref_mha_scratch:      # simulst_mha_bwd before the dS scratch
        libs["rev"].simulst_mha_bwd.argtypes = (
            [_I] + [_P] * 10 + [_I] * 7 + [ctypes.c_uint64]
            + _build._DROP[2:] + [_P])
    ref_lr_path = "int res_rows, int path" in \
        source(ref_csrc, "linear_res.cu")
    # simulst_linear_res before its bf16 tiled paths' fp32 scratch
    ref_lr_u = "void* y, void* u" in source(ref_csrc, "linear_res.cu")
    if not ref_lr_path:          # simulst_linear_res before its two paths
        libs["rev"].simulst_linear_res.argtypes = (
            [_I] + [_P] * 5 + [_I] * 6 + [ctypes.c_uint64] + _build._DROP[2:]
            + [_P])
    elif not ref_lr_u:
        libs["rev"].simulst_linear_res.argtypes = (
            [_I] + [_P] * 5 + [_I] * 7 + _build._DROP[1:2] + _build._DROP[:1]
            + _build._DROP[2:] + [_P])
    ref_mha_path = "int causal, int path" in source(ref_csrc, "mha.cu")
    if not ref_mha_path:         # simulst_mha_fwd before its two kernels
        libs["rev"].simulst_mha_fwd.argtypes = (
            [_I] + [_P] * 6 + [_I] * 7 + [ctypes.c_uint64] + _build._DROP[2:]
            + [_P])
    # a revision before the bf16 tensor-core path: simulst_ln_ffn_bwd
    # takes no h_d and both FFN entries read fp32 scratch
    ref_takes_hd = (ref_csrc / "wgmma.cuh").exists()
    if not ref_takes_hd:
        libs["rev"].simulst_ln_ffn_bwd.argtypes = (
            [_I] * 2 + [_P] * 16 + [_I] * 6 + _build._DROP
            + _build._DROP[1:] + [_P])
    # a revision before the bf16 LN-FFN backward's hidden-gradient pass:
    # simulst_ln_ffn_bwd takes no dh
    ref_ln_dh = ref_takes_hd and "void* dh, void* partial" in \
        source(ref_csrc, "ln_ffn_bwd.cu")
    if ref_takes_hd and not ref_ln_dh:
        libs["rev"].simulst_ln_ffn_bwd.argtypes = (
            [_I] * 2 + [_P] * 17 + [_I] * 6 + _build._DROP
            + _build._DROP[1:] + [_P])
    ref_real = "int dim_real" in source(ref_csrc, "ffn.cu")
    # the builds as the wrappers call them: a revision without the real
    # widths through WithoutRealWidths (which declares its signatures)
    apis = {"rev": libs["rev"] if ref_real else
            WithoutRealWidths(_build, libs["rev"]), "this": libs["this"]}
    # a revision before the bf16 tensor-core FFN and linear-res backwards:
    # simulst_ffn_bwd takes no h_d and dh, and both read fp32 scratch
    ffn_bwd_src = source(ref_csrc, "ffn_bwd.cu" if (
        ref_csrc / "ffn_bwd.cu").exists() else "ffn.cu")
    ref_ffn_hd = "void* u, void* hd, void* du, void* g, void* dh" in \
        ffn_bwd_src
    if not ref_ffn_hd:
        libs["rev"].simulst_ffn_bwd.argtypes = (
            [_I] * 2 + [_P] * 11 + [_I] * (6 if ref_real else 4)
            + _build._DROP + _build._DROP[1:] + [_P])
    ref_lr_act_du = "float* grads, T* du" in source(ref_csrc,
                                                    "linear_res.cu")
    ref_align_carry = "void* carry" in \
        source(ref_csrc, "monotonic.cu")
    if ref_align_carry:          # simulst_alignment_bwd with the carry
        libs["rev"].simulst_alignment_bwd.argtypes = (
            [_P] * 7 + [_I] * 3 + [_P])
    only = set(filter(None, args.only.split(",")))

    def wanted(entry):
        return not only or entry in only

    summary = {}

    def report(entry, case, equal):
        ok = all(equal.values())
        s = summary.setdefault(entry, {"cases": 0, "all_equal": True})
        s["cases"] += 1
        s["all_equal"] = s["all_equal"] and ok
        print(json.dumps({"entry": entry, "case": case, "equal": equal}),
              flush=True)

    def real(key):
        return ref_real if key == "rev" else True

    def ffn_fwd(key, ln_res, act, x, ws, rate, tiled):
        takes = ref_takes_scratch if key == "rev" else True
        return ffn_entry(torch, _build, ffn, libs[key], takes, ln_res, act,
                         x, ln_params_for(f32_ln[key], ws), rate, tiled,
                         real(key), ref_takes_hd if key == "rev" else True)

    def ln_ffn_bwd(key, x, ws, dy, act, rate):
        rev = key == "rev"
        return ln_ffn_bwd_entry(torch, _build, libs[key],
                                ref_takes_hd if rev else True,
                                ref_ln_dh if rev else True, x,
                                ln_params_for(f32_ln[key], ws), dy, act,
                                rate, real(key))

    def ffn_bwd(key, x, ws, dy, act, rate):
        return ffn_bwd_entry(torch, _build, libs[key],
                             ref_ffn_hd if key == "rev" else True, x, ws[2:5],
                             dy, act, rate, real(key))

    def lr_bwd(key, h, w, dy, period, res_rows, rate):
        return linear_res_bwd_entry(
            torch, _build, libs[key], ref_lr_act_du if key == "rev" else True,
            h, w, dy, period, res_rows, rate, real(key))

    def lr_fwd(key, h, w, b, res, period, res_rows, rate, path):
        rev = key == "rev"
        return linear_res_entry(torch, _build, libs[key],
                                ref_lr_path if rev else True, h, w, b, res,
                                period, res_rows, rate, path, real(key),
                                ref_lr_u if rev else True)

    def mha_fwd(key, q, k, v, kmask, causal, rate, path):
        takes = ref_mha_path if key == "rev" else True
        return mha_fwd_entry(torch, _build, libs[key], takes, q, k, v, kmask,
                             causal, rate, path, real(key))

    def bf16_report(entry, case, names, outs, plain, bitwise=False):
        """A bf16 backward on the tensor cores: this checkout's outputs
        within BF16_TOL of the plain version (the first, an activation
        gradient; the others weight and bias gradients, within 1e-2 of
        their largest entry) and, if `bitwise` (the revision's products
        on the tensor cores too), equal to the revision's; their largest
        differences from the plain version and from the revision
        printed."""
        close = {f"{n} within BF16_TOL of plain": bf16_close(
            torch, a, c, weight=i > 0) for i, (n, a, c) in
            enumerate(zip(names, outs["this"], plain))}
        if bitwise:
            close.update({f"{n} bit for bit parent": torch.equal(a, b)
                          for n, a, b in zip(names, outs["this"],
                                             outs["rev"])})
        print(json.dumps({
            "entry": entry, "case": case,
            "bf16 max_abs_diff vs parent": {
                n: max_diff(a, b) for n, a, b in
                zip(names, outs["this"], outs["rev"])},
            "vs plain": {n: max_diff(a, c) for n, a, c in
                         zip(names, outs["this"], plain)},
            "parent vs plain": {n: max_diff(b, c) for n, b, c
                                in zip(names, outs["rev"], plain)}}),
            flush=True)
        report(entry, case, close)

    dtypes = (torch.float32, torch.bfloat16)
    names = ("dx", "dw1", "db1", "dw2", "db2")
    for dtype in dtypes if wanted("simulst_ffn") \
            or wanted("simulst_ffn_bwd") else ():
        for act in ("gelu", "relu"):
            for rate in (0.0, 0.1):
                for rows in FFN_ROWS:
                    case = f"{str(dtype)[6:]} {act} rate {rate} rows {rows}"
                    x, ws, dy = ln_ffn_inputs(torch, rows, dtype, rows + 1)
                    for ln_res in (1, 0) if wanted("simulst_ffn") else ():
                        # a revision with the bf16 tensor-core path is held
                        # on its fused path in bf16 (its tiled one sums on
                        # the tensor cores)
                        rev_tc = dtype == torch.bfloat16 and ref_takes_hd
                        want = ffn_fwd("rev", ln_res, act, x, ws, rate,
                                       ref_takes_scratch and not rev_tc).y
                        rev_tiled = ffn_fwd("rev", ln_res, act, x, ws, rate,
                                            True).y if rev_tc else want
                        got = {path: ffn_fwd("this", ln_res, act, x, ws, rate,
                                             path == "tiled").y
                               for path in ("fused", "tiled")}
                        torch.cuda.synchronize()
                        equal = {f"y {p}": torch.equal(want, y)
                                 for p, y in got.items()}
                        if dtype == torch.bfloat16:
                            # the tiled path's products on the tensor cores:
                            # held to the plain version, beside the parent
                            plain = (ffn.ln_ffn_res_plain(x, *ws, act, rate,
                                                          rate, 29)
                                     if ln_res else ffn.ffn_plain(
                                         x, *ws[2:], act, rate, rate, 29))
                            del equal["y tiled"]
                            equal["y tiled within BF16_TOL of plain"] = \
                                bf16_close(torch, got["tiled"], plain)
                            if rev_tc:   # the same products as the parent's
                                equal["y tiled bit for bit parent's"] = \
                                    torch.equal(got["tiled"], rev_tiled)
                            print(json.dumps({
                                "entry": f"simulst_ffn ln_res {ln_res}",
                                "case": case, "bf16 tiled max_abs_diff": {
                                    "vs parent": max_diff(got["tiled"],
                                                          rev_tiled),
                                    "vs plain": max_diff(got["tiled"], plain),
                                    "parent vs plain": max_diff(rev_tiled,
                                                                plain)}}))
                        report(f"simulst_ffn ln_res {ln_res}", case, equal)
                    if not wanted("simulst_ffn_bwd"):
                        continue
                    outs = {key: ffn_bwd(key, x, ws, dy, act, rate).outs
                            for key in libs}
                    torch.cuda.synchronize()
                    if dtype == torch.float32:
                        report("simulst_ffn_bwd", case,
                               {n: torch.equal(a, b) for n, a, b in
                                zip(names, outs["rev"], outs["this"])})
                        continue
                    # bf16: the five products on the tensor cores, held to
                    # the plain version (relu under this build's relu
                    # mask), beside the parent
                    cfg = (act, rate, rate, 29)
                    if act == "relu":
                        with library_of(_build, libs["this"]):
                            mask = cs.kernel_ffn_relu_mask(x, ws[2:], cfg)
                        plain = cs.plain_ffn_backward_under(x, ws[2:], dy,
                                                            cfg, mask)
                    else:
                        plain = ffn.ffn_plain_backward(x, *ws[2:5], dy, *cfg)
                    bf16_report("simulst_ffn_bwd", case, names, outs, plain)

    names = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
    for dtype in dtypes if wanted("simulst_ln_ffn_bwd") else ():
        for act in ("gelu", "relu"):
            for rate in (0.0, 0.1):
                for rows in LN_ROWS:
                    x, ws, dy = ln_ffn_inputs(torch, rows, dtype, rows)
                    outs = {key: ln_ffn_bwd(key, x, ws, dy, act, rate).outs
                            for key in libs}
                    torch.cuda.synchronize()
                    case = f"{str(dtype)[6:]} {act} rate {rate} rows {rows}"
                    if dtype == torch.float32:
                        report("simulst_ln_ffn_bwd", case,
                               {n: torch.equal(a, b) for n, a, b in
                                zip(names, outs["rev"], outs["this"])})
                        continue
                    # bf16: the five products on the tensor cores, held to
                    # the plain version (with relu under this build's relu
                    # mask: chip_smoke.kernel_relu_mask), beside the parent
                    lnw = (ws[0].float(), ws[1].float(), *ws[2:])
                    cfg = (act, rate, rate, 29)
                    if act == "relu":   # under the kernel's relu mask
                        with library_of(_build, libs["this"]):
                            mask = cs.kernel_relu_mask(x, lnw, cfg)
                        plain = cs.plain_ln_ffn_backward_under(x, lnw, dy,
                                                               cfg, mask)
                    else:
                        plain = ffn.ln_ffn_res_plain_backward(
                            x, *lnw[:5], dy, *cfg)
                    bf16_report("simulst_ln_ffn_bwd", case, names, outs,
                                plain, bitwise=ref_takes_hd)

    def cif_entry(lib, x, alpha, csum, t, beta, out, delays):
        """The C entry bound to its arguments: a call costs the host little
        beside the launch, so that CUDA events time the kernel."""
        b, s, c = x.shape
        third = csum - alpha if lib is libs["rev"] and ref_takes_cprev \
            else alpha
        call = functools.partial(
            lib.simulst_cif_integrate, x.data_ptr(), csum.data_ptr(),
            third.data_ptr(), out.data_ptr(), delays.data_ptr(), b, s, t, c,
            float(beta), _build.stream_of(x))
        call.keep = third
        if call():
            raise RuntimeError("simulst_cif_integrate: CUDA error")
        return call

    for i, (label, b, s, c, t, beta, how) in enumerate(
            CIF_CASES if wanted("simulst_cif_integrate") else ()):
        x, alpha, csum = cif_inputs(torch, b, s, c, how, 100 + i)
        outs = {}
        for key, lib in libs.items():
            out = torch.full((b, t, c), float("nan"), device="cuda")
            delays = torch.full((b, t), float("nan"), device="cuda")
            cif_entry(lib, x, alpha, csum, t, beta, out, delays)
            outs[key] = (out, delays)
        torch.cuda.synchronize()
        report("simulst_cif_integrate", label,
               {n: torch.equal(a, b_) for n, a, b_ in
                zip(("out", "delays"), outs["rev"], outs["this"])})

    def lr_inputs(rows, dtype, seed):
        """h, w, b, res on the card, seeded."""
        g = torch.Generator().manual_seed(seed)
        h, res = (torch.randn(rows, 256, generator=g).to(dtype).cuda()
                  for _ in range(2))
        w = (torch.randn(256, 256, generator=g) * 0.06).to(dtype).cuda()
        b = (torch.randn(256, generator=g) * 0.02).to(dtype).cuda()
        return h, w, b, res

    for dtype in dtypes if wanted("simulst_linear_res") else ():
        for rate in (0.0, 0.1):
            for period, res_rows in LR_GATES:
                for rows in LR_FWD_ROWS:
                    h, w, b, res = lr_inputs(rows, dtype, rows + period)
                    want = lr_fwd("rev", h, w, b, res, period, res_rows,
                                  rate, linear_res.FWD_PATHS["tiled"]).y
                    got = {p: lr_fwd("this", h, w, b, res, period, res_rows,
                                     rate, code).y
                           for p, code in linear_res.FWD_PATHS.items()}
                    torch.cuda.synchronize()
                    case = (f"{str(dtype)[6:]} rate {rate} period {period} "
                            f"rows {rows}")
                    tc = {p for p in got if linear_res.fwd_uses_tensor_cores(
                        p, dtype) and not linear_res.fwd_uses_tensor_cores(
                            p, torch.float32)}
                    equal = {f"y {p}": torch.equal(want, y)
                             for p, y in got.items() if p not in tc}
                    if tc:   # bf16 tiled paths: the product on the tensor
                        # cores, held to the plain version, the paths to
                        # each other bit for bit
                        plain = linear_res.linear_res_plain(
                            h, w, b, res, period, res_rows, rate, 7)
                        equal.update({f"y {p} within BF16_TOL of plain":
                                      bf16_close(torch, got[p], plain)
                                      for p in tc})
                        equal["tiled == wide"] = torch.equal(got["tiled"],
                                                             got["wide"])
                        print(json.dumps({
                            "entry": "simulst_linear_res", "case": case,
                            "bf16 max_abs_diff vs parent": {
                                p: max_diff(got[p], want) for p in tc},
                            "vs plain": {p: max_diff(got[p], plain)
                                         for p in tc},
                            "parent vs plain": max_diff(want, plain)}),
                            flush=True)
                    report("simulst_linear_res", case, equal)

    names = ("dh", "dw", "db")
    for dtype in dtypes if wanted("simulst_linear_res_bwd") else ():
        for rate in (0.0, 0.1):
            for period, res_rows in LR_GATES:
                for rows in LR_ROWS:
                    g = torch.Generator().manual_seed(rows + period)
                    h, dy = (torch.randn(rows, 256, generator=g).to(
                        dtype).cuda() for _ in range(2))
                    w = (torch.randn(256, 256, generator=g) * 0.06).to(
                        dtype).cuda()
                    outs = {key: lr_bwd(key, h, w, dy, period, res_rows,
                                        rate).outs for key in libs}
                    torch.cuda.synchronize()
                    case = (f"{str(dtype)[6:]} rate {rate} period {period} "
                            f"rows {rows}")
                    if dtype == torch.float32:
                        report("simulst_linear_res_bwd", case,
                               {n: torch.equal(a, b) for n, a, b in
                                zip(names, outs["rev"], outs["this"])})
                        continue
                    # bf16: both products on the tensor cores
                    bf16_report("simulst_linear_res_bwd", case, names, outs,
                                linear_res.linear_res_plain_backward(
                                    h, w, dy, period, res_rows, rate, 7))

    def mha_bwd(key, q, k, v, kmask, out, lse, dout, causal, rate):
        takes = ref_mha_scratch if key == "rev" else True
        return mha_bwd_entry(torch, _build, mha, libs[key], takes, q, k, v,
                             kmask, out, lse, dout, causal, rate, real(key))

    def mha_case(i, dtype, rate):
        """Inputs and this checkout's forward of MHA_CASES[i]."""
        label, b, tq, tk, causal, mask = MHA_CASES[i]
        q, k, v, dout, kmask = mha_inputs(torch, b, tq, tk, mask, dtype, i)
        with library_of(_build, libs["this"]):
            out, lse = mha.fused_mha_forward(q, k, v, kmask, 4, causal, rate,
                                             4321)
        return q, k, v, kmask, out, lse, dout, causal, rate

    for dtype in dtypes if wanted("simulst_mha_fwd") else ():
        for rate in (0.0, 0.1):
            for i, (label, b, tq, tk, causal, mask) in enumerate(
                    MHA_FWD_CASES):
                q, k, v, _, kmask = mha_inputs(torch, b, tq, tk, mask, dtype,
                                               i)
                want = mha_fwd("rev", q, k, v, kmask, causal, rate,
                               mha.FWD_PATHS["tiles"]).outs
                got = {p: mha_fwd("this", q, k, v, kmask, causal, rate,
                                  code).outs
                       for p, code in mha.FWD_PATHS.items()}
                torch.cuda.synchronize()
                report("simulst_mha_fwd", f"{str(dtype)[6:]} rate {rate} "
                       f"{label}",
                       {f"{n} {p}": torch.equal(a, b_) for p, outs in
                        got.items() for n, a, b_ in zip(("out", "lse"),
                                                        want, outs)})

    for dtype in dtypes if wanted("simulst_mha_bwd") else ():
        for rate in (0.0, 0.1):
            for i, case in enumerate(MHA_CASES):
                inputs = mha_case(i, dtype, rate)
                outs = {key: mha_bwd(key, *inputs).outs for key in libs}
                torch.cuda.synchronize()
                report("simulst_mha_bwd",
                       f"{str(dtype)[6:]} rate {rate} {case[0]}",
                       {n: torch.equal(a, b) for n, a, b in
                        zip(("dq", "dk", "dv"), outs["rev"], outs["this"])})

    def align(key, prefix, denom, g, alphas=None):
        takes = ref_align_carry if key == "rev" else False
        return alignment_entries(torch, _build, libs[key], takes, prefix,
                                 denom, g, alphas)

    for label, n, u, s_, waitk in ALIGN_CASES if (
            wanted("simulst_alignment_fwd")
            or wanted("simulst_alignment_bwd")) else ():
        panels = cs.alignment_panels("cuda", n, u, s_, waitk)
        want = align("rev", *panels)
        got = align("this", *panels, want[0].outs[0])
        torch.cuda.synchronize()
        for entry, names, i in (("simulst_alignment_fwd", ("alphas",), 0),
                                ("simulst_alignment_bwd",
                                 ("d_prefix", "d_denom"), 1)):
            if wanted(entry):
                report(entry, label, {n_: torch.equal(a, b) for n_, a, b in
                                      zip(names, got[i].outs,
                                          want[i].outs)})

    from simulst_tpu_torch.ops import conv_pos, ctc
    for dtype in dtypes if wanted("simulst_convpos_wgrad") else ():
        for b, t in CONVPOS_CASES:
            g = torch.Generator().manual_seed(b * 1000 + t)
            xp = torch.randn(b, t + 63, 256, generator=g).to(dtype).cuda()
            dy = torch.randn(b, t, 256, generator=g).to(dtype).cuda()
            outs = {}
            for key, lib in apis.items():
                with library_of(_build, lib):
                    outs[key] = conv_pos.convpos_wgrad(xp, dy, 64, 16)
            torch.cuda.synchronize()
            report("simulst_convpos_wgrad", f"{str(dtype)[6:]} (B, T) = "
                   f"({b}, {t})", {"dw": torch.equal(outs["rev"],
                                                     outs["this"])})

    from simulst_tpu_torch.ops import emformer_attn as ea
    for dtype in dtypes if (wanted("simulst_emformer_attn") or
                            wanted("simulst_emformer_attn_bwd")) else ():
        for b, fields in ATTN_CASES:
            geom = ea.AttnGeom(**fields)
            for rate in (0.0, 0.1):
                for gated in (False, True):
                    g = torch.Generator().manual_seed(b + geom.U)
                    q3, dout = (torch.randn(b, geom.ng, geom.nq, 256,
                                            generator=g).to(dtype).cuda()
                                for _ in range(2))
                    k, v = (torch.randn(b, geom.tk, 256, generator=g).to(
                        dtype).cuda() for _ in range(2))
                    lengths = torch.randint(geom.U // 2, geom.U + 1, (b,),
                                            generator=g).to(torch.int32)
                    gate = ea.EidGate(*(torch.randint(
                        0, 2, shape, generator=g).to(torch.int32).cuda()
                        for shape in ((b, geom.tk), (b, geom.n)))) \
                        if gated else None
                    attn_args = (q3, k, v, lengths.cuda())
                    outs = {}
                    for key, lib in apis.items():
                        with library_of(_build, lib):
                            outs[key] = (
                                ea.emformer_grouped_attention_forward(
                                    *attn_args, geom, rate, 23, gate),
                                *ea.emformer_grouped_attention_backward(
                                    *attn_args, dout, geom, rate, 23, gate))
                    torch.cuda.synchronize()
                    case = (f"{str(dtype)[6:]} B {b} U {geom.U} G {geom.G} "
                            f"rate {rate}{' gated' if gated else ''}")
                    same = [torch.equal(a, c) for a, c in
                            zip(outs["rev"], outs["this"])]
                    report("simulst_emformer_attn", case, {"out": same[0]})
                    if ea.bwd_plan(geom, 64, dtype) == "units":
                        report("simulst_emformer_attn_bwd", case,
                               dict(zip(("dq", "dk", "dv"), same[1:])))
                        continue
                    # bf16 on the tensor cores: dq within BF16_TOL of the
                    # plain backward, dk and dv within 1e-2 of their
                    # largest entry
                    bf16_report("simulst_emformer_attn_bwd", case,
                                ("dq", "dk", "dv"),
                                {key: o[1:] for key, o in outs.items()},
                                ea.grouped_attention_plain_backward(
                                    *attn_args, dout, geom, rate, 23, gate))

    for i, (label, t, b, s_, how) in enumerate(
            CTC_CASES if wanted("simulst_ctc_alpha")
            or wanted("simulst_ctc_d_em") else ()):
        inputs = ctc_inputs(torch, ctc, t, b, s_, how, 50 + i)
        want = ctc_entries(torch, _build, libs["rev"], *inputs)
        got = ctc_entries(torch, _build, libs["this"], *inputs,
                          *want[1].keep)
        torch.cuda.synchronize()
        if wanted("simulst_ctc_alpha"):
            report("simulst_ctc_alpha", label, {"alphas": torch.equal(
                want[0].outs[0], got[0].outs[0])})
        if wanted("simulst_ctc_d_em"):
            report("simulst_ctc_d_em", label, {"d_em": torch.equal(
                want[1].outs[0], got[1].outs[0])})

    # above S 1024 (several states a thread), this checkout alone (a
    # revision may refuse the shape): held to the plain DP, finite entries
    # within chip_smoke's F32_TOL, the -1e30 sentinels equal; d_em on the
    # kernel's alphas, 0 scale where the target cannot fit its frames
    for i, (label, t, b, s_, how) in enumerate(
            CTC_WIDE_CASES if wanted("simulst_ctc_alpha")
            or wanted("simulst_ctc_d_em") else ()):
        em, skip, il, tl, scale = ctc_inputs(torch, ctc, t, b, s_, how,
                                             70 + i)
        plain = ctc.alphas_plain(em, skip, il, tl)
        scale = torch.where(ctc._nll_from_alpha(plain[-1], tl)
                            <= -ctc.NEG / 2, scale, 0.0)
        alpha, d_em = ctc_entries(torch, _build, libs["this"], em, skip, il,
                                  tl, scale)
        got = alpha.outs[0]
        torch.cuda.synchronize()
        sent = plain <= ctc.NEG / 2
        report("simulst_ctc_alpha (vs plain)", label, {
            "sentinels equal": torch.equal(got <= ctc.NEG / 2, sent)
            and torch.equal(got[sent], plain[sent]),
            "finite within F32_TOL": bool(torch.isclose(
                got[~sent], plain[~sent], **cs.F32_TOL).all())})
        want = ctc.d_em_plain(em, got, skip, il, tl, scale,
                              ctc._nll_from_alpha(got[-1], tl))
        report("simulst_ctc_d_em (vs plain)", label, {
            "d_em within F32_TOL": bool(torch.isclose(
                d_em.outs[0], want, **cs.F32_TOL).all()),
            "posteriors": bool((scale != 0).any())})

    # determinism: this checkout's entries, twice on the same inputs
    with library_of(_build, libs["this"]):
        for entry, call in determinism_calls(torch).items():
            if not wanted(entry.split()[0]):
                continue
            first = [t.clone() for t in call()]
            second = call()
            torch.cuda.synchronize()
            report("determinism", entry,
                   {f"output {j}": torch.equal(a, b)
                    for j, (a, b) in enumerate(zip(first, second))})

    # the new widths, this checkout alone: two paths, or two calls
    with library_of(_build, libs["this"]):
        for entry, case, fn in width_cases(torch):
            if not wanted(entry.split()[0]):
                continue
            pairs = fn()
            torch.cuda.synchronize()
            report(f"widths {entry}", case,
                   {n: bf16_close(torch, a, b) if n.endswith("BF16_TOL")
                    else torch.equal(a, b) for n, (a, b) in pairs.items()})

    if args.time:
        from simulst_tpu_torch.ops import emformer_attn as ea
        times = {}
        x, ws, dy = ln_ffn_inputs(torch, 12288, torch.float32, 12288)
        ga = torch.Generator().manual_seed(19)
        attn_geom = ea.AttnGeom(U=256, seg=16, lc=32, rc=8, max_mem=5, G=8,
                                num_heads=4)
        attn_timed = (
            *(torch.randn(shape, generator=ga).cuda() for shape in (
                (32, attn_geom.ng, attn_geom.nq, 256),
                (32, attn_geom.tk, 256), (32, attn_geom.tk, 256))),
            torch.randint(192, 257, (32,), generator=ga).to(
                torch.int32).cuda())
        attn_dout = torch.randn(32, attn_geom.ng, attn_geom.nq, 256,
                                generator=ga).cuda()
        attn_timed_b = tuple(t.bfloat16() for t in attn_timed[:3]) + \
            attn_timed[3:]
        # row 3bg: asr-pack's packed rows, (16, 4, 175, 256) at G 7
        packed_geom = ea.AttnGeom(U=448, seg=16, lc=32, rc=8, max_mem=5, G=7,
                                  num_heads=4)
        packed_timed = (
            *(torch.randn(shape, generator=ga).bfloat16().cuda()
              for shape in ((16, 4, 175, 256), (16, packed_geom.tk, 256),
                            (16, packed_geom.tk, 256))),
            torch.full((16,), 448, dtype=torch.int32).cuda(),
            torch.randn(16, 4, 175, 256, generator=ga).bfloat16().cuda())
        packed_gate = cs.segment_gate(ea, packed_geom, 16, ga, "cuda")
        xb, wsb, dyb = ln_ffn_inputs(torch, 12288, torch.bfloat16, 12288)
        xm, wm, dym = ln_ffn_inputs(torch, 8192, torch.float32, 8192)
        # rows 2b / 4b in bf16: the FFN backward at asr-train's decoder
        # rows and the MT's, the linear-res backward at asr-train's shapes
        # and the MT's
        xdb, wdb, dydb = ln_ffn_inputs(torch, 2304, torch.bfloat16, 2304)
        xmb, wmb, dymb = (t.to(torch.bfloat16) if torch.is_tensor(t) else
                          tuple(w.to(torch.bfloat16) for w in t)
                          for t in (xm, wm, dym))
        xc, alpha, csum = cif_inputs(torch, 32, 256, 256, "sigmoid", 7)
        out = torch.empty(32, 72, 256, device="cuda")
        delays = torch.empty(32, 72, device="cuda")
        gl = torch.Generator().manual_seed(11)
        lr = {rows: [torch.randn(rows, 256, generator=gl).cuda()
                     for _ in range(2)] for rows in (2304, 8192, 12800)}
        wl = (torch.randn(256, 256, generator=gl) * 0.06).cuda()
        lrb = {rows: [t.to(torch.bfloat16) for t in pair]
               for rows, pair in lr.items()}
        wlb = wl.to(torch.bfloat16)
        mha_timed = {name: mha_case(i, torch.float32, 0.1)
                     for name, i in MHA_TIMED.items()}
        lr_timed = {name: (lr_inputs(rows, torch.float32, rows), period,
                           res_rows, linear_res.FWD_PATHS[
                               linear_res.fwd_plan(rows)])
                    for name, (rows, period, res_rows) in
                    LR_FWD_TIMED.items()}
        align_timed = {name: cs.alignment_panels("cuda",
                                                 *ALIGN_CASES[i][1:])
                       for name, i in ALIGN_TIMED.items()}
        gc = torch.Generator().manual_seed(13)
        conv_timed = (torch.randn(32, 319, 256, generator=gc).cuda(),
                      torch.randn(32, 256, 256, generator=gc).cuda())
        ctc_timed = ctc_inputs(torch, ctc, *CTC_CASES[0][1:], 50)
        d_em_timed = {s_: ctc_inputs(torch, ctc, 256, 32, s_, "ragged", s_)
                      for s_ in D_EM_TIMED_S}
        mha_fwd_timed = {}
        for name, (i, rate) in MHA_FWD_TIMED.items():
            _, b, tq, tk, causal, mask = MHA_FWD_CASES[i]
            q, k, v, _, kmask = mha_inputs(torch, b, tq, tk, mask,
                                           torch.float32, i)
            mha_fwd_timed[name] = (q, k, v, kmask, causal, rate,
                                   mha.FWD_PATHS[mha.fwd_plan(tq)])

        def entries(key):
            """The calls timed for one build: name -> fn()."""
            lib, tiled = libs[key], key == "this" or ref_takes_scratch

            def wrapped(fn, *a):
                def call():
                    with library_of(_build, apis[key]):
                        fn(*a)
                return call
            return {
                "ln_ffn_fwd_ms": ffn_fwd(key, 1, "gelu", x, ws, 0.1, tiled),
                "ffn_fwd_ms": ffn_fwd(key, 0, "relu", xm, wm, 0.1, tiled),
                "ffn_bwd_ms": ffn_bwd(key, xm, wm, dym, "relu", 0.1),
                # row 2b in bf16: this checkout's products on the tensor
                # cores, a parent's on the CUDA cores
                "ffn_bwd_bf16_ms": ffn_bwd(key, xdb, wdb, dydb, "gelu", 0.1),
                "ffn_bwd_bf16_8192_ms": ffn_bwd(key, xmb, wmb, dymb, "relu",
                                                0.1),
                "ln_ffn_bwd_ms": ln_ffn_bwd(key, x, ws, dy, "gelu", 0.1),
                # rows 1 / 1b in bf16: this checkout's products on the
                # tensor cores, a parent's on the CUDA cores
                "ln_ffn_fwd_bf16_ms": ffn_fwd(key, 1, "gelu", xb, wsb, 0.1,
                                              tiled),
                "ln_ffn_bwd_bf16_ms": ln_ffn_bwd(key, xb, wsb, dyb, "gelu",
                                                 0.1),
                "cif_c_entry_ms": cif_entry(lib, xc, alpha, csum, 72, 1.0,
                                            out, delays),
                **{f"linear_res_bwd{tag}_{rows}{gate}_ms": lr_bwd(
                    key, hl[rows][0], w_, hl[rows][1], period, res_rows, 0.1)
                   for tag, hl, w_ in (("", lr, wl), ("_bf16", lrb, wlb))
                   for rows, period, res_rows, gate in (
                       (8192, 0, 0, ""), (12800, 200, 192, "_gate"),
                       (2304, 0, 0, ""))},
                "emformer_attn_fwd_ms": wrapped(
                    ea.emformer_grouped_attention_forward, *attn_timed,
                    attn_geom, 0.1, 23),
                "emformer_attn_bwd_ms": wrapped(
                    ea.emformer_grouped_attention_backward, *attn_timed,
                    attn_dout, attn_geom, 0.1, 23),
                # rows 3b / 3bg in bf16: this checkout's on the tensor
                # cores, a parent's units backward on the CUDA cores
                "emformer_attn_bwd_bf16_ms": wrapped(
                    ea.emformer_grouped_attention_backward, *attn_timed_b,
                    attn_dout.bfloat16(), attn_geom, 0.1, 23),
                "emformer_attn_bwd_bf16_gated_ms": wrapped(
                    ea.emformer_grouped_attention_backward, *packed_timed,
                    packed_geom, 0.1, 23, packed_gate),
                # row 4 in bf16: this checkout's tiled paths on the tensor
                # cores, a parent's on the CUDA cores
                **{name.replace("linear_res", "linear_res_bf16"): lr_fwd(
                    key, *(t.bfloat16() for t in args), period, res_rows,
                    0.1, path)
                   for name, (args, period, res_rows, path) in
                   lr_timed.items() if path != linear_res.FWD_PATHS["rows"]},
                **{name: mha_bwd(key, *inputs)
                   for name, inputs in mha_timed.items()},
                **{name: lr_fwd(key, *args, period, res_rows, 0.1, path)
                   for name, (args, period, res_rows, path) in
                   lr_timed.items()},
                **{name: mha_fwd(key, *args)
                   for name, args in mha_fwd_timed.items()},
                **{name.format(half): call
                   for name, args in align_timed.items()
                   for half, call in zip(("fwd", "bwd"),
                                         align(key, *args))},
                "convpos_wgrad_ms": convpos_entry(torch, _build, lib,
                                                  *conv_timed),
                **dict(zip(("ctc_alpha_ms", "ctc_d_em_ms"), ctc_entries(
                    torch, _build, lib, *ctc_timed))),
                **{f"ctc_{half}_s{s_}_ms": call
                   for s_, inputs in d_em_timed.items()
                   for half, call in zip(("alpha", "d_em"), ctc_entries(
                       torch, _build, lib, *inputs))}}

        def timed(key):
            return {name: fn for name, fn in entries(key).items()
                    if wanted(next(e for p, e in TIMED_ENTRIES
                                   if name.startswith(p)))}

        for key in ("rev", "this", "this", "rev"):
            times.setdefault(key, []).append(
                {name: cs.cuda_ms(fn, samples=5, runs=5)
                 for name, fn in timed(key).items()})
        print("times " + json.dumps(times), flush=True)
        for key in libs:
            print(f"device_ms {key} " + json.dumps(
                {name[:-3]: device_ms(torch, fn, calls=3)
                 for name, fn in timed(key).items()}), flush=True)
        crossover = {}
        for rows in CROSSOVER_ROWS if wanted("simulst_ffn") else ():
            for ln_res, act in ((1, "gelu"), (0, "relu")):
                xs, wss, _ = ln_ffn_inputs(torch, rows, torch.float32, rows)
                crossover[f"ln_res {ln_res} rows {rows}"] = {
                    path: cs.cuda_ms(ffn_fwd("this", ln_res, act, xs, wss,
                                             0.0, path == "tiled"))
                    for path in ("fused", "tiled")}
        print("crossover_ms " + json.dumps(crossover), flush=True)
        # bf16: the tiled path on the tensor cores against the fused
        # kernel, which places ops/ffn.py's BF16_TILED_MIN_ROWS
        crossover = {}
        for rows in CROSSOVER_ROWS if wanted("simulst_ffn") else ():
            for ln_res, act in ((1, "gelu"), (0, "relu")):
                xs, wss, _ = ln_ffn_inputs(torch, rows, torch.bfloat16, rows)
                crossover[f"ln_res {ln_res} rows {rows}"] = {
                    path: cs.cuda_ms(ffn_fwd("this", ln_res, act, xs, wss,
                                             0.0, path == "tiled"))
                    for path in ("fused", "tiled")}
        print("crossover_bf16_ms " + json.dumps(crossover), flush=True)
        crossover = {}
        for rows in LR_CROSSOVER_ROWS if wanted("simulst_linear_res") else ():
            lr_args = lr_inputs(rows, torch.float32, rows)
            crossover[f"linear_res rows {rows}"] = {
                p: cs.cuda_ms(lr_fwd("this", *lr_args, 0, 0, 0.1, code))
                for p, code in linear_res.FWD_PATHS.items()}
        for tq in MHA_CROSSOVER_TQ if wanted("simulst_mha_fwd") else ():
            q, k, v, _, kmask = mha_inputs(torch, 40, tq, 256, "ragged",
                                           torch.float32, tq)
            crossover[f"mha_fwd Tq {tq}"] = {
                p: cs.cuda_ms(mha_fwd("this", q, k, v, kmask, False, 0.0,
                                      code))
                for p, code in mha.FWD_PATHS.items()}
        for name, (q, k, v, kmask, causal, rate, _) in (
                mha_fwd_timed.items() if wanted("simulst_mha_fwd") else ()):
            crossover[name] = {
                p: cs.cuda_ms(mha_fwd("this", q, k, v, kmask, causal,
                                      rate, code))
                for p, code in mha.FWD_PATHS.items()}
        print("forward_paths_ms " + json.dumps(crossover), flush=True)
        if wanted("simulst_ctc_alpha") or wanted("simulst_ctc_d_em"):
            wide = {}
            for s_ in CTC_WIDE_TIMED_S:   # this checkout's alone
                calls = ctc_entries(torch, _build, libs["this"], *ctc_inputs(
                    torch, ctc, 256, 32, s_, "ragged", s_))
                for half, call in zip(("alpha", "d_em"), calls):
                    wide[f"ctc_{half}_s{s_}_ms"] = cs.cuda_ms(call)
            print("ctc_wide_ms " + json.dumps(wide), flush=True)
            with library_of(_build, libs["this"]):
                print("ctc_chain_floor " + json.dumps(
                    cs.ctc_chain_floor("cuda")), flush=True)

    ok = all(s["all_equal"] for s in summary.values())
    print(json.dumps({"bitcheck": {"rev": args.rev, **summary}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
