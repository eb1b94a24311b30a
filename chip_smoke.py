#!/usr/bin/env python3
"""Smoke test of the simulst_tpu_torch port on one NVIDIA GPU: the
s2t_emformer serving slice, the MT-teacher training slice, the
s2t_emformer joint-CTC training slice, the MMA slice (training as
exp/2_mma.sh from that encoder, and its streaming READ/WRITE step) and the
CIF slice (training as exp/3_cif.sh from that encoder, and serving CIF and
MMA through the streaming evaluator, as cli/stream_eval does, one
utterance at a time and batched), the offline decoding of the MMA and CIF students and the MT teacher
(cli/generate), the sequence-packed ASR training of cli/train --pack and
the Transformer-Transducer (exp/6_transducer.sh: training, offline decode
and streaming), and the path from a MuST-C folder to a score (data
preparation, the remaining train options, s2t_transformer_convpos, the
fairseq loader, interactive and visualize), and bf16 compute with
per-layer remat and the remaining model options (post-LN, silu and tanh
FFNs, the VGG frontend; segmented_attention=False computes the segmented
attention, which the CPU tests hold against JAX's dense one).

Drives the PyTorch + CUDA port's main paths once at full width with random
weights from a seeded generator: serving at s2t_emformer_s width (conv
subsampler 80 -> 1024 -> 2x256, 12 x 256-dim Emformer with 4 heads and FFN
2048, segment/left/right context 16/32/8 frames after subsampling, 5
memory slots, 6-layer decoder, vocab 4100) on seeded synthetic audio, and
training at transformer_small width (MTConfig(): 256-d, 4 heads, 6 + 6
layers, FFN 2048 relu, vocab 8000, dropout 0.1) on seeded token batches,
ASR training of the full s2t_emformer_s with its CTC head (dropout,
attention and activation dropout 0.1, SpecAugment) on seeded synthetic
audio, and MMA training of MMAConfig() at full width (s2t_emformer_s
encoder, 6-layer monotonic decoder, infinite lookback with fixed
pre-decision ratio 8, mass preservation, DAL latency loss weight 0.1) and
CIF training of CIFConfig() at full width (that encoder with its CTC head,
the CIF layer, a 6-layer decoder with the position-aligned cross-attention;
exp/3_cif.sh's CTC factor 0.3 and quantity factor 1.0 with the alignment
targets):

  1. build    compile csrc/*.cu with nvcc (sm_90a) from this checkout;
              print the build time and the card's name and power limit
  2. kernels  each serving kernel vs its plain PyTorch version on the card,
              at the serving shapes (encoder and decoder step), in fp32 and
              bf16, with CUDA-event times; the decoder step's fused_mha
              and fused_linear_res and the offline encoder's gated
              fused_linear_res also with their bound, the path their plan
              picks, and SDPA's forward / the product through
              torch.matmul beside them
  3. offline  decode_batch on 8 utterances of 1024 fbank frames, beam 5,
              max_len 64; every serving kernel must have launched;
              encoder_out with kernels vs the same encoder through the
              plain versions
  4. stream   one utterance in 640 ms chunks through the encoder stepper,
              one greedy decoder_step per chunk; streaming encoder output
              must equal the offline encoder_forward
  5. train-kernels  the training kernels (fused_mha, fused_ffn,
              fused_linear_res, forward and backward) vs their plain
              versions at the MT shapes (64 x 128 tokens), at dropout 0 and
              at 0.1 with one seed (both sides then draw the same Philox
              mask); CUDA-event times, and SDPA's time beside fused_mha
              and its backward, the FFN and linear-res forward and
              backward beside their products through torch.matmul (fp32,
              TF32 off); the linear-res and MHA backwards also at the ASR
              step's shapes (12,800 gated and 2,304 rows; (32, 72, 72)
              causal and (32, 72, 256)); one bf16 case of each; the
              MHA forward also at the encoder's self-attention, each MHA
              forward beside SDPA's and the linear-res forward beside its
              product through torch.matmul, with their bounds
  6. train    8 Adam steps of mt_transformer through cli/train's loss and
              train/state's train step (lr 5e-4, warmup 4000, clip 10, as
              exp/0_mt.sh) on 64 sentence pairs of 96-128 tokens; losses
              finite, launches per step as the layer count predicts; 3
              more steps under torch.profiler: device time by kernel family
              and the top kernels; then one step at dropout 0, with gelu in
              place of relu, with the kernels and one through the plain
              versions from the same params, optimizer and batch: every
              parameter's gradient, their global norm, the loss and the
              updated parameters compared
  7. asr-kernels  the ASR training kernels (LN-FFN forward and backward,
              grouped attention forward and backward, the conv-pos weight
              gradient, the CTC alphas and d_em) vs their plain versions at
              the shapes of a 32 x 1024-frame batch, at dropout 0 and 0.1
              with one seed, bf16 cases of the LN-FFN and the attention;
              the CTC alphas also at S 33, 257, 1023, 1025 and 2049 (T
              256, B 32: the kernel's one-warp, halo and
              every-step-exchange blocks, and 2 and 4 states a thread),
              d_em at S 1025 and 2049, their registers and spills, and the
              CTC recursions' chain floor
              (one warp's dependent LSE pairs on registers, ms per step);
              CUDA-event times beside one PyTorch call of the same function
              (SDPA on the gathered context, conv1d_weight, F.ctc_loss), the
              LN-FFN forward and backward beside their two and five
              products through torch.matmul (fp32, TF32 off), and the
              backward's share of the fp32 peak; the linear-res and MHA
              forwards at the step's shapes (12,800 gated and 2,304 rows;
              (32, 72, 72) causal and (32, 72, 256), rate 0.1) vs plain,
              beside their product through torch.matmul / SDPA's forward
  8. asr-train  8 Adam steps of s2t_emformer_s with joint CTC through
              cli/train's model and loss and train/state's step (lr 1e-3,
              warmup 10000, clip 10, as exp/1a_pretrain_asr.sh) on 32
              utterances of 717-1024 frames with 38-64 target tokens;
              losses finite, launches per step as the layer count predicts;
              3 profiled steps (with the grouped attention's forward +
              backward device ms per step); then one step at dropout 0
              without SpecAugment, kernels vs plain versions from the same
              params and batch
  9. mma-kernels  the MMA alignment recursion's forward and backward
              kernels vs their plain versions at the recipe's pooled shape
              (N = B H 128, U 72, S 32), unpooled (S 256), ragged (S 29,
              U 1), S 33 and S 257 (the edges of a 32-position group and
              of a 256-position tile) and on wait-k's one-hot rows;
              CUDA-event times, ms per dependent step (ms / U) and each
              kernel's registers and spills from nvcc's ptxas report
 10. mma-train  8 Adam steps of MMAConfig() with exp/2_mma.sh's options
              through cli/train's parse_args, build_model and build_loss,
              the encoder loaded from phase 8's trained encoder through
              --load-pretrained-encoder-from (lr 5e-4, warmup 4000, clip
              10) on phase 7's batch; losses finite, launches per step as
              the layer count predicts; 3 profiled steps; then one step at
              dropout 0 without noise, kernels vs plain versions from the
              same params and batch
 11. mma-stream  one 1024-frame utterance in 640 ms chunks through
              make_mma_fused_step with phase 10's weights; its tokens must
              equal those of the step-wise mma_decoder_step / adopt_on_read
              loop on the card
 12. cif-kernels  the CIF integrate-and-fire kernel vs its plain version
              at the train batch's shape (B 32, S 256, C 256, T 72), a
              streaming chunk (1, 17, 256, T 19), ragged (S 29, T 1), more
              than 128 buckets (S 512, T 300) and beta 0.8; CUDA-event
              times (the wrapper and the C entry alone) beside torch.bmm on
              a pre-built portion tensor, and the host time per call of the
              wrapper and of torch.bmm
 13. cif-train  8 Adam steps of CIFConfig() with exp/3_cif.sh's options
              through cli/train's parse_args, build_model and build_loss,
              the encoder loaded from phase 8's through
              --load-pretrained-encoder-from (lr 5e-4, warmup 4000, clip
              10) on phase 7's batch; losses finite, launches per step as
              the layer count predicts; 3 profiled steps; then one step at
              dropout 0 without SpecAugment, kernels vs plain versions
 14. cif-serve  stream/evaluator.evaluate over two 1024-frame synthetic
              utterances (int16, global CMVN from their own fbank) with a
              fused CIFAgent and a fused MMAAgent built by
              stream/build.build_agent from the checkpoints of phases 13
              and 10; the fused sessions' tokens must equal the step-wise
              sessions'; ms per chunk, AL / AP / DAL, CIF launches per
              chunk
 15. batched-serve  stream/evaluator.evaluate_batched (cli/stream_eval
              --fused --batch-size / --scan-sessions) with fused CIF and
              MMA agents from the checkpoints of phases 13 and 10 (EOS's
              row shrunk 10x) over 72 synthetic int16 utterances: 64 of one
              16-chunk bucket (9.94-10.58 s, every final chunk of its own
              size, one with no new fbank frame) and 8 of a 7-chunk bucket
              (4.2-4.8 s), global CMVN from their own fbank; `evaluate` at
              B = 1 over a subset of 12 (both buckets, the shortest and
              longest final chunks), `evaluate_batched` at B 8 step-wise
              over it, at B 64 scanned over all 72 and its step-wise _CA
              pass; every batched example's tokens equal its B = 1 tokens
              but for proven argmax ties (the B = 1 top-two logit gap at
              the first differing token under 1e-4, replayed; outside the
              subset, where B 64 scanned and step-wise differ); the B 64
              encoder_step with feat_valid vs each example's offline
              encoder alone; LN-FFN at 192 and 1,536 streaming rows, the
              FFN at 8 and 64 rows and cif_integrate at the B 64 chunk and
              ragged-flush shapes vs their plain versions; ms per chunk,
              utterances per second and launches per chunk at B 1, 8 and
              64, the device's busy share of one profiled B 64 chunk
 16. offline-decode  cli/generate's offline decoding of the trained
              students and teacher, beam 5, max_len 64: decode_batch for
              MMA (phase 10's weights) and CIF (phase 13's) on phase 3's 8
              x 1024-frame batch, decode_batch_mt for the MT teacher
              (phase 6's) on phase 6's 64 sources; for each the kernels
              that must launch (counters), ms per batch, and the best
              hypotheses, each repeated per beam (the decode's own B x 5
              rows), fed back through the decoder step with the kernels
              and through the plain versions, logits compared at every
              step; then cli/generate.main on a synthetic manifest
              (phase 13's checkpoint, --task asr --scoring wer), its SCORE
              line printed
 17. asr-pack  the grouped attention's example-id gate (forward and
              backward kernels) vs the plain version with the gate, at the
              packed plans of phase 7's batch and of a mixed 96-1024-frame
              batch, at dropout 0 and 0.1; CUDA-event times beside the
              ungated kernel at the same shapes and SDPA on the gathered
              context with the gate in its mask; then 8 Adam steps of
              s2t_emformer_s with joint CTC through cli/train's parse_args
              (--pack), build_model, build_loss and attach_pack_plan on
              phase 7's batch: losses finite, launches per step as the
              layer count predicts (the gated kernels, not the dense
              ones); 3 profiled steps (the gated attention's forward +
              backward device ms per step); one step at dropout 0 without
              SpecAugment, packed vs unpacked from the same parameters
              (encoder output on valid frames, loss, every gradient); and
              kernels vs plain versions on that packed step
 18. transducer  rows 5 / 5b and 2 / 2b vs their plain versions at the
              label encoder's shapes ((16, 73, 73) causal; 1,168 rows;
              the decode step's 40 and 8 rows) with CUDA-event times,
              SDPA / the products through torch.matmul and bounds; then 8
              Adam steps of TransducerConfig() with exp/6_transducer.sh's
              options (FastEmit 0.01, offline factor 1, lr 5e-4, warmup
              4000, clip 10) through cli/train, the encoder from phase
              8's checkpoint, on 16 of phase 7's utterances (what
              --max-tokens 20000 takes): losses finite, launches per step
              as the layer count predicts, peak memory per step, 3
              profiled steps (the lattice's log-softmax and the RNN-T
              loop's logaddexp named apart), the loss side of a step by
              part (the joiner, the log-softmax, the RNN-T loss, the
              criterion; CUDA events) and one step at dropout 0 kernels
              vs plain; decode_batch greedy and at beam 5 on phase 3's
              batch, the best hypotheses fed back through the
              decode step with the kernels and the plain versions; then
              the trained checkpoint served through build_agent: test-time
              scales of the blank's and EOS's probabilities (searched on
              the first utterance: it writes before its source ends and,
              where it can, ends on EOS; logged), one utterance fused ==
              step-wise, evaluate at B = 1 and evaluate_batched at B 8
              step-wise and scanned over 16 utterances (tones under an
              on / off envelope), tokens == B = 1 but for proven ties (a
              top-two gap or a blank-vs-non-blank frame margin under
              1e-4, replayed at B = 1); fails on AP 1, on every utterance
              truncated, or on no B 8 mid-stream chunk whose examples
              write different counts; ms per chunk and utterances per
              second
 19. data     data to score: a seeded synthetic MuST-C tree (two talks
              per split, 96 train and 8 dev segments of 2-12 s of int16
              tones, the segment list, transcripts and translations)
              prepared by cli/prep_mustc (fbank on the card, the native
              unigram SPM with the sentencepiece package blocked, gcmvn.npz,
              the data config); cli/train --task
              st --model s2t_emformer --loss joint_ctc --mtl
              --encoder-freezing-updates 2 --tensorboard --profile for 4
              updates at full width through the native batch loader (the
              encoder unchanged after updates 1-2 and moved by update 3,
              the events and the trace written); fused_mha forward and
              backward vs plain at s2t_transformer_convpos's encoder
              shape ((32, 256, 256) with the key mask, rate 0.1) with
              CUDA-event times, SDPA's and bounds; one
              s2t_transformer_convpos train step on phase 7's batch
              (launches per step as the layer count predicts, 3 profiled
              steps, one step at dropout 0 kernels vs plain) and a beam-5
              decode of phase 3's batch, its logits along the best
              hypotheses kernels vs plain; a fairseq state dict of each of
              s2t_emformer, MMA, CIF and the transducer at full width
              written with torch.save, loaded by compat/fairseq_converter
              into a model of other weights: every parameter equal and
              the beam-5 tokens on phase 3's batch equal; cli/interactive
              on two dev segments with the trained checkpoint and
              cli/visualize on a CIF checkpoint (`python3
              tools/data_smoke.py`: this phase with phases 3 and 7's
              batches only)
 20. bf16     bf16 compute and the model options: fused_ffn and
              fused_ln_ffn_res with silu and tanh (and gelu beside
              them), forward and backward, fp32 and bf16, vs plain
              at 12,288 and 40 rows with CUDA-event times; rows 1 / 1b,
              2b and 4b in bf16 on the tensor cores (their wgmma kernels'
              SASS holds HGMMA, those of rows 2b / 4b among them, no
              other kernel's does; asr-train's shapes at every activation
              (rows 2b / 4b: gelu and relu) and rates 0 / 0.1, D 200 and
              D 512 (rows 2b / 4b: rate 0.1), vs plain, twice bit for bit
              (rows 2b / 4b: at rate 0.1)); rows 1-6 in bf16 at
              asr-train's shapes (times, plain, bounds at the dense bf16
              peak, SDPA or the products' torch.matmul); the seconds of
              each part of the phase; asr-train with --override
              compute_dtype=bfloat16 through cli/train's config path for
              8 steps (launches per step as phase 8's, median, 3 profiled
              steps, peak memory beside phase 8's fp32 numbers), one step
              at dropout 0 kernels vs plain, and the same step with
              --override remat=true vs without under PyTorch's
              deterministic algorithms (both peaks); s2t_emformer_s in
              bf16 served: the offline batch at beam 5 (its tokens beside
              phase 3's fp32 tokens) and the streaming chunk at B = 1,
              streaming vs offline; one bf16 and one fp32 step each of
              MMA, CIF and the transducer (device ms, peak memory); a
              4-layer post-LN and silu Emformer, a post-LN decoder
              and the VGG frontend, forward and backward, kernels vs plain
              (`python3 tools/bf16_smoke.py`: this phase with phases 3, 7
              and 8 only)
 21. parallel  two ranks spawned by comm.spawn (each on its own
              card over NCCL; where the machine has one card, both share
              it over gloo, which the phase prints first, with the
              ranks and the card count): the dry run's cases at its tiny
              width (multichip.dryrun_rank: data-parallel updates with a
              NaN skip, seq-sharded and pipelined Emformer, sharded BLEU /
              WER, sharded CIF streaming, multi-host input), then at full
              width: a data-parallel asr-train step on phase 7's batch
              (16 utterances per rank) against the one-process step from
              the same parameters, the same with fc1 / fc2 /
              emb_to_key_value split over 2 model ranks, the 12 layers in 2
              pipeline stages through pipelined_train_loss on that batch,
              the seq-sharded encoder on the 1024-frame bucket (U 256 = 2
              ranks x 8 segments of 16), and fused CIF serving of 8
              sessions over the 2 ranks; each rank's kernel launches
              (`python3 tools/parallel_smoke.py`: this phase with phase
              7's batch only).  Two ranks on one card are no scaling
              figure: the phase proves equality, not speed
 22. widths   the kernels at every width the JAX package trains: rows
              1-6 against their plain versions at the corners (D 64 /
              128 / 512 / 1024 / 1280 / 2048, head dims 16 / 32 / 64 /
              128 / 160 / 256, hidden up to 4096, conv-pos 4 / 64 / 1 /
              96 / 128 channels a group; training
              and decode rows, fp32 and bf16, dropout 0 and 0.1), their
              times at D 512 / 8 heads / FFN 2048 on phase 7's shapes
              beside bound, plain and library call, one s2t_emformer
              step at embed_dim 512 (launches counted: every
              width-dependent kernel must launch; kernels vs plain at
              phase 8's bounds), tools/synthetic_smoke.py's CIF leg
              through the CLIs at 400 updates (BLEU > 20, AL > 0) and
              the kernel
              convergence trajectory (30 Adam steps, kernels vs plain:
              both losses under 0.8 of the first, deviation under 0.03,
              pre-softmax scores under 40) (`python3
              tools/widths_smoke.py`: this phase with phase 7's batch)
 23. report   a JSON line of per-kernel numbers with their bounds (and
              each width kernel's D 512 times), the nvidia-smi line, and
              {"ok": true, "device": {...}} last

Run from the repository root:  python3 chip_smoke.py
It exits non-zero without a CUDA device, without the package beside it,
or when any phase fails.  Tolerances:
  fp32 kernel vs plain   atol 1e-4, rtol 1e-4 (only the order of sums
                         differs); weight gradients within 1e-4 of their
                         largest entry
  bf16 kernel vs plain   atol 3e-2, rtol 1e-2 (LN-scale outputs rounded to
                         bf16: a flip of the last rounding is 2^-8 relative);
                         bf16 weight gradients within 1e-2 of their largest
                         entry; the bf16 LN-FFN backward with relu against
                         the plain backward under the kernel's relu mask
                         (relu' jumps at 0, where the two sides' roundings
                         of u may fall either way); in bf16 the tiled FFN
                         forward (tensor cores) and the fused one (CUDA
                         cores) agree within these, not bit for bit
  CTC alphas           finite entries atol 1e-4, the -1e30 sentinels
                         equal
  MMA alignment        alphas atol 1e-4; d_prefix and d_denom within 1e-4
                         of their largest entries
  offline encoder_out, kernels vs plain, fp32: atol 1e-4
  streaming vs offline encoder output, fp32:   atol 1e-4
  train step, kernels vs plain, fp32, dropout 0, gelu: each parameter's
                         gradient within 1e-4 of its largest entry (of its
                         weight's for a key bias, whose exact gradient is
                         0); gradient norm and loss rtol 1e-5; updated
                         parameters atol 1e-5 (an update is at most lr ~
                         1e-6 here, so this last check alone would not see
                         a wrong gradient); the ASR step the same, at
                         dropout 0 without SpecAugment (gelu throughout),
                         the MMA step at dropout 0 without p_choose noise
  MMA streaming tokens, fused step vs step-wise loop: equal
  offline decode (MMA, CIF, MT) logits along the best hypotheses,
                         kernels vs plain, fp32: atol 1e-4, rtol 1e-4
  CIF integrate-and-fire out and delays within 1e-5 of their largest
                         entries (the same cumsums on both sides; only the
                         order of the sums over frames differs)
  CIF train step, kernels vs plain: as the ASR step
  CIF and MMA serving tokens, fused sessions vs step-wise sessions: equal
  batched serving tokens (B 8, B 64 scanned and step-wise) vs B = 1: equal
                         but for argmax ties (top-two gap under 1e-4 on
                         the B = 1 state); the B 64 encoder with
                         feat_valid vs each example alone: atol 1e-4
  packed vs unpacked ASR step, fp32, dropout 0, no SpecAugment: encoder
                         output on valid frames atol 1e-4, loss rtol
                         1e-5, every gradient within 2e-4 of its largest
                         entry (the layouts sum in other orders)
  packed ASR step, kernels vs plain: as the ASR step, but the gradient
                         norm is logged, not limited (its rounding floor
                         on this model reaches 2.1e-5 relative)
  s2t_transformer_convpos train step, kernels vs plain: as the ASR
                         step; its decode logits as phase 16's
  fairseq-loaded models: every parameter equal (torch.equal) to the
                         weights it was written from; decode tokens equal
  transducer train step, kernels vs plain: as the ASR step; its offline
                         decode logits along the best hypotheses as
                         phase 16's; its streaming tokens, fused vs
                         step-wise: equal; B 8 vs B = 1: equal but for
                         argmax ties (top-two gap under 1e-4, replayed)
  bf16 train step (asr-train, dropout 0), kernels vs plain: the loss
                         finite, every gradient within 5e-2 of its
                         largest entry (BF16_STEP_TOL)
  bf16 remat vs no remat: bit for bit under deterministic algorithms,
                         else within BF16_STEP_TOL
  bf16 streaming vs the bf16 offline encoder output: atol 0.1
                         (BF16_STREAM_ATOL)
  model options (post-LN, silu, post-LN decoder), fp32: outputs
                         atol 1e-4, gradients within 1e-4 of their largest
                         entry; VGG on the card vs the CPU atol 1e-4
  parallel, fp32, dropout 0, against the one-process path from the same
                         parameters: losses rtol 1e-5, every gradient and
                         the seq-sharded output within 1e-4 of its largest
                         entry (of its weight's for a key bias), the
                         data-parallel ranks' parameters bit for bit equal
                         after the update, an update's loss and norm rtol
                         1e-4 and its parameters within twice its learning
                         rate (Adam moves an entry whose gradient is
                         rounding noise by up to that, either way); the
                         sharded serving tokens and the sharded BLEU / WER
                         statistics equal; the dry run's own limits
                         (multichip.dryrun_rank)
The bound of a kernel is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its operations (on this
run's visible pairs, for attention) over the peak of an H100 SXM at 700 W
for its inputs' type: 67 TFLOP/s on fp32 (CUDA cores), 989 TFLOP/s on
bf16 (dense tensor cores).
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from types import SimpleNamespace

import numpy as np

SEED = 0
N_UTT, N_FRAMES, BEAM, MAX_LEN = 8, 1024, 5, 64
MT_PAIRS, MT_MIN_LEN, MT_MAX_LEN, MT_STEPS = 64, 96, 128, 8
MT_ARGS = ["--task", "mt", "--model", "mt_transformer", "--loss", "ce",
           "--lr", "5e-4", "--warmup-updates", "4000", "--clip-norm", "10",
           "--seed", str(SEED)]
ASR_UTT, ASR_MIN_FRAMES, ASR_FRAMES, ASR_STEPS = 32, 717, 1024, 8
ASR_MIN_TOKENS, ASR_MAX_TOKENS, ASR_TOKEN_BUCKET = 38, 64, 72
ASR_VOCAB = 4100
MMA_STEPS, MMA_MAX_TOKENS = 8, 128
MMA_ARGS = ["--task", "st", "--model", "mma", "--loss", "mma",
            "--override",
            "simul_attn_type=infinite_lookback_fixed_pre_decision",
            "--override", "fixed_pre_decision_ratio=8",
            "--override", "mass_preservation=true",
            "--loss-override", "latency_avg_weight=0.1",
            "--loss-override",
            "latency_avg_type=differentiable_average_lagging",
            "--lr", "5e-4", "--warmup-updates", "4000", "--clip-norm", "10",
            "--seed", str(SEED)]
CIF_STEPS = 8
CIF_ARGS = ["--task", "st", "--model", "cif", "--loss", "cif",
            "--override", "cif_beta=1.0", "--override", "ctc_layer=true",
            "--loss-override", "ctc_factor=0.3",
            "--loss-override", "quant_factor=1.0",
            "--loss-override", "quant_type=align",
            "--lr", "5e-4", "--warmup-updates", "4000", "--clip-norm", "10",
            "--seed", str(SEED)]
SERVE_UTT = 2
ASR_ARGS = ["--task", "asr", "--model", "s2t_emformer", "--loss",
            "joint_ctc", "--override", "ctc_layer=true", "--lr", "1e-3",
            "--warmup-updates", "10000", "--clip-norm", "10", "--seed",
            str(SEED)]
F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=3e-2, rtol=1e-2)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM
FP32_FLOP_PER_S = 67e12        # H100 SXM, CUDA cores
BF16_FLOP_PER_S = 989e12       # H100 SXM, dense tensor cores

# name -> (module, source, the TPU kernel it replaces (the function that
# reaches pl.pallas_call), the slice whose main path reports it)
KERNELS = {
    "fused_ln_ffn_res": ("ffn", "simulst_tpu_torch/csrc/ffn.cu",
                         "simulst_tpu/ops/ffn_pallas.py:436", "serving"),
    "emformer_grouped_attention": (
        "emformer_attn", "simulst_tpu_torch/csrc/emformer_attn.cu",
        "simulst_tpu/ops/emformer_attn_pallas.py:336", "serving"),
    "fused_ffn": ("ffn", "simulst_tpu_torch/csrc/ffn.cu",
                  "simulst_tpu/ops/ffn_pallas.py:202", "training"),
    "fused_ffn_backward": ("ffn", "simulst_tpu_torch/csrc/ffn_bwd.cu",
                           "simulst_tpu/ops/ffn_pallas.py:230", "training"),
    "fused_linear_res": ("linear_res", "simulst_tpu_torch/csrc/linear_res.cu",
                         "simulst_tpu/ops/linear_res_pallas.py:102",
                         "training"),
    "fused_linear_res_backward": (
        "linear_res", "simulst_tpu_torch/csrc/linear_res.cu",
        "simulst_tpu/ops/linear_res_pallas.py:132", "training"),
    "fused_mha": ("mha", "simulst_tpu_torch/csrc/mha.cu",
                  "simulst_tpu/ops/mha_pallas.py:192", "training"),
    "fused_mha_backward": ("mha", "simulst_tpu_torch/csrc/mha.cu",
                           "simulst_tpu/ops/mha_pallas.py:208", "training"),
    "fused_ln_ffn_res_backward": ("ffn", "simulst_tpu_torch/csrc/ln_ffn_bwd.cu",
                                  "simulst_tpu/ops/ffn_pallas.py:466",
                                  "asr-training"),
    "emformer_grouped_attention_backward": (
        "emformer_attn", "simulst_tpu_torch/csrc/emformer_attn.cu",
        "simulst_tpu/ops/emformer_attn_pallas.py:369", "asr-training"),
    "convpos_wgrad": ("conv_pos", "simulst_tpu_torch/csrc/conv_pos.cu",
                      "simulst_tpu/ops/conv_pos_pallas.py:58",
                      "asr-training"),
    "ctc_alphas": ("ctc", "simulst_tpu_torch/csrc/ctc.cu",
                   "simulst_tpu/ops/ctc.py:465", "asr-training"),
    "ctc_d_em": ("ctc", "simulst_tpu_torch/csrc/ctc.cu",
                 "simulst_tpu/ops/ctc.py:492", "asr-training"),
    "alignment_fwd": ("monotonic_align", "simulst_tpu_torch/csrc/monotonic.cu",
                      "simulst_tpu/ops/monotonic_pallas.py:146",
                      "mma-training"),
    "alignment_bwd": ("monotonic_align", "simulst_tpu_torch/csrc/monotonic.cu",
                      "simulst_tpu/ops/monotonic_pallas.py:167",
                      "mma-training"),
    "cif_integrate": ("cif_integrate", "simulst_tpu_torch/csrc/cif.cu",
                      "simulst_tpu/ops/cif_pallas.py:61", "cif-training"),
    # the has_eid branches of the grouped attention: the same wrappers with
    # a gate, counted on their gated_launches
    "emformer_grouped_attention_gated": (
        "emformer_attn", "simulst_tpu_torch/csrc/emformer_attn.cu",
        "simulst_tpu/ops/emformer_attn_pallas.py:224", "asr-pack"),
    "emformer_grouped_attention_gated_backward": (
        "emformer_attn", "simulst_tpu_torch/csrc/emformer_attn.cu",
        "simulst_tpu/ops/emformer_attn_pallas.py:259", "asr-pack"),
}
SERVING_KERNELS = ("fused_ln_ffn_res", "emformer_grouped_attention",
                   "fused_ffn", "fused_linear_res", "fused_mha")
# launches per MT training step: 6 encoder self-attention cores, 6 decoder
# self- and 6 cross-attention cores; 6 decoder FFNs; 12 decoder epilogues
MT_LAUNCHES_PER_STEP = {"fused_mha": 18, "fused_mha_backward": 18,
                        "fused_ffn": 6, "fused_ffn_backward": 6,
                        "fused_linear_res": 12,
                        "fused_linear_res_backward": 12}
# launches per ASR training step: 12 Emformer layers (LN-FFN, grouped
# attention, its epilogue), 6 decoder layers (2 attention cores and 2
# epilogues each, one FFN), one conv-pos, one CTC loss
ASR_LAUNCHES_PER_STEP = {
    "fused_ln_ffn_res": 12, "fused_ln_ffn_res_backward": 12,
    "emformer_grouped_attention": 12,
    "emformer_grouped_attention_backward": 12,
    "emformer_grouped_attention_gated": 0,
    "emformer_grouped_attention_gated_backward": 0,
    "fused_linear_res": 24, "fused_linear_res_backward": 24,
    "fused_mha": 12, "fused_mha_backward": 12,
    "fused_ffn": 6, "fused_ffn_backward": 6,
    "convpos_wgrad": 1, "ctc_alphas": 1, "ctc_d_em": 1}
# launches per packed ASR training step: the ASR step's, with the 12
# Emformer layers' attention cores in the gated kernels
PACK_LAUNCHES_PER_STEP = {
    **ASR_LAUNCHES_PER_STEP,
    "emformer_grouped_attention": 0,
    "emformer_grouped_attention_backward": 0,
    "emformer_grouped_attention_gated": 12,
    "emformer_grouped_attention_gated_backward": 12}
PACK_MIXED_MIN_FRAMES = 96
# launches per MMA training step: the encoder's as in ASR training but no
# CTC head; 6 decoder layers, each one self-attention core, two epilogues
# (self-attention and monotonic attention out-projections), one FFN and
# one alignment recursion
MMA_LAUNCHES_PER_STEP = {
    "fused_ln_ffn_res": 12, "fused_ln_ffn_res_backward": 12,
    "emformer_grouped_attention": 12,
    "emformer_grouped_attention_backward": 12,
    "fused_linear_res": 24, "fused_linear_res_backward": 24,
    "fused_mha": 6, "fused_mha_backward": 6,
    "fused_ffn": 6, "fused_ffn_backward": 6,
    "convpos_wgrad": 1, "ctc_alphas": 0, "ctc_d_em": 0,
    "alignment_fwd": 6, "alignment_bwd": 6}
# launches per CIF training step: the ASR step's encoder and CTC loss; 6
# decoder layers, each one self-attention core, two epilogues (the
# self-attention's and the position-aligned cross-attention's
# out-projections) and one FFN; one integrate-and-fire (its backward is the
# plain version's, as in the JAX package)
CIF_LAUNCHES_PER_STEP = {
    "fused_ln_ffn_res": 12, "fused_ln_ffn_res_backward": 12,
    "emformer_grouped_attention": 12,
    "emformer_grouped_attention_backward": 12,
    "fused_linear_res": 24, "fused_linear_res_backward": 24,
    "fused_mha": 6, "fused_mha_backward": 6,
    "fused_ffn": 6, "fused_ffn_backward": 6,
    "convpos_wgrad": 1, "ctc_alphas": 1, "ctc_d_em": 1,
    "alignment_fwd": 0, "alignment_bwd": 0, "cif_integrate": 1}
# kernels the streaming evaluator's fused CIF and MMA sessions must launch
CIF_SERVE_KERNELS = ("fused_ln_ffn_res", "fused_ffn", "cif_integrate")
PROFILE_STEPS = 3
# ctc_d_em's posterior pass, launched while the beta kernel runs (PDL): the
# profiler times it from its launch, the wait for the beta kernel included,
# so its family stands apart and the device time per step leaves it out
POSTERIOR_FAMILY = "ctc_d_em posterior (timed from launch, its wait included)"
# kernel-name fragments -> family in phase 6's profile, first match wins
# (the port's kernels of csrc/*.cu and the products of common.cuh before
# cuBLAS, whose names hold "gemm"; the tile_products of csrc/ffn*.cu and
# csrc/linear_res.cu by the store functor or caller tag in their names)
KERNEL_FAMILIES = (
    ("HiddenStore<", "FFN forwards' hidden products"),
    ("TagFfnFwd", "FFN forwards' output products"),
    ("TagLnFfnBwd", "fused_ln_ffn_res_backward products"),
    ("TagLinearResFwd", "fused_linear_res"),
    ("TagLinearResBwd", "linear_res backward products, the backwards' sums"),
    ("TagFfnBwd", "fused_ffn_backward products"),
    ("CastStore<", "fused_ffn_backward products"),
    ("hidden_grad_kernel",
     "bf16 FFN and LN-FFN backwards' hidden-gradient pass"),
    ("mha_fwd_kernel", "fused_mha"), ("mha_decode_kernel", "fused_mha"),
    *((k, "fused_mha_backward") for k in (
        "mha_bwd_delta_kernel", "mha_bwd_dkdv_kernel", "mha_bwd_dq_kernel")),
    ("grouped_attn_kernel", "emformer_grouped_attention"),
    ("grouped_attn_", "emformer_grouped_attention_backward"),
    ("ln_rows_kernel", "LN-FFN LN rows (forward and backward)"),
    ("ln_bwd_rows_kernel", "fused_ln_ffn_res_backward (LN rows)"),
    ("convpos_wgrad", "convpos_wgrad"), ("ctc_alpha_kernel", "ctc_alphas"),
    ("ctc_beta_kernel", "ctc_d_em"), ("ctc_alpha_wide", "ctc_alphas"),
    ("ctc_beta_wide", "ctc_d_em"),
    ("ctc_posterior_kernel", POSTERIOR_FAMILY),
    ("alignment_fwd_kernel", "alignment_fwd"),
    ("alignment_bwd_kernel", "alignment_bwd"),
    ("cif_integrate_kernel", "cif_integrate"),
    ("ffn_partial_kernel<float, true", "fused_ln_ffn_res"),
    ("ffn_epilogue_kernel<float, true", "fused_ln_ffn_res"),
    ("ffn_partial_kernel<__nv_bfloat16, true", "fused_ln_ffn_res"),
    ("ffn_epilogue_kernel<__nv_bfloat16, true", "fused_ln_ffn_res"),
    ("ffn_partial_kernel", "fused_ffn"), ("ffn_epilogue_kernel", "fused_ffn"),
    ("linear_res_rows_kernel", "fused_linear_res"),
    ("linear_res_epilogue_kernel", "fused_linear_res"),
    *((k, "linear_res backward products, the backwards' sums")
      for k in ("colsum_partial_kernel", "sum_splits_kernel",
                "drop_grad_kernel")),
    *((k, "cuBLAS products") for k in ("gemm", "xmma", "cutlass")))
# the grouped attention's families (forward; backward block kernel and
# ordered sum), summed per step in each profile line
ATTENTION_FAMILIES = ("emformer_grouped_attention",
                      "emformer_grouped_attention_backward")
ALIGNMENT_FAMILIES = ("alignment_fwd", "alignment_bwd")


def log(tag, **fields):
    print(f"{tag} " + json.dumps(fields), flush=True)


def max_err(name, out, ref, atol, rtol):
    """Max |out - ref|; raise if any element is beyond atol + rtol |ref|."""
    import torch
    out, ref = out.float(), ref.float()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise AssertionError(f"{name}: shape {tuple(out.shape)} vs "
                             f"{tuple(ref.shape)} or non-finite output")
    err = (out - ref).abs()
    if (err > atol + rtol * ref.abs()).any():
        raise AssertionError(f"{name}: max_abs_err {err.max().item():.3e} "
                             f"beyond atol {atol} rtol {rtol}")
    return err.max().item()


def max_err_to_largest(name, out, ref, rtol=1e-4):
    """Max |out - ref|; raise unless within rtol of the largest |ref|."""
    err = (out.float() - ref.float()).abs().max().item()
    if not err <= rtol * ref.float().abs().max().item():
        raise AssertionError(f"{name}: max_abs_err {err:.3e} beyond {rtol} "
                             "of the largest entry")
    return err


def cuda_ms(fn, samples=7, runs=10, warmup=3):
    """Median over `samples` of the CUDA-event time of `runs` back-to-back
    calls of fn(), divided by `runs` (after warm-up)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / runs)
    return statistics.median(times)


def host_ms(fn, calls=200):
    """Host time per call of fn() (what the host spends to enqueue it),
    the device synchronised before and after but not inside."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e3


def bound(nbytes, flops, dtype=None):
    """(least ms, what bounds it) for moving nbytes and doing flops on
    inputs of `dtype`: at the bf16 / fp16 peak for 16-bit inputs, else at
    the fp32 one."""
    peak = BF16_FLOP_PER_S if str(dtype) in ("torch.bfloat16",
                                             "torch.float16") \
        else FP32_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def matmul_yardstick(x, w1, w2, dy=None):
    """ms of an FFN's products through torch.matmul on fp32 operands of the
    kernel's shapes, TF32 off (run() sets allow_tf32 False): the forward's
    two (x W1, h W2), or with dy the backward's five.  A yardstick, not a
    library time: no PyTorch call computes the fused function."""
    import torch
    assert not torch.backends.cuda.matmul.allow_tf32
    gm = torch.Generator(device=x.device).manual_seed(SEED + 9)
    a, b = (torch.randn(x.shape[0], w1.shape[1], device=x.device,
                        generator=gm) for _ in range(2))

    def forward():
        torch.matmul(x, w1)
        torch.matmul(a, w2)

    def backward():
        torch.matmul(x, w1)
        torch.matmul(dy, w2.T)
        torch.matmul(a, w1.T)
        torch.matmul(x.T, a)
        torch.matmul(b.T, dy)

    return cuda_ms(forward if dy is None else backward, samples=5, runs=5)


def linear_res_yardstick(h, w, dy=None):
    """ms of the linear-res products through torch.matmul on fp32 operands
    of the kernel's shapes, TF32 off: the forward's h W, or with dy the
    backward's dy W^T and h^T dy.  A yardstick, not a library time: no
    PyTorch call computes the fused function."""
    import torch
    assert not torch.backends.cuda.matmul.allow_tf32

    def forward():
        torch.matmul(h, w)

    def backward():
        torch.matmul(dy, w.T)
        torch.matmul(h.T, dy)

    return cuda_ms(forward if dy is None else backward, samples=5, runs=5)


def sdpa_mask(q, k, kmask, causal):
    """fused_mha's key mask and causal rule as SDPA's boolean mask."""
    import torch
    tq, tk = q.shape[1], k.shape[1]
    mask = (kmask != 0)[:, None, None, :]
    if causal:
        mask = mask & (torch.arange(tk, device=q.device)[None, :] <=
                       torch.arange(tq, device=q.device)[:, None])[None, None]
    return mask


def mha_forward_case(q, k, v, kmask, heads, causal, rate):
    """fused_mha_forward's time on these inputs beside SDPA's forward on the
    same heads and mask, and its bound (visible pairs)."""
    import torch.nn.functional as F
    from simulst_tpu_torch.ops import mha
    b, tq, d = q.shape
    out, lse = mha.fused_mha_forward(q, k, v, kmask, heads, causal, rate,
                                     4321)
    heads_view = [x.view(b, x.shape[1], heads, d // heads).transpose(1, 2)
                  for x in (q, k, v)]
    mask = sdpa_mask(q, k, kmask, causal)
    return dict(
        path=mha.fwd_plan(tq),
        ms=cuda_ms(lambda: mha.fused_mha_forward(q, k, v, kmask, heads,
                                                 causal, rate, 4321)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            *heads_view, attn_mask=mask, dropout_p=rate)),
        **dict(zip(("bound_ms", "bound_by"), bound(
            nbytes(q, k, v, kmask, out, lse),
            4 * d * mha_visible_pairs(kmask, tq, causal)))))


def linear_res_forward_case(h, w, bias, res, period, res_rows, rate):
    """fused_linear_res_forward's time on these inputs beside its product
    through torch.matmul, and its bound."""
    from simulst_tpu_torch.ops import linear_res
    n = h.reshape(-1, h.shape[-1]).shape[0]
    cfg = (period, res_rows, rate, 7)
    y = linear_res.fused_linear_res_forward(h, w, bias, res, *cfg)
    return dict(
        path=linear_res.fwd_plan(n),
        ms=cuda_ms(lambda: linear_res.fused_linear_res_forward(
            h, w, bias, res, *cfg)),
        products_matmul_ms=linear_res_yardstick(h.reshape(n, -1), w),
        **dict(zip(("bound_ms", "bound_by"), bound(
            nbytes(h, w, bias, res, y), 2 * n * w.shape[0] * w.shape[1]))))


def sdpa_backward_ms(q, k, v, kmask, dout, heads, causal, rate):
    """ms of SDPA's backward (autograd.grad through
    F.scaled_dot_product_attention) on fused_mha's inputs, the key mask and
    causal rule as its boolean mask."""
    import torch
    import torch.nn.functional as F
    b, tq, d = q.shape
    mask = sdpa_mask(q, k, kmask, causal)
    sd = [x.view(b, x.shape[1], heads, d // heads).transpose(1, 2).detach()
          .clone().requires_grad_() for x in (q, k, v)]
    with torch.enable_grad():
        sd_out = F.scaled_dot_product_attention(*sd, attn_mask=mask,
                                                dropout_p=rate)
    sd_dout = dout.view(b, tq, heads, d // heads).transpose(1, 2)
    return cuda_ms(lambda: torch.autograd.grad(sd_out, sd, sd_dout,
                                               retain_graph=True))


def synthetic_audio(rng, n_utt, n_frames):
    """Seeded tones + noise, scaled by 2**15, exactly n_frames fbank rows."""
    n = 400 + (n_frames - 1) * 160
    t = np.arange(n) / 16000.0
    wavs = []
    for _ in range(n_utt):
        freqs = rng.uniform(100.0, 3000.0, size=3)
        amps = rng.uniform(0.05, 0.3, size=3)
        wav = sum(a * np.sin(2 * np.pi * f * t) for a, f in zip(amps, freqs))
        wav = wav + 0.05 * rng.randn(n)
        wavs.append(wav * 2 ** 15)
    return np.stack(wavs).astype(np.float32)


def gpu_name_and_power_limit():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def wrappers():
    """name -> (the wrapper function that carries the launch count, the
    attribute counting that kernel's launches: `launches`, or
    `gated_launches` for the gated grouped-attention kernels)."""
    from simulst_tpu_torch.ops import (cif_integrate, conv_pos, ctc,
                                       emformer_attn, ffn, linear_res, mha,
                                       monotonic_align)
    mods = {"ffn": ffn, "emformer_attn": emformer_attn,
            "linear_res": linear_res, "mha": mha, "conv_pos": conv_pos,
            "ctc": ctc, "monotonic_align": monotonic_align,
            "cif_integrate": cif_integrate}
    out = {}
    for name, (m, *_) in KERNELS.items():
        base = name.replace("_gated", "")
        out[name] = (getattr(mods[m], base),
                     "launches" if base == name else "gated_launches")
    return out


def reset_launches():
    for fn, attr in wrappers().values():
        setattr(fn, attr, 0)


def read_launches():
    return {name: getattr(fn, attr)
            for name, (fn, attr) in wrappers().items()}


@contextlib.contextmanager
def patched(patches):
    saved = [(m, name, getattr(m, name)) for m, name, _ in patches]
    for m, name, fn in patches:
        setattr(m, name, fn)
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def plain_versions():
    """Route the serving model's kernel calls to the plain PyTorch versions
    for a reference run on the card (patches the call sites)."""
    from simulst_tpu_torch.nn import emformer as emf
    from simulst_tpu_torch.nn import transformer as tfm
    from simulst_tpu_torch.ops import emformer_attn, ffn, linear_res
    return patched([(emf, "fused_ln_ffn_res", ffn.ln_ffn_res_plain),
                    (emf, "emformer_grouped_attention",
                     emformer_attn.grouped_attention_plain),
                    (emf, "fused_linear_res", linear_res.linear_res_plain),
                    (tfm, "fused_ffn", ffn.ffn_plain)])


def plain_training():
    """Route the training kernels' forward and backward entries to their
    plain versions (what the autograd Functions call), on the card."""
    from simulst_tpu_torch.ops import (cif_integrate, conv_pos, ctc,
                                       emformer_attn, ffn, linear_res, mha,
                                       monotonic, monotonic_align)
    return patched([
        (mha, "fused_mha_forward",
         lambda *a: (mha.mha_plain(*a), None)),
        (mha, "fused_mha_backward",
         lambda q, k, v, km, out, lse, do, *cfg:
         mha.mha_plain_backward(q, k, v, km, do, *cfg)),
        (ffn, "fused_ffn_forward", ffn.ffn_plain),
        (ffn, "fused_ffn_backward", ffn.ffn_plain_backward),
        (ffn, "fused_ln_ffn_res_forward", ffn.ln_ffn_res_plain),
        (ffn, "fused_ln_ffn_res_backward", ffn.ln_ffn_res_plain_backward),
        (linear_res, "fused_linear_res_forward", linear_res.linear_res_plain),
        (linear_res, "fused_linear_res_backward",
         linear_res.linear_res_plain_backward),
        (emformer_attn, "emformer_grouped_attention_forward",
         emformer_attn.grouped_attention_plain),
        (emformer_attn, "emformer_grouped_attention_backward",
         emformer_attn.grouped_attention_plain_backward),
        (conv_pos, "convpos_wgrad", conv_pos.convpos_wgrad_plain),
        (ctc, "ctc_alphas", ctc.alphas_plain),
        (ctc, "ctc_d_em", ctc.d_em_plain),
        (monotonic, "alignment_fwd", monotonic_align.alignment_fwd_plain),
        (monotonic, "alignment_bwd", monotonic_align.alignment_bwd_plain),
        (cif_integrate, "cif_integrate_forward",
         cif_integrate.cif_integrate_plain)])


def phase_kernels(dev):
    """Each serving kernel vs its plain version at the serving shapes."""
    import torch
    from simulst_tpu_torch.ops import emformer_attn as ea
    from simulst_tpu_torch.ops import ffn, linear_res, mha

    g = torch.Generator().manual_seed(SEED + 1)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    def unif(*shape, bound):
        return ((torch.rand(shape, generator=g) * 2 - 1) * bound).to(dev)

    d, hid = 256, 2048
    xav = (6.0 / (d + hid)) ** 0.5
    ffn_w = dict(ln_g=1 + randn(d, scale=0.1), ln_b=randn(d, scale=0.1),
                 w1=unif(d, hid, bound=xav), b1=randn(hid, scale=0.02),
                 w2=unif(hid, d, bound=xav), b2=randn(d, scale=0.02))
    geom = ea.AttnGeom(U=256, seg=16, lc=32, rc=8, max_mem=5, G=8, num_heads=4)
    lengths = torch.tensor([256, 240, 200, 177, 256, 131, 64, 255],
                           dtype=torch.int32, device=dev)
    # the decoder step's cross-attention: 8 utterances x beam 5, one query
    # row each, over 256 encoder frames (ragged here)
    enc_valid = (torch.arange(256, device=dev)[None, :] <
                 lengths.repeat_interleave(BEAM)[:, None]).to(torch.int32)
    cases = {   # name -> (kernel, plain, {shape label: argument builder})
        "fused_ln_ffn_res": (
            ffn.fused_ln_ffn_res, ffn.ln_ffn_res_plain,
            {f"rows={n}": (lambda n=n: (randn(n, d), *ffn_w.values()))
             for n in (3072, 24)}),
        "fused_ffn": (
            ffn.fused_ffn, ffn.ffn_plain,
            {f"rows={n}": (lambda n=n: (randn(n, d), ffn_w["w1"], ffn_w["b1"],
                                        ffn_w["w2"], ffn_w["b2"]))
             for n in (40, 1)}),
        "fused_linear_res": (
            lambda *a: linear_res.fused_linear_res(*a, 200, 192),
            lambda *a: linear_res.linear_res_plain(*a, 200, 192),
            {"h=(3200,256) period=200 res_rows=192": lambda: (
                randn(3200, d), unif(d, d, bound=d ** -0.5),
                unif(d, bound=d ** -0.5), randn(3200, d))}),
        "emformer_grouped_attention": (
            lambda q, k, v: ea.emformer_grouped_attention(q, k, v, lengths,
                                                          geom),
            lambda q, k, v: ea.grouped_attention_plain(q, k, v, lengths, geom),
            {"q3=(8,2,200,256) kv=(8,399,256)": lambda: (
                randn(8, geom.ng, geom.nq, d), randn(8, geom.tk, d),
                randn(8, geom.tk, d))}),
        "fused_mha (decoder step)": (
            lambda q, k, v: mha.fused_mha(q, k, v, enc_valid, 4),
            lambda q, k, v: mha.mha_plain(q, k, v, enc_valid, 4),
            {"q=(40,1,256) kv=(40,256,256)": lambda: (
                randn(40, 1, d), randn(40, 256, d), randn(40, 256, d))}),
        "fused_linear_res (decoder step)": (
            linear_res.fused_linear_res, linear_res.linear_res_plain,
            {"h=(40,1,256)": lambda: (
                randn(40, 1, d), unif(d, d, bound=d ** -0.5),
                unif(d, bound=d ** -0.5), randn(40, 1, d))}),
    }
    report = {}
    for name, (kernel, plain, shapes) in cases.items():
        for i, (label, make) in enumerate(shapes.items()):
            args32 = make()
            for dtype, tol in ((torch.float32, F32_TOL),
                               (torch.bfloat16, BF16_TOL)):
                # the LN parameters stay fp32
                keep = (1, 2) if name == "fused_ln_ffn_res" else ()
                args = [a.to(dtype) if a.is_floating_point() and j not in keep
                        else a for j, a in enumerate(args32)]
                out = kernel(*args)
                torch.cuda.synchronize()
                err = max_err(f"{name} {label} {dtype}", out, plain(*args),
                              **tol)
                ms = cuda_ms(lambda: kernel(*args))
                plain_ms = cuda_ms(lambda: plain(*args))
                log("phase2", kernel=name, shape=label, dtype=str(dtype),
                    max_abs_err=err, ms=ms, plain_ms=plain_ms)
                if i == 0 and dtype == torch.float32:
                    report[name] = dict(shape=label, max_abs_err=err, ms=ms,
                                        plain_ms=plain_ms, library_ms=None)
                    if name == "fused_ln_ffn_res":
                        x = args[0]
                        b_ms, by = bound(
                            nbytes(x, x, *ffn_w.values()),
                            4 * x.shape[0] * d * hid)
                    elif name == "emformer_grouped_attention":
                        vis = grouped_visible_pairs(ea, geom, *args, lengths)
                        b_ms, by = bound(nbytes(*args, out), 4 * d * vis)
                        sd, mask = sdpa_on_context(ea, geom, *args, lengths)
                        report[name]["library_ms"] = cuda_ms(
                            lambda: torch.nn.functional.
                            scaled_dot_product_attention(*sd, attn_mask=mask))
                    elif name == "fused_mha (decoder step)":
                        case = mha_forward_case(*args, enc_valid, 4, False,
                                                0.0)
                        b_ms, by = case["bound_ms"], case["bound_by"]
                        report[name].update(path=case["path"],
                                            library_ms=case["library_ms"])
                    elif name.startswith("fused_linear_res"):
                        gate = (200, 192) if "period" in label else (0, 0)
                        case = linear_res_forward_case(*args, *gate, 0.0)
                        b_ms, by = case["bound_ms"], case["bound_by"]
                        report[name].update(
                            path=case["path"],
                            products_matmul_ms=case["products_matmul_ms"])
                    else:
                        continue
                    report[name].update(bound_ms=b_ms, bound_by=by)
                if i == 0 and dtype == torch.bfloat16 and name in report:
                    report[name]["bf16_max_abs_err"] = err
    for name, entry in report.items():
        log("phase2", kernel=name, **entry)
    return report


def grouped_visible_pairs(ea, geom, q3, k, v, lengths, gate=None):
    """(query row, key) pairs the grouped attention scores visibly, summed
    over the batch and groups (every head scores each once), with the
    sequence-packing gate when given."""
    return int(ea._context(q3, k, v, lengths, geom, gate)[3].sum())


def sdpa_on_context(ea, geom, q3, k, v, lengths, gate=None):
    """The grouped attention's gathered context as SDPA takes it: per-head
    (B ng, heads, rows, 64) fp32 queries, keys and values, and the boolean
    (B ng, 1, nq, ctx) mask (the gate's rule in it when given); the library
    yardstick beside the kernel."""
    qh, kh, vh, visible, _ = ea._context(q3, k, v, lengths, geom, gate)
    rows = q3.shape[0] * geom.ng
    sd = [t.reshape(rows, geom.num_heads, t.shape[-2], t.shape[-1])
          .contiguous() for t in (qh, kh, vh)]
    return sd, visible.reshape(rows, 1, geom.nq, geom.ctx)


def mha_visible_pairs(kmask, tq, causal):
    import torch
    vis = (kmask != 0)[:, None, :].expand(-1, tq, -1)
    if causal:
        q = torch.arange(tq, device=kmask.device)[:, None]
        vis = vis & (torch.arange(kmask.shape[1], device=kmask.device) <= q)
    return int(vis.sum())


def phase_train_kernels(dev, batch):
    """Training kernels vs their plain versions at the MT shapes, forward
    and backward, at dropout 0 and 0.1; times at dropout 0.1."""
    import torch
    import torch.nn.functional as F
    from simulst_tpu_torch.ops import ffn, linear_res, mha

    g = torch.Generator().manual_seed(SEED + 2)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    b, t = batch["target"].shape
    d, hid, heads = 256, 2048, 4
    n = b * t
    tgt_mask = (batch["prev_tokens"] != 1).to(torch.int32)
    src_mask = (batch["src_tokens"] != 1).to(torch.int32)
    report = {}

    def record(name, **fields):
        entry = report.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   fields.pop("max_abs_err"))
        entry.update(fields)

    # fused_mha: decoder causal self-attention and cross-attention
    for case, kmask, causal in (("self causal", tgt_mask, True),
                                ("cross", src_mask, False)):
        q, k, v, dout = (randn(b, t, d) for _ in range(4))
        for rate in (0.0, 0.1):
            cfg = (heads, causal, rate, 4321)
            out, lse = mha.fused_mha_forward(q, k, v, kmask, *cfg)
            torch.cuda.synchronize()
            e_fwd = max_err(f"fused_mha {case} rate {rate}", out,
                            mha.mha_plain(q, k, v, kmask, *cfg), **F32_TOL)
            got = mha.fused_mha_backward(q, k, v, kmask, out, lse, dout, *cfg)
            want = mha.mha_plain_backward(q, k, v, kmask, dout, *cfg)
            torch.cuda.synchronize()
            e_bwd = max(max_err(f"fused_mha_backward {case} rate {rate} {w}",
                                x, y, **F32_TOL)
                        for w, x, y in zip("qkv", got, want))
            log("phase5", kernel="fused_mha", case=case, rate=rate,
                fwd_max_abs_err=e_fwd, bwd_max_abs_err=e_bwd)
            record("fused_mha", max_abs_err=e_fwd)
            record("fused_mha_backward", max_abs_err=e_bwd)
            if rate > 0.0:
                log("phase5", kernel="fused_mha", case=case, rate=rate,
                    shape=f"(B,Tq,Tk,D)=({b},{t},{t},{d})",
                    **mha_forward_case(q, k, v, kmask, heads, causal, rate))
            if case != "self causal" or rate == 0.0:
                continue
            vis = mha_visible_pairs(kmask, t, causal)
            mask = ((kmask != 0)[:, None, None, :] &
                    (torch.arange(t, device=dev)[None, :] <=
                     torch.arange(t, device=dev)[:, None])[None, None])
            heads_view = [x.view(b, t, heads, d // heads).transpose(1, 2)
                          for x in (q, k, v)]
            record("fused_mha", max_abs_err=0.0,
                   shape=f"(B,Tq,Tk,D)=({b},{t},{t},{d}) causal rate 0.1",
                   ms=cuda_ms(lambda: mha.fused_mha_forward(q, k, v, kmask,
                                                            *cfg)),
                   plain_ms=cuda_ms(lambda: mha.mha_plain(q, k, v, kmask,
                                                          *cfg)),
                   library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                       *heads_view, attn_mask=mask, dropout_p=rate)),
                   **dict(zip(("bound_ms", "bound_by"), bound(
                       nbytes(q, k, v, kmask, out, lse), 4 * d * vis))))
            record("fused_mha_backward", max_abs_err=0.0,
                   shape=f"(B,Tq,Tk,D)=({b},{t},{t},{d}) causal rate 0.1",
                   ms=cuda_ms(lambda: mha.fused_mha_backward(
                       q, k, v, kmask, out, lse, dout, *cfg)),
                   plain_ms=cuda_ms(lambda: mha.mha_plain_backward(
                       q, k, v, kmask, dout, *cfg)),
                   library_ms=sdpa_backward_ms(q, k, v, kmask, dout,
                                               *cfg[:3]),
                   **dict(zip(("bound_ms", "bound_by"), bound(
                       nbytes(q, k, v, kmask, out, lse, dout, *got),
                       10 * d * vis))))

    # the encoder's self-attention (source mask, not causal): its forward,
    # on inputs of their own generator (the draws above and below stay
    # those of earlier revisions)
    ge = torch.Generator().manual_seed(SEED + 12)
    q, k, v = (torch.randn(b, t, d, generator=ge).to(dev) for _ in range(3))
    cfg = (heads, False, 0.1, 4321)
    err = max_err("fused_mha encoder self rate 0.1", mha.fused_mha_forward(
        q, k, v, src_mask, *cfg)[0], mha.mha_plain(q, k, v, src_mask, *cfg),
        **F32_TOL)
    log("phase5", kernel="fused_mha", case="encoder self", rate=0.1,
        fwd_max_abs_err=err, shape=f"(B,Tq,Tk,D)=({b},{t},{t},{d})",
        **mha_forward_case(q, k, v, src_mask, heads, False, 0.1))

    # fused_mha_backward at the ASR step's decoder shapes (targets padded
    # to 72; 256 encoder frames), ragged masks; rate 0.1
    asr_shapes = {}
    for case, bq, tq, tk, causal in (
            ("decoder self (32,72,72) causal", 32, 72, 72, True),
            ("cross (32,72,256)", 32, 72, 256, False)):
        q, dout = randn(bq, tq, d), randn(bq, tq, d)
        k, v = randn(bq, tk, d), randn(bq, tk, d)
        lengths = torch.randint(tk // 2, tk + 1, (bq,), generator=g).to(dev)
        kmask = (torch.arange(tk, device=dev)[None, :] <
                 lengths[:, None]).to(torch.int32)
        cfg = (heads, causal, 0.1, 4321)
        out, lse = mha.fused_mha_forward(q, k, v, kmask, *cfg)
        got = mha.fused_mha_backward(q, k, v, kmask, out, lse, dout, *cfg)
        want = mha.mha_plain_backward(q, k, v, kmask, dout, *cfg)
        torch.cuda.synchronize()
        err = max(max_err(f"fused_mha_backward {case} {w}", x, y, **F32_TOL)
                  for w, x, y in zip("qkv", got, want))
        record("fused_mha_backward", max_abs_err=err)
        asr_shapes[case] = dict(
            ms=cuda_ms(lambda: mha.fused_mha_backward(
                q, k, v, kmask, out, lse, dout, *cfg)),
            library_ms=sdpa_backward_ms(q, k, v, kmask, dout, *cfg[:3]),
            **dict(zip(("bound_ms", "bound_by"), bound(
                nbytes(q, k, v, kmask, out, lse, dout, *got),
                10 * d * mha_visible_pairs(kmask, tq, causal)))))
    record("fused_mha_backward", max_abs_err=0.0, asr_shapes=asr_shapes)

    # fused_ffn: the decoder FFN, relu, 8192 rows
    xav = (6.0 / (d + hid)) ** 0.5
    x, dy = randn(n, d), randn(n, d)
    w1, b1 = randn(d, hid, scale=xav), randn(hid, scale=0.02)
    w2, b2 = randn(hid, d, scale=xav), randn(d, scale=0.02)
    for rate in (0.0, 0.1):
        cfg = ("relu", rate, rate, 99)
        y = ffn.fused_ffn_forward(x, w1, b1, w2, b2, *cfg)
        torch.cuda.synchronize()
        e_fwd = max_err(f"fused_ffn rate {rate}", y,
                        ffn.ffn_plain(x, w1, b1, w2, b2, *cfg), **F32_TOL)
        got = ffn.fused_ffn_backward(x, w1, b1, w2, dy, *cfg)
        want = ffn.ffn_plain_backward(x, w1, b1, w2, dy, *cfg)
        torch.cuda.synchronize()
        e_bwd = max([max_err(f"fused_ffn_backward rate {rate} dx", got[0],
                             want[0], **F32_TOL)] +
                    [max_err_to_largest(f"fused_ffn_backward rate {rate} {w}",
                                        gw, ww)
                     for w, gw, ww in zip(("dw1", "db1", "dw2", "db2"),
                                          got[1:], want[1:])])
        log("phase5", kernel="fused_ffn", rows=n, rate=rate,
            fwd_max_abs_err=e_fwd, bwd_max_abs_err=e_bwd)
        record("fused_ffn", max_abs_err=e_fwd)
        record("fused_ffn_backward", max_abs_err=e_bwd)
    flops = 2 * n * d * hid
    record("fused_ffn", max_abs_err=0.0, shape=f"x=({n},{d}) relu rate 0.1",
           ms=cuda_ms(lambda: ffn.fused_ffn_forward(x, w1, b1, w2, b2, *cfg)),
           plain_ms=cuda_ms(lambda: ffn.ffn_plain(x, w1, b1, w2, b2, *cfg)),
           library_ms=None, products_matmul_ms=matmul_yardstick(x, w1, w2),
           **dict(zip(("bound_ms", "bound_by"), bound(
               nbytes(x, y, w1, b1, w2, b2), 2 * flops))))
    record("fused_ffn_backward", max_abs_err=0.0,
           shape=f"x=({n},{d}) relu rate 0.1",
           ms=cuda_ms(lambda: ffn.fused_ffn_backward(x, w1, b1, w2, dy, *cfg),
                      samples=5, runs=5),
           plain_ms=cuda_ms(lambda: ffn.ffn_plain_backward(
               x, w1, b1, w2, dy, *cfg), samples=5, runs=5),
           library_ms=None,
           products_matmul_ms=matmul_yardstick(x, w1, w2, dy),
           **dict(zip(("bound_ms", "bound_by"), bound(
               nbytes(x, dy, w1, b1, w2, *got), 5 * flops))))

    # fused_linear_res: the decoder attention epilogue, 8192 rows
    h, res = randn(n, d), randn(n, d)
    w, bias = randn(d, d, scale=d ** -0.5), randn(d, scale=0.02)
    for rate in (0.0, 0.1):
        cfg = (0, 0, rate, 7)
        y = linear_res.fused_linear_res_forward(h, w, bias, res, *cfg)
        torch.cuda.synchronize()
        e_fwd = max_err(f"fused_linear_res rate {rate}", y,
                        linear_res.linear_res_plain(h, w, bias, res, *cfg),
                        **F32_TOL)
        got = linear_res.fused_linear_res_backward(h, w, dy, *cfg)
        want = linear_res.linear_res_plain_backward(h, w, dy, *cfg)
        torch.cuda.synchronize()
        e_bwd = max([max_err(f"fused_linear_res_backward rate {rate} dh",
                             got[0], want[0], **F32_TOL)] +
                    [max_err_to_largest(
                        f"fused_linear_res_backward rate {rate} {nm}", gw, ww)
                     for nm, gw, ww in zip(("dw", "db"), got[1:], want[1:])])
        log("phase5", kernel="fused_linear_res", rows=n, rate=rate,
            fwd_max_abs_err=e_fwd, bwd_max_abs_err=e_bwd)
        record("fused_linear_res", max_abs_err=e_fwd)
        record("fused_linear_res_backward", max_abs_err=e_bwd)
    flops = 2 * n * d * d
    log("phase5", kernel="fused_linear_res", shape=f"h=({n},{d}) rate 0.1",
        **linear_res_forward_case(h, w, bias, res, 0, 0, 0.1))
    record("fused_linear_res", max_abs_err=0.0, shape=f"h=({n},{d}) rate 0.1",
           ms=cuda_ms(lambda: linear_res.fused_linear_res_forward(
               h, w, bias, res, *cfg)),
           plain_ms=cuda_ms(lambda: linear_res.linear_res_plain(
               h, w, bias, res, *cfg)),
           library_ms=None, products_matmul_ms=linear_res_yardstick(h, w),
           **dict(zip(("bound_ms", "bound_by"), bound(
               nbytes(h, w, bias, res, y), flops))))
    record("fused_linear_res_backward", max_abs_err=0.0,
           shape=f"h=({n},{d}) rate 0.1",
           ms=cuda_ms(lambda: linear_res.fused_linear_res_backward(
               h, w, dy, *cfg)),
           plain_ms=cuda_ms(lambda: linear_res.linear_res_plain_backward(
               h, w, dy, *cfg)),
           library_ms=None,
           products_matmul_ms=linear_res_yardstick(h, w, dy),
           **dict(zip(("bound_ms", "bound_by"), bound(
               nbytes(h, w, dy, *got), 2 * flops))))
    # the backward at the ASR step's shapes: the Emformer out-projection
    # (32 x 2 groups of 200 rows, the gate: 192 residual rows each) and the
    # decoder's epilogues (32 x 72 rows); rate 0.1
    asr_shapes = {}
    for case, rows, period, res_rows in (
            ("encoder h=(12800,256) period 200 gate 192", 12800, 200, 192),
            ("decoder h=(2304,256)", 2304, 0, 0)):
        ha, dya = randn(rows, d), randn(rows, d)
        cfga = (period, res_rows, 0.1, 7)
        got = linear_res.fused_linear_res_backward(ha, w, dya, *cfga)
        want = linear_res.linear_res_plain_backward(ha, w, dya, *cfga)
        torch.cuda.synchronize()
        err = max([max_err(f"fused_linear_res_backward {case} dh", got[0],
                           want[0], **F32_TOL)] +
                  [max_err_to_largest(f"fused_linear_res_backward {case} {nm}",
                                      gw, ww)
                   for nm, gw, ww in zip(("dw", "db"), got[1:], want[1:])])
        record("fused_linear_res_backward", max_abs_err=err)
        asr_shapes[case] = dict(
            ms=cuda_ms(lambda: linear_res.fused_linear_res_backward(
                ha, w, dya, *cfga)),
            products_matmul_ms=linear_res_yardstick(ha, w, dya),
            **dict(zip(("bound_ms", "bound_by"), bound(
                nbytes(ha, w, dya, *got), 4 * rows * d * d))))
    record("fused_linear_res_backward", max_abs_err=0.0,
           asr_shapes=asr_shapes)
    # bf16: the kernels take it too (the MT path runs fp32); one case each
    bf = torch.bfloat16
    qb, kb, vb, dob = (randn(b, t, d).to(bf) for _ in range(4))
    cfg = (heads, True, 0.1, 4321)
    out, lse = mha.fused_mha_forward(qb, kb, vb, tgt_mask, *cfg)
    errs = {"fused_mha": max_err("fused_mha bf16", out, mha.mha_plain(
        qb, kb, vb, tgt_mask, *cfg), **BF16_TOL)}
    errs["fused_mha_backward"] = max(
        max_err(f"fused_mha_backward bf16 d{w}", x, y, **BF16_TOL)
        for w, x, y in zip("qkv", mha.fused_mha_backward(
            qb, kb, vb, tgt_mask, out, lse, dob, *cfg),
            mha.mha_plain_backward(qb, kb, vb, tgt_mask, dob, *cfg)))
    fargs = [a.to(bf) for a in (x, w1, b1, w2, b2)]
    cfg = ("relu", 0.1, 0.1, 99)
    errs["fused_ffn"] = max_err("fused_ffn bf16", ffn.fused_ffn_forward(
        *fargs, *cfg), ffn.ffn_plain(*fargs, *cfg), **BF16_TOL)
    got = ffn.fused_ffn_backward(*fargs[:4], dy.to(bf), *cfg)
    # relu under the kernel's relu mask: its u comes from the tensor cores
    want = plain_ffn_backward_under(fargs[0], fargs[1:], dy.to(bf), cfg,
                                    kernel_ffn_relu_mask(fargs[0], fargs[1:],
                                                         cfg))
    errs["fused_ffn_backward"] = max(
        [max_err("fused_ffn_backward bf16 dx", got[0], want[0], **BF16_TOL)]
        + [max_err_to_largest(f"fused_ffn_backward bf16 {nm}", gw, ww, 1e-2)
           for nm, gw, ww in zip(("dw1", "db1", "dw2", "db2"), got[1:],
                                 want[1:])])
    largs = [a.to(bf) for a in (h, w, bias, res)]
    cfg = (0, 0, 0.1, 7)
    errs["fused_linear_res"] = max_err(
        "fused_linear_res bf16", linear_res.fused_linear_res_forward(
            *largs, *cfg), linear_res.linear_res_plain(*largs, *cfg),
        **BF16_TOL)
    got = linear_res.fused_linear_res_backward(largs[0], largs[1], dy.to(bf),
                                               *cfg)
    want = linear_res.linear_res_plain_backward(largs[0], largs[1],
                                                dy.to(bf), *cfg)
    errs["fused_linear_res_backward"] = max(
        [max_err("fused_linear_res_backward bf16 dh", got[0], want[0],
                 **BF16_TOL)]
        + [max_err_to_largest(f"fused_linear_res_backward bf16 {nm}", gw, ww,
                              1e-2)
           for nm, gw, ww in zip(("dw", "db"), got[1:], want[1:])])
    for name, err in errs.items():
        report[name]["bf16_max_abs_err"] = err
    for name, entry in report.items():
        log("phase5", kernel=name, **entry)
    return report


def kernel_family(name, families=KERNEL_FAMILIES):
    return next((fam for frag, fam in families if frag in name),
                "other PyTorch kernels")


def profile_steps(state, train_step, batch, generator, tag,
                  families=KERNEL_FAMILIES, out=None):
    """PROFILE_STEPS training steps under torch.profiler: the device busy
    share of the profiled wall (which the profiler stretches), the device
    time by kernel family (`families`: name fragment -> family, the first
    match) and the top kernels, per step; the device ms per step and the
    busy share also into the dict `out` when given."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            state, _ = train_step(state, batch, generator)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        raise AssertionError("torch.profiler recorded no device kernels")
    device_ms = sum(e.self_device_time_total for e in kernels
                    if kernel_family(e.key, families)
                    != POSTERIOR_FAMILY) / 1e3
    by_family = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        fam = by_family[kernel_family(e.key, families)]
        fam[0] += e.self_device_time_total / 1e3 / PROFILE_STEPS
        fam[1] += e.count / PROFILE_STEPS
    def family_ms(families):
        return sum(by_family[fam][0] for fam in families if fam in by_family)

    if out is not None:
        out.update(device_ms_per_step=device_ms / PROFILE_STEPS,
                   busy_share=device_ms / wall_ms)

    log(f"{tag}-profile", steps=PROFILE_STEPS,
        profiled_wall_ms_per_step=wall_ms / PROFILE_STEPS,
        device_ms_per_step=device_ms / PROFILE_STEPS,
        device_busy_share_of_profiled_wall=device_ms / wall_ms,
        grouped_attention_fwd_bwd_device_ms_per_step=family_ms(
            ATTENTION_FAMILIES),
        alignment_fwd_bwd_device_ms_per_step=family_ms(ALIGNMENT_FAMILIES),
        kernels_per_step=sum(e.count for e in kernels) / PROFILE_STEPS,
        families={name: {"device_ms_per_step": ms, "kernels_per_step": n}
                  for name, (ms, n) in sorted(by_family.items(),
                                              key=lambda x: -x[1][0])},
        top=[{"kernel": e.key[:100], "calls_per_step": e.count /
              PROFILE_STEPS, "device_ms_per_step":
              e.self_device_time_total / 1e3 / PROFILE_STEPS}
             for e in sorted(kernels,
                             key=lambda e: -e.self_device_time_total)[:12]])
    return state


def phase_train(dev, batch, save_path):
    """8 full-width MT training steps through the CLI's loss and the train
    step, counting launches, the trained teacher saved to save_path for the
    offline-decode phase; then kernels vs plain on one step."""
    import torch
    from simulst_tpu_torch import config as cfglib
    from simulst_tpu_torch.cli import train as cli
    from simulst_tpu_torch.train.checkpoint import save_checkpoint
    from simulst_tpu_torch.train.state import (create_train_state,
                                               make_accum_train_step,
                                               make_train_step)

    args = cli.parse_args(MT_ARGS)
    model = cli.build_model(args, 8000, device=dev)
    loss_fn = cli.build_loss(args, model)
    optim_cfg = cli.optim_config(args)
    train_step = make_train_step(loss_fn, optim_cfg)
    state = create_train_state(model, optim_cfg)
    generator = torch.Generator().manual_seed(SEED)
    ntokens = int((batch["target"] != 1).sum())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    step_ms, losses = [], []
    for _ in range(MT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, generator)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]) / float(metrics["sample_size"]))
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    per_step = {k: launches[k] / MT_STEPS for k in MT_LAUNCHES_PER_STEP}
    if per_step != MT_LAUNCHES_PER_STEP:
        raise AssertionError(f"launches per step {per_step}, expected "
                             f"{MT_LAUNCHES_PER_STEP}")
    if not all(np.isfinite(losses)) or state.step != MT_STEPS:
        raise AssertionError(f"losses {losses}, updates {state.step}")
    log("phase6", config="MTConfig() transformer_small", pairs=MT_PAIRS,
        lengths=f"{MT_MIN_LEN}-{MT_MAX_LEN}", target_tokens=ntokens,
        steps=MT_STEPS, first_step_ms=step_ms[0],
        median_step_ms=statistics.median(step_ms[1:]), step_ms=step_ms,
        losses=losses, launches_per_step=per_step,
        peak_memory_gib=peak_gib)

    state = profile_steps(state, train_step, batch, generator, "phase6")
    save_checkpoint(save_path, state.model.state_dict(),
                    {"model": "mt_transformer",
                     "config": cfglib.to_dict(model.cfg),
                     "step": state.step})
    compare_plain_step(state, loss_fn, optim_cfg, batch, "phase6",
                       make_accum_train_step)
    return launches


def grad_scale(grads, name):
    """The largest gradient entry that a parameter's error is held against:
    its own, but for a key bias, which adds one q.b to every score of a
    query row; the softmax ignores that (and MMA's soft attention nearly
    so), so its exact gradient is 0 and both sides hold rounding noise: its
    weight's."""
    if name.endswith(("k_proj.bias", "k_proj_soft.bias")):
        name = name[:-len("bias")] + "weight"
    return max(grads[name].abs().max().item(), 1e-30)


def compare_plain_step(state, loss_fn, optim_cfg, batch, tag,
                       make_accum_train_step, gnorm_rtol=1e-5,
                       floor_margin=None):
    """One step at dropout 0 (no generator: no SpecAugment either) with the
    kernels and through the plain versions, from the same params, optimizer
    state and batch; the same functions as the train step, split so that
    the gradients can be read before the update.  The step runs gelu (in
    place of the MT model's relu: with relu, a hidden unit whose input lies
    within rounding of 0 lands on opposite sides of the kink on the two
    sides and flips its whole gradient, and such flips would hide a wrong
    backward of a few parts in 1e3; phase 5 holds the relu backward to its
    plain version).  One more plain step from the parameters scaled by
    (1 + 1e-7 N(0, 1)), about one fp32 rounding each, measures how far
    rounding alone moves these gradients: the floor under the comparison's
    limits.  gnorm_rtol None logs the gradient norms without holding them
    to a limit.  floor_margin: where that floor reaches a limit / margin
    (the gradients' 1e-4 of their largest entry, gnorm_rtol), the limit
    becomes margin x the floor, so that a step whose own rounding moves its
    gradients past phase 8's limits is held at its resolution."""
    import torch
    grad_step, apply_step = make_accum_train_step(loss_fn, optim_cfg)
    outs = []
    for use_plain, noise in ((False, 0.0), (True, 0.0), (True, 1e-7)):
        st = copy.deepcopy(state)
        st.model.cfg = dataclasses.replace(st.model.cfg, activation="gelu")
        if noise:
            gen = torch.Generator(device=batch["target"].device)
            gen.manual_seed(SEED)
            with torch.no_grad():
                for p in st.model.parameters():
                    p.mul_(1 + noise * torch.randn(p.shape, generator=gen,
                                                   device=p.device))
        with plain_training() if use_plain else contextlib.nullcontext():
            m = grad_step(st, batch, None)
        grads = {n: p.grad.clone() for n, p in st.model.named_parameters()}
        st, m = apply_step(st, m)
        torch.cuda.synchronize()
        outs.append((grads, st.model.state_dict(), float(m["loss"]),
                     float(m["gnorm"])))
        del st
    (g_k, sd_k, loss_k, gn_k), (g_p, sd_p, loss_p, gn_p), \
        (g_n, _, _, gn_n) = outs

    def rel_errors(grads):
        return {n: (grads[n] - g_p[n]).abs().max().item() / grad_scale(g_p, n)
                for n in grads}

    grad_rel = rel_errors(g_k)
    worst = max(grad_rel, key=grad_rel.get)
    noise_rel = rel_errors(g_n)
    worst_n = max(noise_rel, key=noise_rel.get)
    gnorm_floor = abs(gn_n - gn_p) / gn_p
    log(tag, rounding_floor_grads_max_err_to_largest=noise_rel[worst_n],
        rounding_floor_worst_param=worst_n,
        rounding_floor_gnorm_rel=gnorm_floor)
    grad_limit = 1e-4
    if floor_margin is not None:
        grad_limit = max(grad_limit, floor_margin * noise_rel[worst_n])
        if gnorm_rtol is not None:
            gnorm_rtol = max(gnorm_rtol, floor_margin * gnorm_floor)
        log(tag, limits_at_the_rounding_floor={
            "grads_max_err_to_largest": grad_limit, "gnorm_rel": gnorm_rtol})
    before = state.model.state_dict()
    diff = max((sd_k[k] - sd_p[k]).abs().max().item() for k in sd_k)
    moved = max((sd_k[k] - before[k]).abs().max().item() for k in sd_k)
    gnorm_off = gnorm_rtol is not None and \
        abs(gn_k - gn_p) > gnorm_rtol * gn_p
    if grad_rel[worst] > grad_limit or gnorm_off or \
            abs(loss_k - loss_p) > 1e-5 * abs(loss_p) or diff > 1e-5:
        raise AssertionError(
            f"{tag} train step kernels vs plain: gradient of {worst} off by "
            f"{grad_rel[worst]:.3e} of its largest entry; gnorm {gn_k} vs "
            f"{gn_p}; loss {loss_k} vs {loss_p}; params max abs diff {diff}")
    log(tag, kernels_vs_plain_loss=[loss_k, loss_p],
        kernels_vs_plain_gnorm=[gn_k, gn_p],
        grads_max_err_to_largest=grad_rel[worst], grads_worst_param=worst,
        grads_top=sorted(grad_rel.items(), key=lambda kv: -kv[1])[:6],
        updated_params_max_abs_diff=diff, update_max_abs=moved)


def asr_batch(dev):
    """32 utterances of seeded synthetic audio of 717-1024 fbank frames
    (utterance CMVN over each one's own frames, zero-padded to the 1024-frame
    bucket) with 38-64 uniform target ids + EOS, right-padded to 72."""
    import torch
    from simulst_tpu_torch.ops.fbank import fbank_batch, utterance_cmvn
    rng = np.random.RandomState(SEED + 3)
    frames = rng.randint(ASR_MIN_FRAMES, ASR_FRAMES + 1, ASR_UTT)
    frames[0] = ASR_FRAMES
    feats = torch.zeros(ASR_UTT, ASR_FRAMES, 80, device=dev)
    with torch.no_grad():
        for j, n in enumerate(frames):
            wav = torch.from_numpy(synthetic_audio(rng, 1, int(n))).to(dev)
            feats[j, :n] = utterance_cmvn(fbank_batch(wav))[0]
    target = np.ones((ASR_UTT, ASR_TOKEN_BUCKET), np.int64)
    prev = np.ones_like(target)
    for j in range(ASR_UTT):
        n = rng.randint(ASR_MIN_TOKENS, ASR_MAX_TOKENS + 1)
        toks = np.append(rng.randint(4, ASR_VOCAB, n), 2)
        target[j, :n + 1] = toks
        prev[j, :n + 1] = np.append(2, toks[:-1])
    return {"feats": feats,
            "feat_lengths": torch.from_numpy(frames).to(dev),
            "target": torch.from_numpy(target).to(dev),
            "prev_tokens": torch.from_numpy(prev).to(dev)}


def subsampled(lengths):
    """Frames after the two stride-2 causal convolutions."""
    for _ in range(2):
        lengths = (lengths - 1) // 2 + 1
    return lengths


def phase_asr_kernels(dev, batch):
    """The ASR training kernels vs their plain versions at the shapes of a
    32 x 1024-frame batch (U 256, 16 segments in 2 groups of 8, nq 200, ctx
    236, Tk 399), forward and backward at dropout 0 and 0.1; CUDA-event
    times at dropout 0.1 beside one PyTorch call of the same function."""
    import torch
    import torch.nn.functional as F
    from simulst_tpu_torch.ops import conv_pos, ctc, ffn
    from simulst_tpu_torch.ops import emformer_attn as ea

    g = torch.Generator().manual_seed(SEED + 4)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    b, d, hid, heads = ASR_UTT, 256, 2048, 4
    lengths = subsampled(batch["feat_lengths"]).to(torch.int32)
    report = {}

    def record(name, **fields):
        entry = report.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   fields.pop("max_abs_err"))
        entry.update(fields)

    # LN-FFN: every Emformer layer's 32 x (128 rc + 256 utterance) rows
    n = b * (8 * 16 + 256)
    xav = (6.0 / (d + hid)) ** 0.5
    x, dy = randn(n, d), randn(n, d)
    lnw = (1 + randn(d, scale=0.1), randn(d, scale=0.1),
           randn(d, hid, scale=xav), randn(hid, scale=0.02),
           randn(hid, d, scale=xav), randn(d, scale=0.02))
    names = ("dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
    for rate in (0.0, 0.1):
        cfg = ("gelu", rate, rate, 17)
        y = ffn.fused_ln_ffn_res_forward(x, *lnw, *cfg)
        torch.cuda.synchronize()
        e_fwd = max_err(f"fused_ln_ffn_res rate {rate}", y,
                        ffn.ln_ffn_res_plain(x, *lnw, *cfg), **F32_TOL)
        got = ffn.fused_ln_ffn_res_backward(x, *lnw[:5], dy, *cfg)
        want = ffn.ln_ffn_res_plain_backward(x, *lnw[:5], dy, *cfg)
        torch.cuda.synchronize()
        e_bwd = max([max_err(f"fused_ln_ffn_res_backward rate {rate} dx",
                             got[0], want[0], **F32_TOL)] +
                    [max_err_to_largest(
                        f"fused_ln_ffn_res_backward rate {rate} {nm}", gw,
                        ww) for nm, gw, ww in zip(names, got[1:], want[1:])])
        log("phase7", kernel="fused_ln_ffn_res", rows=n, rate=rate,
            fwd_max_abs_err=e_fwd, bwd_max_abs_err=e_bwd)
        record("fused_ln_ffn_res_backward", max_abs_err=e_bwd)
    flops = 2 * n * d * hid
    w1, w2 = lnw[2], lnw[4]
    log("phase7", kernel="fused_ln_ffn_res", shape=f"x=({n},{d}) gelu rate "
        "0.1", ms=cuda_ms(lambda: ffn.fused_ln_ffn_res_forward(x, *lnw,
                                                               *cfg)),
        plain_ms=cuda_ms(lambda: ffn.ln_ffn_res_plain(x, *lnw, *cfg),
                         samples=5, runs=5),
        products_matmul_ms=matmul_yardstick(x, w1, w2),
        **dict(zip(("bound_ms", "bound_by"), bound(nbytes(x, y, *lnw),
                                                   2 * flops))))
    bwd_ms = cuda_ms(lambda: ffn.fused_ln_ffn_res_backward(
        x, *lnw[:5], dy, *cfg), samples=5, runs=5)
    record("fused_ln_ffn_res_backward", max_abs_err=0.0,
           shape=f"x=({n},{d}) gelu rate 0.1", ms=bwd_ms,
           plain_ms=cuda_ms(lambda: ffn.ln_ffn_res_plain_backward(
               x, *lnw[:5], dy, *cfg), samples=5, runs=5),
           library_ms=None,
           products_matmul_ms=matmul_yardstick(x, w1, w2, dy),
           fp32_peak_share=5 * flops / (bwd_ms * 1e-3) / FP32_FLOP_PER_S,
           **dict(zip(("bound_ms", "bound_by"), bound(
               nbytes(x, dy, *lnw[:5], *got), 5 * flops))))

    # grouped attention: the Emformer layer's core
    geom = ea.AttnGeom(U=256, seg=16, lc=32, rc=8, max_mem=5, G=8,
                       num_heads=heads)
    q3, dout = randn(b, geom.ng, geom.nq, d), randn(b, geom.ng, geom.nq, d)
    k, v = randn(b, geom.tk, d), randn(b, geom.tk, d)
    args = (q3, k, v, lengths)
    for rate in (0.0, 0.1):
        out = ea.emformer_grouped_attention_forward(*args, geom, rate, 23)
        torch.cuda.synchronize()
        e_fwd = max_err(f"emformer_grouped_attention rate {rate}", out,
                        ea.grouped_attention_plain(*args, geom, rate, 23),
                        **F32_TOL)
        got = ea.emformer_grouped_attention_backward(*args, dout, geom, rate,
                                                     23)
        want = ea.grouped_attention_plain_backward(*args, dout, geom, rate,
                                                   23)
        torch.cuda.synchronize()
        e_bwd = max(max_err(f"emformer_grouped_attention_backward rate "
                            f"{rate} d{w}", x_, y_, **F32_TOL)
                    for w, x_, y_ in zip("qkv", got, want))
        log("phase7", kernel="emformer_grouped_attention", rate=rate,
            fwd_max_abs_err=e_fwd, bwd_max_abs_err=e_bwd)
        record("emformer_grouped_attention_backward", max_abs_err=e_bwd)
    # SDPA with the same boolean mask on the gathered context (the gather
    # is not timed)
    sd, mask = sdpa_on_context(ea, geom, *args)
    sd = [t.requires_grad_() for t in sd]
    with torch.enable_grad():
        sd_out = F.scaled_dot_product_attention(*sd, attn_mask=mask,
                                                dropout_p=rate)
    sd_dout = torch.randn_like(sd_out)
    vis = grouped_visible_pairs(ea, geom, *args)
    shape = f"q3=({b},{geom.ng},{geom.nq},{d}) kv=({b},{geom.tk},{d}) rate 0.1"
    log("phase7", kernel="emformer_grouped_attention", shape=shape,
        ms=cuda_ms(lambda: ea.emformer_grouped_attention_forward(
            *args, geom, rate, 23)),
        plain_ms=cuda_ms(lambda: ea.grouped_attention_plain(*args, geom,
                                                            rate, 23)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            *sd, attn_mask=mask, dropout_p=rate)),
        **dict(zip(("bound_ms", "bound_by"), bound(nbytes(*args, out),
                                                   4 * d * vis))))
    record("emformer_grouped_attention_backward", max_abs_err=0.0,
           shape=shape,
           ms=cuda_ms(lambda: ea.emformer_grouped_attention_backward(
               *args, dout, geom, rate, 23)),
           plain_ms=cuda_ms(lambda: ea.grouped_attention_plain_backward(
               *args, dout, geom, rate, 23), samples=5, runs=5),
           library_ms=cuda_ms(lambda: torch.autograd.grad(
               sd_out, sd, sd_dout, retain_graph=True)),
           **dict(zip(("bound_ms", "bound_by"), bound(
               nbytes(*args, dout, *got), 10 * d * vis))))
    del sd, sd_out

    # conv-pos weight gradient: 64 taps, 16 groups of 16 channels
    taps, groups, t_out = 64, 16, 256
    xp, dyc = randn(b, t_out + taps - 1, d), randn(b, t_out, d)
    got = conv_pos.convpos_wgrad(xp, dyc, taps, groups)
    torch.cuda.synchronize()
    want = conv_pos.convpos_wgrad_plain(xp, dyc, taps, groups)
    xt, dyt = xp.transpose(1, 2).contiguous(), dyc.transpose(1, 2).contiguous()
    lib = torch.nn.grad.conv1d_weight(xt, (d, d // groups, taps), dyt,
                                      groups=groups)
    err = max_err_to_largest("convpos_wgrad", got, want)
    max_err_to_largest("conv1d_weight vs the plain wgrad", lib, want)
    record("convpos_wgrad", max_abs_err=err,
           ptxas=ptxas_report("convpos_wgrad"),
           shape=f"xp=({b},{t_out + taps - 1},{d}) dy=({b},{t_out},{d}) "
                 f"-> dw ({taps},{d // groups},{d})",
           ms=cuda_ms(lambda: conv_pos.convpos_wgrad(xp, dyc, taps, groups)),
           plain_ms=cuda_ms(lambda: conv_pos.convpos_wgrad_plain(
               xp, dyc, taps, groups), samples=5, runs=5),
           library_ms=cuda_ms(lambda: torch.nn.grad.conv1d_weight(
               xt, (d, d // groups, taps), dyt, groups=groups)),
           **dict(zip(("bound_ms", "bound_by"), bound(
               nbytes(xp, dyc, got), 2 * b * t_out * taps * d * (d // groups)))))

    # CTC alphas and d_em: T 256, B 32, targets of 38-64 labels (S 129)
    t_len, L = t_out, ASR_MAX_TOKENS
    tl = torch.from_numpy(np.random.RandomState(SEED + 5).randint(
        ASR_MIN_TOKENS, L + 1, b)).to(dev)
    targets = torch.randint(4, ASR_VOCAB, (b, L), generator=g).to(dev)
    targets = torch.where(torch.arange(L, device=dev)[None] < tl[:, None],
                          targets, torch.ones_like(targets))
    logits = randn(b, t_len, ASR_VOCAB)
    labels, can_skip = ctc._ctc_masks(targets, 0)
    lse = torch.logsumexp(logits, dim=-1)
    em = (ctc._emissions(logits, labels) - lse.T[:, :, None]).contiguous()
    got = ctc.ctc_alphas(em, can_skip, lengths, tl)
    torch.cuda.synchronize()
    want = ctc.alphas_plain(em, can_skip, lengths, tl)
    sentinel = want <= ctc.NEG / 2
    if not torch.equal(got <= ctc.NEG / 2, sentinel) or \
            not torch.equal(got[sentinel], want[sentinel]):
        raise AssertionError("ctc_alphas: the -1e30 sentinels differ")
    err_a = max_err("ctc_alphas", got[~sentinel], want[~sentinel], **F32_TOL)
    nll = ctc._nll_from_alpha(want[-1], tl)
    scale = -torch.ones(b, device=dev)
    d_em = ctc.ctc_d_em(em, want, can_skip, lengths, tl, scale, nll)
    torch.cuda.synchronize()
    err_d = max_err("ctc_d_em", d_em, ctc.d_em_plain(
        em, want, can_skip, lengths, tl, scale, nll), **F32_TOL)
    lp = torch.log_softmax(logits, -1).transpose(0, 1).contiguous()
    lp.requires_grad_()
    ctc_args = (targets, lengths.long(), tl.long())
    with torch.enable_grad():
        lib_loss = F.ctc_loss(lp, *ctc_args, reduction="sum",
                              zero_infinity=True)
    shape = f"em=({t_len},{b},{2 * L + 1}) targets {ASR_MIN_TOKENS}-{L}"
    record("ctc_alphas", max_abs_err=err_a, shape=shape,
           ms=cuda_ms(lambda: ctc.ctc_alphas(em, can_skip, lengths, tl)),
           plain_ms=cuda_ms(lambda: ctc.alphas_plain(em, can_skip, lengths,
                                                     tl), samples=3, runs=3),
           library_ms=cuda_ms(lambda: F.ctc_loss(
               lp, *ctc_args, reduction="sum", zero_infinity=True)),
           **dict(zip(("bound_ms", "bound_by"), bound(
               nbytes(em, can_skip, lengths, tl, got),
               12 * em.numel()))))
    # the alpha kernel on its other block shapes (halo warps at S 257, an
    # exchange every step at S 1023, 2 and 4 states a thread at S 1025 and
    # 2049, where d_em is held to its plain version too), T 256, B 32,
    # ragged lengths
    gs, alpha_wide = torch.Generator().manual_seed(SEED + 19), {}
    d_em_wide = {}
    for s_ in CTC_ALPHA_WIDE_S:
        Ls = (s_ - 1) // 2
        # above S 1024 targets of 32-96 labels, which fit 128-256 frames,
        # so that d_em has posteriors to compare; the alphas run over
        # every state whatever the length
        tls = torch.randint(Ls // 2, Ls + 1, (b,), generator=gs) \
            if s_ <= 1024 else torch.randint(32, 97, (b,), generator=gs)
        ils = torch.randint(t_len // 2, t_len + 1, (b,), generator=gs)
        tgs = torch.randint(4, 9, (b, Ls), generator=gs)
        tgs = torch.where(torch.arange(Ls)[None] < tls[:, None], tgs,
                          torch.ones_like(tgs))
        _, skips = ctc._ctc_masks(tgs.to(dev), 0)
        ems = torch.log_softmax(torch.randn(t_len, b, s_, generator=gs),
                                -1).to(dev)
        args_s = (ems, skips, ils.to(dev), tls.to(dev))
        got_s = ctc.ctc_alphas(*args_s)
        torch.cuda.synchronize()
        want_s = ctc.alphas_plain(*args_s)
        sent_s = want_s <= ctc.NEG / 2
        if not torch.equal(got_s <= ctc.NEG / 2, sent_s) or \
                not torch.equal(got_s[sent_s], want_s[sent_s]):
            raise AssertionError(f"ctc_alphas S {s_}: the sentinels differ")
        ms_s = cuda_ms(lambda: ctc.ctc_alphas(*args_s))
        alpha_wide[f"S {s_}"] = {
            "max_abs_err": max_err(f"ctc_alphas S {s_}", got_s[~sent_s],
                                   want_s[~sent_s], **F32_TOL),
            "ms": ms_s, "us_per_step": ms_s * 1e3 / t_len}
        if s_ <= 1024:
            continue
        nll_s = ctc._nll_from_alpha(want_s[-1], tls.to(dev))
        # zero_infinity's scale: 0 where the target cannot fit its frames
        scale_s = torch.where(nll_s <= -ctc.NEG / 2,
                              -torch.rand(b, generator=gs).to(dev), 0.0)
        d_args = (ems, want_s, skips, ils.to(dev), tls.to(dev), scale_s,
                  nll_s)
        got_d = ctc.ctc_d_em(*d_args)
        torch.cuda.synchronize()
        ms_d = cuda_ms(lambda: ctc.ctc_d_em(*d_args))
        d_em_wide[f"S {s_}"] = {
            "max_abs_err": max_err(f"ctc_d_em S {s_}", got_d,
                                   ctc.d_em_plain(*d_args), **F32_TOL),
            "ms": ms_d, "us_per_step": ms_d * 1e3 / t_len,
            "examples_with_posteriors": int((scale_s != 0).sum())}
    record("ctc_alphas", max_abs_err=max(
        v["max_abs_err"] for v in alpha_wide.values()),
        us_per_step=report["ctc_alphas"]["ms"] * 1e3 / t_len,
        ptxas=ptxas_report("ctc_alpha_"), shapes=alpha_wide,
        chain_floor=ctc_chain_floor(dev))
    d_em_ms = cuda_ms(lambda: ctc.ctc_d_em(em, want, can_skip, lengths, tl,
                                           scale, nll))
    record("ctc_d_em", max_abs_err=max(
        [err_d] + [v["max_abs_err"] for v in d_em_wide.values()]),
           shape=shape, ms=d_em_ms, us_per_step=d_em_ms * 1e3 / t_len,
           shapes=d_em_wide,
           ptxas={**ptxas_report("ctc_beta_"),
                  **ptxas_report("ctc_posterior_kernel")},
           plain_ms=cuda_ms(lambda: ctc.d_em_plain(
               em, want, can_skip, lengths, tl, scale, nll), samples=3,
               runs=3),
           library_ms=cuda_ms(lambda: torch.autograd.grad(
               lib_loss, lp, retain_graph=True)),
           **dict(zip(("bound_ms", "bound_by"), bound(
               nbytes(em, want, can_skip, lengths, tl, d_em),
               16 * em.numel()))))

    # bf16: the LN-FFN and the attention take it (the ASR path runs fp32)
    bf = torch.bfloat16
    xb, dyb = x.to(bf), dy.to(bf)
    lnb = list(lnw[:2]) + [w.to(bf) for w in lnw[2:]]   # LN params fp32
    cfg = ("gelu", 0.1, 0.1, 17)
    errs = {"fused_ln_ffn_res_backward": max(
        [max_err("fused_ln_ffn_res bf16", ffn.fused_ln_ffn_res_forward(
            xb, *lnb, *cfg), ffn.ln_ffn_res_plain(xb, *lnb, *cfg),
            **BF16_TOL)] +
        [max_err("fused_ln_ffn_res_backward bf16 dx", *pair[:2], **BF16_TOL)
         if pair[2] == "dx" else
         max_err_to_largest(f"fused_ln_ffn_res_backward bf16 {pair[2]}",
                            pair[0], pair[1], 1e-2)
         for pair in zip(ffn.fused_ln_ffn_res_backward(xb, *lnb[:5], dyb,
                                                       *cfg),
                         ffn.ln_ffn_res_plain_backward(xb, *lnb[:5], dyb,
                                                       *cfg),
                         ("dx",) + names)])}
    argsb = (q3.to(bf), k.to(bf), v.to(bf), lengths)
    errs["emformer_grouped_attention_backward"] = max(
        [max_err("emformer_grouped_attention bf16",
                 ea.emformer_grouped_attention_forward(*argsb, geom, 0.1, 23),
                 ea.grouped_attention_plain(*argsb, geom, 0.1, 23),
                 **BF16_TOL)] +
        [max_err(f"emformer_grouped_attention_backward bf16 d{w}", x_, y_,
                 **BF16_TOL)
         for w, x_, y_ in zip("qkv", ea.emformer_grouped_attention_backward(
             *argsb, dout.to(bf), geom, 0.1, 23),
             ea.grouped_attention_plain_backward(*argsb, dout.to(bf), geom,
                                                 0.1, 23))])
    for name, err in errs.items():
        report[name]["bf16_max_abs_err"] = err

    # the linear-res and MHA forwards at the step's shapes (rate 0.1), on
    # inputs of their own generator: the Emformer out-projection (32 x 2
    # groups of 200 rows, 192 residual rows each) and the decoder's
    # epilogues (32 x 72 rows); the decoder's causal self-attention (its
    # target mask) and cross-attention (the encoder's frames)
    from simulst_tpu_torch.ops import linear_res, mha
    ge = torch.Generator().manual_seed(SEED + 13)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=ge) * scale).to(dev)

    w, bias = rand(d, d, scale=d ** -0.5), rand(d, scale=0.02)
    for case, rows, period, res_rows in (
            ("encoder h=(12800,256) period 200 gate 192", 12800, 200, 192),
            ("decoder h=(2304,256)", 2304, 0, 0)):
        h, res = rand(rows, d), rand(rows, d)
        cfg = (period, res_rows, 0.1, 7)
        err = max_err(f"fused_linear_res {case}",
                      linear_res.fused_linear_res_forward(h, w, bias, res,
                                                          *cfg),
                      linear_res.linear_res_plain(h, w, bias, res, *cfg),
                      **F32_TOL)
        log("phase7", kernel="fused_linear_res", case=case, rate=0.1,
            max_abs_err=err,
            **linear_res_forward_case(h, w, bias, res, period, res_rows,
                                      0.1))
    t_len = batch["prev_tokens"].shape[1]
    tgt_mask = (batch["prev_tokens"] != 1).to(torch.int32)
    enc_mask = (torch.arange(256, device=dev)[None, :] <
                lengths[:, None]).to(torch.int32)
    for case, kmask, causal in (
            (f"decoder self ({b},{t_len},{t_len}) causal", tgt_mask, True),
            (f"cross ({b},{t_len},256)", enc_mask, False)):
        q = rand(b, t_len, d)
        k, v = rand(b, kmask.shape[1], d), rand(b, kmask.shape[1], d)
        cfg = (heads, causal, 0.1, 4321)
        err = max_err(f"fused_mha {case}",
                      mha.fused_mha_forward(q, k, v, kmask, *cfg)[0],
                      mha.mha_plain(q, k, v, kmask, *cfg), **F32_TOL)
        log("phase7", kernel="fused_mha", case=case, rate=0.1,
            max_abs_err=err,
            **mha_forward_case(q, k, v, kmask, heads, causal, 0.1))
    for name, entry in report.items():
        log("phase7", kernel=name, **entry)
    return report


def phase_asr_train(dev, batch, save_path):
    """8 full-width ASR training steps of s2t_emformer with joint CTC
    through the CLI's model and loss and the train step, counting
    launches; 3 profiled steps, after which the trained parameters are
    saved to save_path (the MMA phase's encoder); then kernels vs plain on
    one step.  Returns (launches, median step ms, {median_step_ms,
    peak_memory_gib, device_ms_per_step, busy_share})."""
    import torch
    from simulst_tpu_torch.cli import train as cli
    from simulst_tpu_torch.train.checkpoint import save_checkpoint
    from simulst_tpu_torch.train.state import (create_train_state,
                                               make_accum_train_step,
                                               make_train_step)

    args = cli.parse_args(ASR_ARGS)
    model = cli.build_model(args, ASR_VOCAB, device=dev)
    loss_fn = cli.build_loss(args, model)
    optim_cfg = cli.optim_config(args)
    train_step = make_train_step(loss_fn, optim_cfg)
    state = create_train_state(model, optim_cfg)
    generator = torch.Generator().manual_seed(SEED)
    ntokens = int((batch["target"] != 1).sum())

    # the kernels-vs-plain step runs from the initial parameters: a 1e-7
    # relative perturbation of the parameters alone moves this model's
    # deepest gradients by about 5e-5 of their largest entries (the floor
    # compare_plain_step logs; PERF.md, PR 3), so the 1e-4 limit sits near
    # that floor
    initial = copy.deepcopy(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    step_ms, losses = [], []
    for _ in range(ASR_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, generator)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]) / float(metrics["sample_size"]))
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    per_step = {k: launches[k] / ASR_STEPS for k in ASR_LAUNCHES_PER_STEP}
    if per_step != ASR_LAUNCHES_PER_STEP:
        raise AssertionError(f"launches per step {per_step}, expected "
                             f"{ASR_LAUNCHES_PER_STEP}")
    if not all(np.isfinite(losses)) or state.step != ASR_STEPS:
        raise AssertionError(f"losses {losses}, updates {state.step}")
    log("phase8", config="S2TEmformerConfig() s2t_emformer_s, ctc_layer",
        utterances=ASR_UTT, frames=f"{ASR_MIN_FRAMES}-{ASR_FRAMES}",
        target_tokens=ntokens, steps=ASR_STEPS, first_step_ms=step_ms[0],
        median_step_ms=statistics.median(step_ms[1:]), step_ms=step_ms,
        losses=losses, launches_per_step=per_step, peak_memory_gib=peak_gib,
        ctc_loss=float(metrics["ctc_loss"]) / float(metrics["sample_size"]))

    summary = dict(median_step_ms=statistics.median(step_ms[1:]),
                   peak_memory_gib=peak_gib)
    state = profile_steps(state, train_step, batch, generator, "phase8",
                          out=summary)
    save_checkpoint(save_path, state.model.state_dict(),
                    {"model": "s2t_emformer", "step": state.step})
    del state
    compare_plain_step(initial, loss_fn, optim_cfg, batch, "phase8",
                       make_accum_train_step)
    return launches, statistics.median(step_ms[1:]), summary


def packed_attention_inputs(ea, plan, dev, g):
    """Seeded fp32 q3, k, v, dout of the packed rows' grouped attention,
    with the full-row lengths, the geometry (s2t_emformer_s's, G from the
    row length) and the gate, on the card."""
    import torch
    from simulst_tpu_torch.models.s2t_emformer import S2TEmformerConfig
    from simulst_tpu_torch.nn import emformer as emf
    ecfg = S2TEmformerConfig().emformer
    rows, n_p = plan.seg_eid.shape
    geom = ea.AttnGeom(U=n_p * ecfg.segment, seg=ecfg.segment,
                       lc=ecfg.left_context, rc=ecfg.right_context,
                       max_mem=ecfg.max_memory,
                       G=emf._choose_group(n_p, n_p * ecfg.segment, ecfg),
                       num_heads=ecfg.num_heads)
    eids = emf.make_packed_eids(ecfg, torch.from_numpy(plan.frame_eid),
                                torch.from_numpy(plan.seg_eid))
    gate = ea.EidGate(eids.kid.to(dev), eids.seg_eid.to(dev))
    d = ecfg.input_dim

    def randn(*shape):
        return torch.randn(shape, generator=g).to(dev)

    q3, dout = (randn(rows, geom.ng, geom.nq, d) for _ in range(2))
    k, v = randn(rows, geom.tk, d), randn(rows, geom.tk, d)
    full = torch.full((rows,), geom.U, dtype=torch.int32, device=dev)
    return (q3, k, v, full), dout, geom, gate


def phase_pack_kernels(dev, plans):
    """The gated grouped attention vs its plain version with the gate on
    each plan's packed rows, forward and backward at dropout 0 and 0.1;
    CUDA-event times at 0.1 beside the ungated kernel at the same shapes
    and SDPA with the gate in its mask.  The report holds the first
    plan's (the main path's)."""
    import torch
    import torch.nn.functional as F
    from simulst_tpu_torch.ops import emformer_attn as ea

    g = torch.Generator().manual_seed(SEED + 8)
    report = {}
    for label, plan in plans.items():
        args, dout, geom, gate = packed_attention_inputs(ea, plan, dev, g)
        d = args[0].shape[-1]
        errs = {}
        for rate in (0.0, 0.1):
            out = ea.emformer_grouped_attention_forward(*args, geom, rate, 29,
                                                        gate)
            torch.cuda.synchronize()
            e_fwd = max_err(f"gated attention {label} rate {rate}", out,
                            ea.grouped_attention_plain(*args, geom, rate, 29,
                                                       gate), **F32_TOL)
            got = ea.emformer_grouped_attention_backward(*args, dout, geom,
                                                         rate, 29, gate)
            want = ea.grouped_attention_plain_backward(*args, dout, geom,
                                                       rate, 29, gate)
            torch.cuda.synchronize()
            e_bwd = max(max_err(f"gated attention backward {label} rate "
                                f"{rate} d{w}", x_, y_, **F32_TOL)
                        for w, x_, y_ in zip("qkv", got, want))
            errs = {"fwd": max(errs.get("fwd", 0.0), e_fwd),
                    "bwd": max(errs.get("bwd", 0.0), e_bwd)}
        rate = 0.1
        sd, mask = sdpa_on_context(ea, geom, *args, gate)
        sd = [t.requires_grad_() for t in sd]
        with torch.enable_grad():
            sd_out = F.scaled_dot_product_attention(*sd, attn_mask=mask,
                                                    dropout_p=rate)
        sd_dout = torch.randn_like(sd_out)
        vis = grouped_visible_pairs(ea, geom, *args, gate)
        vis_dense = grouped_visible_pairs(ea, geom, *args)
        shape = (f"q3=({args[0].shape[0]},{geom.ng},{geom.nq},{d}) "
                 f"kv=({args[0].shape[0]},{geom.tk},{d}) G {geom.G} rate 0.1")
        fwd = dict(
            max_abs_err=errs["fwd"], shape=shape,
            ms=cuda_ms(lambda: ea.emformer_grouped_attention_forward(
                *args, geom, rate, 29, gate)),
            ungated_ms=cuda_ms(lambda: ea.emformer_grouped_attention_forward(
                *args, geom, rate, 29)),
            plain_ms=cuda_ms(lambda: ea.grouped_attention_plain(
                *args, geom, rate, 29, gate), samples=5, runs=5),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                *sd, attn_mask=mask, dropout_p=rate)),
            visible_pairs=vis, visible_pairs_ungated=vis_dense,
            **dict(zip(("bound_ms", "bound_by"), bound(
                nbytes(*args, *gate, out), 4 * d * vis))))
        bwd = dict(
            max_abs_err=errs["bwd"], shape=shape,
            ms=cuda_ms(lambda: ea.emformer_grouped_attention_backward(
                *args, dout, geom, rate, 29, gate)),
            ungated_ms=cuda_ms(lambda: ea.emformer_grouped_attention_backward(
                *args, dout, geom, rate, 29)),
            plain_ms=cuda_ms(lambda: ea.grouped_attention_plain_backward(
                *args, dout, geom, rate, 29, gate), samples=5, runs=5),
            library_ms=cuda_ms(lambda: torch.autograd.grad(
                sd_out, sd, sd_dout, retain_graph=True)),
            **dict(zip(("bound_ms", "bound_by"), bound(
                nbytes(*args, *gate, dout, *got), 10 * d * vis))))
        del sd, sd_out
        log("phase17", kernel="emformer_grouped_attention_gated", plan=label,
            **fwd)
        log("phase17", kernel="emformer_grouped_attention_gated_backward",
            plan=label, **bwd)
        if not report:
            report = {"emformer_grouped_attention_gated": fwd,
                      "emformer_grouped_attention_gated_backward": bwd}
    return report


def phase_asr_pack(dev, batch, unpacked_median_ms):
    """The --pack path: its plans and the gated kernels at their shapes,
    then 8 full-width packed ASR training steps through the CLI's
    parse_args, model, loss and attach_pack_plan, counting launches; 3
    profiled steps; one step packed vs unpacked from the same parameters;
    kernels vs plain on one packed step."""
    import torch
    from simulst_tpu_torch.cli import train as cli
    from simulst_tpu_torch.models import s2t_emformer as s2t
    from simulst_tpu_torch.train import packing
    from simulst_tpu_torch.train.state import (create_train_state,
                                               make_accum_train_step,
                                               make_train_step)

    args = cli.parse_args(ASR_ARGS + ["--pack"])
    model = cli.build_model(args, ASR_VOCAB, device=dev)
    loss_fn = cli.build_loss(args, model)
    optim_cfg = cli.optim_config(args)

    def plan_of(b):
        host = cli.attach_pack_plan(dict(b), model, {})
        return packing.PackPlan(*(host[f"pack_{f}"]
                                  for f in packing.PackPlan._fields))

    rng = np.random.RandomState(SEED + 9)
    mixed = rng.randint(PACK_MIXED_MIN_FRAMES, ASR_FRAMES + 1, ASR_UTT)
    mixed[0] = ASR_FRAMES
    plans = {"phase 7 batch": plan_of(batch), "mixed 96-1024": plan_of(
        {"feats": batch["feats"], "feat_lengths": torch.from_numpy(mixed)})}
    n0 = ASR_FRAMES // 4 // 16
    for label, plan in plans.items():
        rows, n_p = plan.seg_eid.shape
        log("phase17", plan=label, rows=rows, n_p=n_p,
            row_frames=n_p * 16, G=s2t.emf._choose_group(
                n_p, n_p * 16, model.cfg.emformer),
            slots=rows * n_p, unpacked_slots=ASR_UTT * n0,
            live_segments=int((plan.seg_eid >= 0).sum()),
            dead_rows=int((plan.seg_eid < 0).all(axis=1).sum()))
    with torch.no_grad():
        report = phase_pack_kernels(dev, plans)

    packed = {k: torch.as_tensor(v, device=dev) for k, v in
              cli.attach_pack_plan(dict(batch), model, {}).items()}
    train_step = make_train_step(loss_fn, optim_cfg)
    state = create_train_state(model, optim_cfg)
    generator = torch.Generator().manual_seed(SEED)
    initial = copy.deepcopy(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    step_ms, losses = [], []
    for _ in range(ASR_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, packed, generator)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]) / float(metrics["sample_size"]))
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    per_step = {k: launches[k] / ASR_STEPS for k in PACK_LAUNCHES_PER_STEP}
    if per_step != PACK_LAUNCHES_PER_STEP:
        raise AssertionError(f"packed launches per step {per_step}, "
                             f"expected {PACK_LAUNCHES_PER_STEP}")
    if not all(np.isfinite(losses)) or state.step != ASR_STEPS:
        raise AssertionError(f"losses {losses}, updates {state.step}")
    median = statistics.median(step_ms[1:])
    log("phase17", config="S2TEmformerConfig() s2t_emformer_s, ctc_layer, "
        "--pack", utterances=ASR_UTT, rows=int(packed["pack_seg_eid"].shape[0]),
        steps=ASR_STEPS, first_step_ms=step_ms[0], median_step_ms=median,
        unpacked_median_step_ms=unpacked_median_ms,
        packed_over_unpacked=median / unpacked_median_ms, step_ms=step_ms,
        losses=losses, launches_per_step=per_step, peak_memory_gib=peak_gib,
        ctc_loss=float(metrics["ctc_loss"]) / float(metrics["sample_size"]))
    state = profile_steps(state, train_step, packed, generator, "phase17")
    del state

    # packed vs unpacked from the same parameters, at dropout 0 without
    # SpecAugment (no generator)
    grad_step, _ = make_accum_train_step(loss_fn, optim_cfg)
    outs = []
    for b in (batch, packed):
        st = copy.deepcopy(initial)
        m = grad_step(st, b, None)
        outs.append(({n: p.grad.clone() for n, p in
                      st.model.named_parameters()}, float(m["loss"])))
        del st
    (g_d, loss_d), (g_p, loss_p) = outs
    plan = packing.PackPlan(*(packed[f"pack_{f}"]
                              for f in packing.PackPlan._fields))
    with torch.no_grad():
        enc = s2t.encoder_forward(initial.model.encoder, model.cfg,
                                  batch["feats"], batch["feat_lengths"])
        enc_p = s2t.encoder_forward_packed(initial.model.encoder, model.cfg,
                                           batch["feats"],
                                           batch["feat_lengths"], plan)
    valid = (torch.arange(enc.encoder_out.shape[1], device=dev)[None, :]
             < enc.lengths[:, None])
    enc_err = max_err("packed vs unpacked encoder output",
                      enc_p.encoder_out[valid], enc.encoder_out[valid],
                      atol=1e-4, rtol=0.0)
    rel = {n: (g_p[n] - g_d[n]).abs().max().item() / grad_scale(g_d, n)
           for n in g_d}
    worst = max(rel, key=rel.get)
    if rel[worst] > 2e-4 or abs(loss_p - loss_d) > 1e-5 * abs(loss_d):
        raise AssertionError(
            f"packed vs unpacked step: gradient of {worst} off by "
            f"{rel[worst]:.3e} of its largest entry; loss {loss_p} vs "
            f"{loss_d}")
    log("phase17", packed_vs_unpacked_loss=[loss_p, loss_d],
        encoder_out_max_abs_err=enc_err,
        grads_max_err_to_largest=rel[worst], grads_worst_param=worst,
        grads_top=sorted(rel.items(), key=lambda kv: -kv[1])[:6])
    # every gradient within 1e-4 of its largest entry, the loss and the
    # updated parameters as in phase 8; the gradient norm only logged: on
    # this model a 1e-7 perturbation of the parameters moves it by up to
    # 2.1e-5 relative, and kernels vs plain differ by -1.4e-5 to +1.6e-5
    # over four such perturbations, packed or not (tools/gnorm_floor.py,
    # PERF.md), so a 1e-5 limit would hold it to rounding
    compare_plain_step(initial, loss_fn, optim_cfg, packed, "phase17",
                       make_accum_train_step, gnorm_rtol=None)
    return launches, report


def alignment_panels(dev, n, u, s, waitk=False):
    """(prefix, denom, g) on the card as expected_alignment_from_p_choose
    makes them from a seeded p in [0.05, 0.95], or from wait-k's one-hot
    rows (lagging 3); g a seeded upstream gradient."""
    import torch
    g = torch.Generator().manual_seed(SEED + n + u + s)
    if waitk:
        steps = torch.clamp(torch.arange(u) + 2, max=s - 1)
        p = (torch.arange(s)[None, :] == steps[:, None]).float().expand(
            n, u, s)
    else:
        p = 0.05 + 0.9 * torch.rand(n, u, s, generator=g)
    cp = torch.exp(torch.cumsum(torch.log(torch.cat(
        [torch.ones(n, u, 1), 1 - p], dim=2) + 1e-6), dim=2))[..., :s]
    return [t.contiguous().to(dev) for t in (
        p * cp, torch.clamp(cp, 1e-6, 1.0),
        torch.randn(n, u, s, generator=g))]


def kernel_name(mangled, fragment):
    """The name from `fragment` on in a mangled kernel name, a template's
    integer and bool arguments written <1,4>, a float or bf16 type argument
    <float>."""
    rest = mangled[mangled.index(fragment):]
    name = re.match(r"[a-z0-9_]+", rest).group(0)
    args = re.match(r"I((?:L[ib]\d+E)*)(f|13__nv_bfloat16)?E",
                    rest[len(name):])
    if args and args.group(0) != "IE":
        name += "<" + ",".join(
            re.findall(r"L[ib](\d+)E", args.group(1))
            + ([{"f": "float"}.get(args.group(2), "bf16")]
               if args.group(2) else [])) + ">"
    return name


def ptxas_report(fragment):
    """{kernel: {"registers", "spill_bytes"}} from the ptxas report of the
    library's build (nvcc -Xptxas -v), for every entry function whose name
    holds `fragment`; {} without a report."""
    from simulst_tpu_torch.ops import _build
    path = _build.library_path().with_suffix(".log")
    if not path.exists():
        return {}
    report, name = {}, None
    for line in path.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_name(m.group(1), fragment) \
                if fragment in m.group(1) else None
            if name:
                report[name] = {}
            continue
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
        regs = re.search(r"Used (\d+) registers", line)
        if name and spills:
            report[name]["spill_bytes"] = sum(map(int, spills.groups()))
        if name and regs:
            report[name]["registers"] = int(regs.group(1))
    return report


CHAIN_PROBE_STEPS = (256, 65536)
# phase 7's alpha shapes beside S 129; d_em too above S 1024
CTC_ALPHA_WIDE_S = (33, 257, 1023, 1025, 2049)


def ctc_chain_floor(dev):
    """The CTC recursions' chain floor: one warp runs T dependent steps of
    alpha = e + LSE(LSE(alpha, a1), a2) on registers, no memory traffic,
    its neighbours fixed or taken by the two shuffles the kernels take
    (csrc/ctc.cu ctc_chain_probe_kernel).  {"shuffles N": {"ms_T<T>",
    "us_per_step"}}, us_per_step from the longest T."""
    import torch
    from simulst_tpu_torch.ops import _build
    g = torch.Generator().manual_seed(SEED + 17)
    seed = torch.cat([-10 * torch.rand(32, generator=g),
                      -torch.rand(32, generator=g),
                      -10 * torch.rand(32, generator=g)]).to(dev)
    out = torch.empty(32, device=dev)
    floor = {}
    for shuffles in (0, 1):
        ms = {t: cuda_ms(functools.partial(
            _build.launch, "simulst_ctc_chain_probe", seed.data_ptr(),
            out.data_ptr(), t, shuffles, _build.stream_of(seed)),
            samples=5, runs=5) for t in CHAIN_PROBE_STEPS}
        if not torch.isfinite(out).all():
            raise AssertionError("ctc chain probe: non-finite alphas")
        floor[f"shuffles {shuffles}"] = {
            **{f"ms_T{t}": v for t, v in ms.items()},
            "us_per_step": ms[CHAIN_PROBE_STEPS[-1]] * 1e3
            / CHAIN_PROBE_STEPS[-1]}
    return floor


def alignment_kernel(report, half, s):
    """The ptxas report's entry for the alignment kernel that runs S
    positions: ceil(S / 32) groups up to 256, tiles above."""
    if s > 256:
        return report.get(f"alignment_{half}_tiles_kernel")
    return report.get(f"alignment_{half}_kernel<{-(-s // 32)}>")


def phase_mma_kernels(dev):
    """The alignment recursion's kernels vs their plain versions at the
    recipe's pooled shape (32 utterances x 4 heads, 72 target steps, 256
    frames pooled by 8), unpooled, ragged (S 29, U 1), S 33 and S 257 and
    on wait-k's one-hot rows.  No single PyTorch call computes the
    recursion: no library time."""
    from simulst_tpu_torch.ops import monotonic_align as ma

    cases = {"pooled (N,U,S)=(128,72,32)": (128, 72, 32, False),
             "unpooled (N,U,S)=(128,72,256)": (128, 72, 256, False),
             "ragged (N,U,S)=(128,1,29)": (128, 1, 29, False),
             "S 33 (N,U,S)=(128,72,33)": (128, 72, 33, False),
             "S 257 (N,U,S)=(128,72,257)": (128, 72, 257, False),
             "waitk one-hot (N,U,S)=(128,72,32)": (128, 72, 32, True)}
    ptxas = ptxas_report("alignment_")
    log("phase9", ptxas=ptxas)
    report = {}
    for i, (label, (n, u, s, waitk)) in enumerate(cases.items()):
        prefix, denom, g = alignment_panels(dev, n, u, s, waitk)
        alphas = ma.alignment_fwd(prefix, denom)
        err_f = max_err(f"alignment_fwd {label}", alphas,
                        ma.alignment_fwd_plain(prefix, denom), atol=1e-4,
                        rtol=0.0)
        got = ma.alignment_bwd(prefix, denom, alphas, g)
        want = ma.alignment_bwd_plain(prefix, denom, alphas, g)
        err_b = max(max_err_to_largest(f"alignment_bwd {label} {w}", x, y)
                    for w, x, y in zip(("d_prefix", "d_denom"), got, want))
        largest = max(y.abs().max().item() for y in want)
        # forward: divide, scan add, multiply, two clip compares per entry;
        # backward: the forward's c again, the gate, two products, the
        # reverse scan, d_denom's three operations and the carry's divide
        fwd = dict(zip(("bound_ms", "bound_by"), bound(
            nbytes(prefix, denom, alphas), 5 * prefix.numel())))
        bwd = dict(zip(("bound_ms", "bound_by"), bound(
            nbytes(prefix, denom, alphas, g, *got), 12 * prefix.numel())))
        fwd.update(ms=cuda_ms(lambda: ma.alignment_fwd(prefix, denom)),
                   plain_ms=cuda_ms(lambda: ma.alignment_fwd_plain(
                       prefix, denom), samples=3, runs=3))
        bwd.update(ms=cuda_ms(lambda: ma.alignment_bwd(prefix, denom, alphas,
                                                       g)),
                   plain_ms=cuda_ms(lambda: ma.alignment_bwd_plain(
                       prefix, denom, alphas, g), samples=3, runs=3))
        for half, t in (("fwd", fwd), ("bwd", bwd)):
            t.update(ms_per_step=t["ms"] / u,
                     ptxas=alignment_kernel(ptxas, half, s))
        log("phase9", case=label, fwd_max_abs_err=err_f,
            bwd_max_abs_err=err_b, bwd_largest_entry=largest, fwd=fwd,
            bwd=bwd)
        for name, err, t in (("alignment_fwd", err_f, fwd),
                             ("alignment_bwd", err_b, bwd)):
            entry = report.setdefault(name, {"max_abs_err": 0.0,
                                             "library_ms": None})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            if i == 0:
                entry.update(shape=label, **t)
            elif s == 256:
                entry["unpooled_ms"] = t["ms"]
                entry["unpooled_bound_ms"] = t["bound_ms"]
    for name, entry in report.items():
        log("phase9", kernel=name, **entry)
    return report


def phase_mma_train(dev, batch, asr_checkpoint):
    """8 full-width MMA training steps with exp/2_mma.sh's options through
    the CLI (the encoder loaded from phase 8's checkpoint), counting
    launches; 3 profiled steps; then kernels vs plain on one step from the
    initial parameters.  Returns (launches, the trained model)."""
    import torch
    from simulst_tpu_torch.cli import train as cli
    from simulst_tpu_torch.train.checkpoint import load_checkpoint
    from simulst_tpu_torch.train.state import (create_train_state,
                                               make_accum_train_step,
                                               make_train_step)

    args = cli.parse_args(MMA_ARGS + ["--load-pretrained-encoder-from",
                                      asr_checkpoint])
    model = cli.build_model(args, ASR_VOCAB, device=dev)
    asr, _ = load_checkpoint(asr_checkpoint)
    loaded = {k: v for k, v in model.state_dict().items()
              if k.startswith("encoder.")}
    if "encoder.ctc_layer.weight" not in asr or not all(
            torch.equal(v.cpu(), asr[k]) for k, v in loaded.items()):
        raise AssertionError("the MMA encoder is not phase 8's encoder")
    loss_fn = cli.build_loss(args, model)
    optim_cfg = cli.optim_config(args)
    train_step = make_train_step(loss_fn, optim_cfg)
    state = create_train_state(model, optim_cfg)
    generator = torch.Generator().manual_seed(SEED)
    ntokens = int((batch["target"] != 1).sum())

    initial = copy.deepcopy(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    step_ms, losses, latency = [], [], []
    for _ in range(MMA_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, generator)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]) / float(metrics["sample_size"]))
        latency.append(float(metrics["latency_loss"])
                       / float(metrics["sample_size"]))
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    per_step = {k: launches[k] / MMA_STEPS for k in MMA_LAUNCHES_PER_STEP}
    if per_step != MMA_LAUNCHES_PER_STEP:
        raise AssertionError(f"launches per step {per_step}, expected "
                             f"{MMA_LAUNCHES_PER_STEP}")
    if not all(np.isfinite(losses + latency)) or state.step != MMA_STEPS:
        raise AssertionError(f"losses {losses}, latency terms {latency}, "
                             f"updates {state.step}")
    log("phase10", config="MMAConfig() " + " ".join(MMA_ARGS[6:16]),
        utterances=ASR_UTT, frames=f"{ASR_MIN_FRAMES}-{ASR_FRAMES}",
        target_tokens=ntokens, steps=MMA_STEPS, first_step_ms=step_ms[0],
        median_step_ms=statistics.median(step_ms[1:]), step_ms=step_ms,
        losses=losses, latency_loss_per_token=latency,
        launches_per_step=per_step, peak_memory_gib=peak_gib)

    state = profile_steps(state, train_step, batch, generator, "phase10")
    compare_plain_step(initial, loss_fn, optim_cfg, batch, "phase10",
                       make_accum_train_step)
    return launches, state.model


def mma_stepwise(model, cfg, feats, plan, dev):
    """Tokens of the host-driven step-by-step session: per chunk the
    encoder step, then mma_decoder_step until a READ or a premature EOS,
    which keep the old state but for the monotonic positions."""
    import torch
    from simulst_tpu_torch.models import mma
    from simulst_tpu_torch.models import s2t_emformer as s2t
    enc_state = s2t.encoder_init_state(model.encoder, cfg, 1, device=dev)
    dec = mma.mma_decoder_init_state(cfg, 1, MMA_MAX_TOKENS, device=dev)
    enc_buf = torch.zeros(1, ASR_FRAMES // cfg.stride, cfg.embed_dim,
                          device=dev)
    src_len, tokens, finished, t = 0, [], False, 0
    for i, c in enumerate(plan):
        finish = i == len(plan) - 1
        out, enc_state = s2t.encoder_step(model.encoder, cfg, enc_state,
                                          feats[:, t:t + c], finish)
        t += c
        n = out.encoder_out.shape[1]
        enc_buf[:, src_len:src_len + n] = out.encoder_out
        src_len += n
        while not finished and len(tokens) < MMA_MAX_TOKENS - 1:
            prev = torch.tensor([tokens[-1] if tokens else cfg.eos_idx],
                                device=dev)
            logits, action, new = mma.mma_decoder_step(
                model.decoder, cfg, dec, prev, enc_buf,
                torch.tensor([src_len], device=dev), not finish)
            tok = int(logits[0].argmax())
            if int(action[0]) == 0 or (tok == cfg.eos_idx and not finish):
                dec = mma.adopt_on_read(dec, new)
                break
            dec = new
            tokens.append(tok)
            finished = tok == cfg.eos_idx
    return tokens


def phase_mma_stream(dev, model, feats):
    """One 1024-frame utterance in 640 ms chunks (96, 14 x 64, 32 frames)
    through make_mma_fused_step; its tokens vs the step-wise loop's.  Then
    the same with EOS's embedding row shrunk 10x, so that the briefly
    trained model writes more than EOS: many WRITEs, READs and rollbacks
    on the card."""
    stream_session(dev, model, feats, "phase11")
    model = copy.deepcopy(model)
    model.decoder.embed_tokens.weight[model.cfg.eos_idx] *= 0.1
    stream_session(dev, model, feats, "phase11 (EOS row x 0.1)")


def stream_session(dev, model, feats, tag):
    import torch
    from simulst_tpu_torch.stream.fused import (make_mma_fused_step,
                                                mma_fused_init)
    cfg = model.cfg
    ecfg = cfg.emformer
    first = (ecfg.segment + ecfg.right_context) * cfg.stride
    steady = ecfg.segment * cfg.stride
    plan = [first] + [steady] * ((ASR_FRAMES - first) // steady)
    plan.append(ASR_FRAMES - sum(plan))
    step = make_mma_fused_step(model, cfg)
    state = mma_fused_init(model, cfg, ASR_FRAMES // cfg.stride,
                           MMA_MAX_TOKENS, device=dev)
    reset_launches()
    chunk_ms, written, t = [], [], 0
    for i, c in enumerate(plan):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, n_new = step(state, feats[:, t:t + c],
                            finish=i == len(plan) - 1)
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
        written.append(int(n_new[0]))
        t += c
    session = read_launches()
    for k in ("fused_ln_ffn_res", "fused_ffn"):
        if not session[k]:
            raise AssertionError(f"{k} did not launch in the MMA streaming "
                                 f"session: {session}")
    tokens = state.tokens[0, :int(state.n_tokens[0])].tolist()
    want = mma_stepwise(model, cfg, feats, plan, dev)
    if tokens != want:
        raise AssertionError(f"MMA fused step tokens {tokens} differ from "
                             f"the step-wise loop's {want}")
    log(tag, chunks=plan, tokens_per_chunk=written, chunk_ms=chunk_ms,
        n_tokens=len(tokens), distinct_tokens=len(set(tokens)),
        median_ms_per_chunk=statistics.median(chunk_ms),
        mean_ms_per_chunk=statistics.mean(chunk_ms),
        first_chunk_ms=chunk_ms[0], last_chunk_ms=chunk_ms[-1],
        fused_equals_stepwise=True, launches_in_session=session)


def cif_inputs(dev, b, s, c, t, beta, fill):
    """x (B, S, C) and weights alpha (B, S) on the card: seeded uniform
    weights scaled so that each row integrates `fill` of its t buckets
    (teacher forcing fills them all; fill < 1 leaves a tail), the frames
    past a ragged length zero."""
    import torch
    g = torch.Generator().manual_seed(SEED + b + s + t)
    x = torch.randn(b, s, c, generator=g)
    alpha = torch.rand(b, s, generator=g)
    lengths = torch.randint(max(1, s * 3 // 4), s + 1, (b,), generator=g)
    lengths[0] = s
    alpha = torch.where(torch.arange(s)[None, :] < lengths[:, None], alpha,
                        torch.zeros_like(alpha))
    alpha = alpha * (fill * t * beta / alpha.sum(1, keepdim=True))
    return x.to(dev), alpha.to(dev)


def phase_cif_kernels(dev):
    """The integrate-and-fire kernel vs its plain version at the cif-train
    batch's shape, a streaming chunk (the carried tail + 16 encoder frames),
    ragged, more than 128 buckets and a test-time beta; CUDA-event times
    beside torch.bmm on the same (B, S, T) portion tensor, built
    beforehand."""
    import torch
    from simulst_tpu_torch.ops import _build
    from simulst_tpu_torch.ops import cif_integrate as ci

    cases = {   # label -> (B, S, C, T, beta, fill)
        "train (B,S,C,T)=(32,256,256,72)": (32, 256, 256, 72, 1.0, 0.97),
        "stream (1,17,256,19)": (1, 17, 256, 19, 1.0, 0.45),
        "ragged (32,29,256,1)": (32, 29, 256, 1, 1.0, 0.9),
        "long (4,512,256,300)": (4, 512, 256, 300, 1.0, 0.97),
        "beta 0.8 (32,256,256,80)": (32, 256, 256, 80, 0.8, 0.97)}
    report = {"cif_integrate": {"max_abs_err": 0.0}}
    entry = report["cif_integrate"]
    for i, (label, (b, s, c, t, beta, fill)) in enumerate(cases.items()):
        x, alpha = cif_inputs(dev, b, s, c, t, beta, fill)
        out, delays = ci.cif_integrate(x, alpha, beta, t)
        torch.cuda.synchronize()
        want = ci.cif_integrate_plain(x, alpha, beta, t)
        err = max(max_err_to_largest(f"cif_integrate {label} {w}", got, ref,
                                     rtol=1e-5)
                  for w, got, ref in zip(("out", "delays"), (out, delays),
                                         want))
        csum, cprev = ci.cumsums(alpha)
        portion = ci.portions(csum, cprev, beta, t)
        nnz = int((portion > 0).sum())
        # bytes: x and alpha in, out and delays out; operations: one
        # multiply-add per channel and one for the delay per non-zero
        # portion
        b_ms, by = bound(nbytes(x, alpha, out, delays), 2 * nnz * (c + 1))
        pt = portion.transpose(1, 2).contiguous()
        buf = (torch.empty_like(out), torch.empty_like(delays))

        # the C entry alone on the cumsum above, its arguments bound: the
        # kernel without the wrapper's host work (cumsum, allocations,
        # checks)
        c_entry = functools.partial(
            _build.library().simulst_cif_integrate, x.data_ptr(),
            csum.data_ptr(), alpha.data_ptr(), buf[0].data_ptr(),
            buf[1].data_ptr(), b, s, t, c, float(beta), _build.stream_of(x))
        if c_entry() != 0:
            raise AssertionError("simulst_cif_integrate: CUDA error")

        t_case = dict(
            max_abs_err=err, nonzero_portions=nnz,
            ms=cuda_ms(lambda: ci.cif_integrate(x, alpha, beta, t)),
            host_ms=host_ms(lambda: ci.cif_integrate(x, alpha, beta, t)),
            c_entry_ms=cuda_ms(c_entry),
            plain_ms=cuda_ms(lambda: ci.cif_integrate_plain(x, alpha, beta,
                                                            t)),
            library_ms=cuda_ms(lambda: torch.bmm(pt, x)),
            library_host_ms=host_ms(lambda: torch.bmm(pt, x)),
            bound_ms=b_ms, bound_by=by)
        log("phase12", case=label, **t_case)
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if i == 0:
            entry.update(shape=label, **{k: v for k, v in t_case.items()
                                         if k != "max_abs_err"})
        else:
            entry[f"{label.split()[0]}_ms"] = t_case["ms"]
    log("phase12", kernel="cif_integrate", **entry)
    return report


def phase_cif_train(dev, batch, asr_checkpoint, save_path):
    """8 full-width CIF training steps with exp/3_cif.sh's options through
    the CLI (the encoder loaded from phase 8's checkpoint), counting
    launches; 3 profiled steps, after which the model is saved to
    save_path for the serving phase; then kernels vs plain on one step from
    the initial parameters."""
    import torch
    from simulst_tpu_torch import config as cfglib
    from simulst_tpu_torch.cli import train as cli
    from simulst_tpu_torch.train.checkpoint import (load_checkpoint,
                                                    save_checkpoint)
    from simulst_tpu_torch.train.state import (create_train_state,
                                               make_accum_train_step,
                                               make_train_step)

    args = cli.parse_args(CIF_ARGS + ["--load-pretrained-encoder-from",
                                      asr_checkpoint])
    model = cli.build_model(args, ASR_VOCAB, device=dev)
    asr, _ = load_checkpoint(asr_checkpoint)
    if not all(torch.equal(v.cpu(), asr[k]) for k, v in
               model.state_dict().items() if k.startswith("encoder.")):
        raise AssertionError("the CIF encoder is not phase 8's encoder")
    loss_fn = cli.build_loss(args, model)
    optim_cfg = cli.optim_config(args)
    train_step = make_train_step(loss_fn, optim_cfg)
    state = create_train_state(model, optim_cfg)
    generator = torch.Generator().manual_seed(SEED)
    ntokens = int((batch["target"] != 1).sum())

    initial = copy.deepcopy(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    step_ms, losses, parts = [], [], defaultdict(list)
    for _ in range(CIF_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, generator)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        n = float(metrics["sample_size"])
        losses.append(float(metrics["loss"]) / n)
        for k in ("ctc_loss", "quantity"):
            parts[k].append(float(metrics[k]) / n)
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    per_step = {k: launches[k] / CIF_STEPS for k in CIF_LAUNCHES_PER_STEP}
    if per_step != CIF_LAUNCHES_PER_STEP:
        raise AssertionError(f"launches per step {per_step}, expected "
                             f"{CIF_LAUNCHES_PER_STEP}")
    if not all(np.isfinite(losses + parts["ctc_loss"] + parts["quantity"])) \
            or state.step != CIF_STEPS:
        raise AssertionError(f"losses {losses}, {dict(parts)}, updates "
                             f"{state.step}")
    log("phase13", config="CIFConfig() " + " ".join(CIF_ARGS[6:16]),
        utterances=ASR_UTT, frames=f"{ASR_MIN_FRAMES}-{ASR_FRAMES}",
        target_tokens=ntokens, steps=CIF_STEPS, first_step_ms=step_ms[0],
        median_step_ms=statistics.median(step_ms[1:]), step_ms=step_ms,
        losses=losses, ctc_loss_per_token=parts["ctc_loss"],
        quantity_per_token=parts["quantity"], launches_per_step=per_step,
        peak_memory_gib=peak_gib)

    state = profile_steps(state, train_step, batch, generator, "phase13")
    save_checkpoint(save_path, state.model.state_dict(),
                    {"model": "cif", "config": cfglib.to_dict(model.cfg),
                     "step": state.step})
    del state
    compare_plain_step(initial, loss_fn, optim_cfg, batch, "phase13",
                       make_accum_train_step)
    return launches


# kernels each offline decode must launch: the speech encoder's (LN-FFN,
# grouped attention and its epilogue) and the decoder FFN for MMA and CIF,
# whose decoder steps run their self- and cross-attention in plain torch,
# and CIF's integrate-and-fire; the text encoder's attention cores and the
# decoder step's cross-attention (core and epilogue) and FFN for MT
OFFLINE_DECODE_KERNELS = {
    "mma": ("fused_ln_ffn_res", "emformer_grouped_attention",
            "fused_linear_res", "fused_ffn"),
    "cif": ("fused_ln_ffn_res", "emformer_grouped_attention",
            "fused_linear_res", "fused_ffn", "cif_integrate"),
    "mt": ("fused_mha", "fused_linear_res", "fused_ffn")}


def hypothesis_logits(build, model, batch, tokens, beam=BEAM):
    """(B * beam, L, V) logits of the decoder step fed the hypotheses tokens
    (B, L), each row's repeated beam times, one token at a time after the
    builder's seed, EOS or the transducer's blank (no search): the scores
    the search saw along its best hypotheses, at the decode's own
    N = B * beam rows."""
    import torch
    from simulst_tpu_torch.decode.beam import BeamConfig
    step_fn, state, _, seed = build(model, batch, BeamConfig(
        beam_size=beam, max_len=tokens.shape[1]))
    tokens = tokens.repeat_interleave(beam, dim=0)
    prev = torch.full_like(tokens[:, 0], 2 if seed is None else seed)
    out = []
    for t in range(tokens.shape[1]):
        logits, state = step_fn(state, prev)
        out.append(logits.float())
        prev = tokens[:, t]
    return torch.stack(out, dim=1)


def phase_offline_decode(dev, workdir, checkpoints, speech, mt_src):
    """cli/generate's offline decoding of phase 10's MMA and phase 13's
    CIF on phase 3's batch and of phase 6's MT teacher on its sources,
    beam 5: launches counted per decode, ms per batch, the best hypotheses
    rescored through the plain versions; then cli/generate.main on a
    synthetic manifest.  Returns the decodes' launches."""
    import torch
    from simulst_tpu_torch.cli import generate
    from simulst_tpu_torch.data import manifest as mf
    from simulst_tpu_torch.data.synthetic import mustc_like_rows
    from simulst_tpu_torch.decode.beam import BeamConfig

    beam_cfg = BeamConfig(beam_size=BEAM, max_len=MAX_LEN)
    runs = {"mma": (generate._build_mma, generate.decode_batch, speech),
            "cif": (generate._build_cif, generate.decode_batch, speech),
            "mt": (generate._build_mt, generate.decode_batch_mt,
                   {"src_tokens": mt_src})}
    launches = {}
    for kind, (build, decode, batch) in runs.items():
        model = generate.load_model(checkpoints[kind], ASR_VOCAB if
                                    kind != "mt" else 8000, device=dev)
        n = len(next(iter(batch.values())))
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens, lengths = decode(model, batch, beam_cfg)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        launched = read_launches()
        missing = [k for k in OFFLINE_DECODE_KERNELS[kind]
                   if not launched[k]]
        if missing:
            raise AssertionError(f"{kind}: {missing} did not launch in the "
                                 f"offline decode: {launched}")
        launches = {k: launches.get(k, 0) + v for k, v in launched.items()}
        if tokens.shape != (n, MAX_LEN) or not (
                (lengths >= 1) & (lengths <= MAX_LEN)).all():
            raise AssertionError(f"{kind}: decode output "
                                 f"{tuple(tokens.shape)}, lengths "
                                 f"{lengths.tolist()}")
        t0 = time.perf_counter()
        decode(model, batch, beam_cfg)
        torch.cuda.synchronize()
        steady_ms = (time.perf_counter() - t0) * 1e3
        got = hypothesis_logits(build, model, batch, tokens)
        with plain_training():
            want = hypothesis_logits(build, model, batch, tokens)
        live = (torch.arange(MAX_LEN, device=dev)[None, :]
                < lengths.repeat_interleave(BEAM)[:, None])
        err = max_err(f"{kind} offline decode logits along the best "
                      "hypotheses, kernels vs plain", got[live], want[live],
                      **F32_TOL)
        log("phase16", model=kind, batch=n, beam=BEAM, max_len=MAX_LEN,
            first_ms_per_batch=first_ms, steady_ms_per_batch=steady_ms,
            token_lengths=lengths.tolist(), launches=launched,
            logits_max_abs_err=err)
        del model

    # cli/generate main: phase 13's CIF checkpoint on a synthetic manifest
    root = os.path.join(workdir, "generate")
    os.makedirs(root)
    rows = mustc_like_rows(N_UTT, seed=SEED, tmpdir=root,
                           feat_dim=80)
    rng = np.random.RandomState(SEED + 23)
    specs = mf.create_feature_zip(
        {r["id"]: rng.randn(int(r["n_frames"]), 80).astype(np.float32)
         for r in rows}, os.path.join(root, "feats.zip"))
    for r in rows:
        r["audio"] = specs[r["id"]]
    mf.save_tsv(rows, os.path.join(root, "tst-COMMON_st.tsv"))
    with open(os.path.join(root, "spm_serve.txt"), "w") as f:
        f.writelines(f"{w} 1\n" for w in serve_vocab().symbols[4:])
    out = os.path.join(root, "generate.txt")
    t0 = time.perf_counter()
    score = generate.main(["--data", root, "--checkpoint", checkpoints["cif"],
                           "--task", "asr", "--scoring", "wer", "--beam",
                           str(BEAM), "--max-len", str(MAX_LEN), "--output",
                           out])
    with open(out) as f:
        lines = f.read().splitlines()
    if sum(line.startswith("D-") for line in lines) != N_UTT or \
            not lines[-1].startswith("SCORE\twer\t") or \
            not np.isfinite(score):
        raise AssertionError(f"cli/generate main wrote {lines[-3:]}")
    print(f"phase16 generate: {lines[-1]}", flush=True)
    log("phase16", generate_main="cif --task asr --scoring wer",
        utterances=N_UTT, frames=[int(r["n_frames"]) for r in rows],
        wer=score, s=time.perf_counter() - t0)
    return launches


def serve_vocab():
    """A dictionary of ASR_VOCAB ids, each piece a word of its own, so that
    every token is committed (and timed) as it is written."""
    from simulst_tpu_torch.data.vocab import SPECIALS, Vocabulary
    return Vocabulary(SPECIALS + [f"\u2581w{i}"
                                  for i in range(ASR_VOCAB - len(SPECIALS))])


def phase_serve(dev, workdir, checkpoints):
    """The streaming evaluator over SERVE_UTT synthetic 1024-frame
    utterances with fused CIF and MMA agents built from the checkpoints of
    phases 13 and 10 (the main path: launches counted), then with their
    step-wise sessions: tokens equal, session by session.  Each agent runs
    as trained and with EOS's embedding row shrunk 10x, so that the briefly
    trained models write more than EOS: many WRITEs, READs and rollbacks.
    Returns the main path's launches."""
    import torch
    from simulst_tpu_torch.ops.fbank import fbank_batch
    from simulst_tpu_torch.stream.build import build_agent
    from simulst_tpu_torch.stream.evaluator import evaluate

    rng = np.random.RandomState(SEED + 7)
    wavs = np.clip(np.round(synthetic_audio(rng, SERVE_UTT, ASR_FRAMES)),
                   -32768, 32767).astype(np.int16)
    with torch.no_grad():
        feats = fbank_batch(torch.from_numpy(wavs.astype(np.float32)))
    gcmvn = os.path.join(workdir, "gcmvn.npz")
    np.savez(gcmvn, mean=feats.mean(dim=(0, 1)).numpy(),
             std=feats.std(dim=(0, 1)).numpy())
    vocab = serve_vocab()
    refs = [" ".join(f"w{k}" for k in range(i, i + 12))
            for i in range(SERVE_UTT)]

    def serve(kind, fused, eos_scale):
        agent = build_agent(checkpoints[kind], vocab, agent_type=kind,
                            global_cmvn_path=gcmvn, fused=fused, device=dev)
        with torch.no_grad():
            agent.model.decoder.embed_tokens.weight[agent.cfg.eos_idx] *= \
                eos_scale
        sessions, chunk_ms = [], []
        make = agent.new_session

        def new_session():
            session = make()
            sessions.append(session)
            if fused:
                step = session.process_chunk

                def timed(samples, finished):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = step(samples, finished)
                    torch.cuda.synchronize()
                    chunk_ms.append((time.perf_counter() - t0) * 1e3)
                    return out
                session.process_chunk = timed
            return session

        agent.new_session = new_session
        scores = evaluate(agent, list(wavs), refs)
        tokens = [s.state.tokens[0, :int(s.state.n_tokens[0])].tolist()
                  if fused else s.target_ids for s in sessions]
        return scores, tokens, chunk_ms

    runs = [(kind, eos_scale) for kind in ("cif", "mma")
            for eos_scale in (1.0, 0.1)]
    reset_launches()
    fused = {run: serve(*run[:1], True, run[1]) for run in runs}
    launches = read_launches()
    missing = [k for k in CIF_SERVE_KERNELS if not launches[k]]
    if missing:
        raise AssertionError(f"{missing} did not launch in the serving "
                             f"path: {launches}")
    for (kind, eos_scale), (scores, tokens, chunk_ms) in fused.items():
        _, want, _ = serve(kind, False, eos_scale)
        if tokens != want:
            raise AssertionError(f"{kind}: fused session tokens {tokens} "
                                 f"differ from the step-wise sessions' "
                                 f"{want}")
        if not all(np.isfinite(scores[k]) for k in ("AL", "AP", "DAL")):
            raise AssertionError(f"{kind}: scores {scores}")
        log("phase14", agent=kind, eos_row_scale=eos_scale,
            utterances=SERVE_UTT, frames=ASR_FRAMES,
            chunks=len(chunk_ms), median_ms_per_chunk=statistics.median(
                chunk_ms), mean_ms_per_chunk=statistics.mean(chunk_ms),
            max_chunk_ms=max(chunk_ms), tokens=[len(t) for t in tokens],
            fused_equals_stepwise=True,
            **{k: scores[k] for k in ("BLEU", "AL", "AP", "DAL", "AL_CA",
                                      "truncated")})
    log("phase14", launches=launches,
        cif_launches_per_chunk=launches["cif_integrate"]
        / sum(len(fused[run][2]) for run in runs if run[0] == "cif"))
    return launches


# the batched-serve traffic: 64 utterances of one 16-chunk bucket (975 ms,
# then 640 ms chunks: 158,961-169,200 samples, 9.94-10.58 s), one of them
# with no new fbank frame in its final chunk, and 8 of one 7-chunk bucket
# (66,801-77,040 samples, 4.18-4.82 s)
BATCH_LONG, BATCH_SHORT = 64, 8
BATCH_LONG_SAMPLES = (158961, 169200)
BATCH_ZERO_FRAME_SAMPLES = 159000        # num_frames == that of 158,960
BATCH_SHORT_SAMPLES = (66801, 77040)
BATCH_B1_SUBSET = 12          # 4 of the long bucket and the 8 short
BATCH_B1_EXTRA = 2            # long-bucket rows outside it, seeded
# CIF, and a test-time wait-k agent on phase 10's MMA weights (its learned
# heads write nothing before the source ends), EOS's row scaled.  That
# briefly trained decoder settles EOS at its first decision: at 0.86 about
# half of the utterances write from the second chunk on (and fill their
# tokens), while the others READ on a rejected early EOS, so the lock-step
# batch diverges, and end on EOS
BATCH_WAITK = 3
BATCH_EOS_SCALE = {"cif": 0.1, "waitk": 0.86}
BATCH_MAX_TGT = {"cif": 256, "waitk": 64}
TIE_GAP = 1e-4


def batched_serve_audio(rng):
    """The 72 utterances (int16) of the batched-serve phase, seeded tones +
    noise: the long bucket's lengths spread evenly over its range (so that
    every final chunk differs), the first one at the zero-frame length."""
    lengths = np.linspace(*BATCH_LONG_SAMPLES, BATCH_LONG).astype(int)
    lengths[0] = BATCH_ZERO_FRAME_SAMPLES
    lengths = list(lengths) + list(np.linspace(
        *BATCH_SHORT_SAMPLES, BATCH_SHORT).astype(int))
    t = np.arange(max(lengths)) / 16000.0
    wavs = []
    for n in lengths:
        freqs = rng.uniform(100.0, 3000.0, size=3)
        amps = rng.uniform(0.05, 0.3, size=3)
        wav = sum(a * np.sin(2 * np.pi * f * t[:n])
                  for a, f in zip(amps, freqs)) + 0.05 * rng.randn(n)
        wavs.append(np.clip(np.round(wav * 2 ** 15), -32768,
                            32767).astype(np.int16))
    return wavs


def batch_groups(agent, wavs, batch_size):
    """evaluate_batched's groups: (chunk count, utterance indices) per
    batch, buckets by chunk count in ascending order."""
    from simulst_tpu_torch.stream.agents import chunk_count
    n_first, n_steady = chunk_geometry(agent)
    buckets = defaultdict(list)
    for i, w in enumerate(wavs):
        buckets[chunk_count(len(w), n_first, n_steady)].append(i)
    return [(k, idxs[lo:lo + batch_size]) for k, idxs in
            sorted(buckets.items()) for lo in range(0, len(idxs), batch_size)]


def served_tokens(sessions, groups):
    """utterance index -> tokens written, from the batched sessions of
    evaluate_batched in the order they were made."""
    out = {}
    for session, (_, group) in zip(sessions, groups):
        toks = session.state.tokens.cpu().numpy()
        n = session.state.n_tokens.cpu().numpy()
        for row, i in enumerate(group):
            out[i] = toks[row, :n[row]].tolist()
    return out


def frame_margin(cfg, lattice, args, kwargs, out):
    """The smallest |blank - best non-blank| logit margin over the frames
    that decided a transducer decode_step call (args, kwargs -> out) whose
    joiner gave `lattice` (S, V): from prev_emit to the chosen frame, or
    to the last visible frame where the call READ, less the last visible
    frame where the offline step forces an emit there.  inf where no frame
    decided."""
    import torch
    from simulst_tpu_torch.models import transducer as tr_mod
    state, src_buf, src_len = args[2], args[4], args[5]
    online = args[6] if len(args) > 6 else kwargs.get("online", False)
    n = int(tr_mod.downsample_pool(src_buf, src_len, cfg.downsample)[1][0])
    lo = int(state.prev_emit[0])
    hi = int(out[2].prev_emit[0]) if bool(out[1][0]) else n - 1
    if not online:
        hi = min(hi, n - 2)
    rows = lattice[lo:hi + 1].float()
    if not len(rows):
        return float("inf")
    blank = rows[:, cfg.blank_idx].clone()
    rows[:, cfg.blank_idx] = float("-inf")
    return float((rows.max(dim=-1).values - blank).abs().min())


def b1_gap(agent, kind, wav, index):
    """The top-two logit gap of the B = 1 session's decoder call that
    decided its token `index`, replayed: the last call with step == index
    that chose the token written there (the accepted one); for EOS the
    largest gap of its calls there that chose EOS (a rejected early EOS
    may be the deciding one).  None where the session wrote no token
    `index`.  For the transducer, whose calls also decide at which frame
    to emit, the smaller of that gap and the blank's margin at every frame
    that decided a call with step <= index (`frame_margin`; READ calls'
    frames too: equal tokens emitted at other frames part the sessions
    later, and the margin is defined where no token `index` was
    written)."""
    import torch
    from simulst_tpu_torch.models import cif as cif_mod
    from simulst_tpu_torch.models import mma as mma_mod
    from simulst_tpu_torch.stream.evaluator import run_session
    from simulst_tpu_torch.models import transducer as tr_mod
    mod, name = {"cif": (cif_mod, "cif_decoder_step"),
                 "transducer": (tr_mod, "decode_step")}.get(
        kind, (mma_mod, "mma_decoder_step"))
    real, calls, lattices = getattr(mod, name), [], []
    real_joiner = tr_mod.joiner_forward

    def joiner(*args, **kwargs):
        out = real_joiner(*args, **kwargs)
        lattices.append(out[0, :, 0])
        return out

    def recorded(*args, **kwargs):
        out = real(*args, **kwargs)
        top = out[0][0].float().topk(2)
        margin = (frame_margin(agent.cfg, lattices.pop(), args, kwargs, out)
                  if kind == "transducer" else float("inf"))
        calls.append((int(args[2].step[0]), int(top.indices[0]),
                      float(top.values[0] - top.values[1]), margin))
        return out

    sessions = []
    make = agent.new_session

    def new_session():
        sessions.append(make())
        return sessions[-1]

    patches = [(mod, name, recorded)]
    if kind == "transducer":
        patches.append((tr_mod, "joiner_forward", joiner))
    agent.new_session = new_session
    try:
        with patched(patches), torch.no_grad():
            run_session(agent, wav)
    finally:
        agent.new_session = make
    state = sessions[0].state
    tokens = state.tokens[0, :int(state.n_tokens[0])].tolist()
    margin = min((m for step, _, _, m in calls if step <= index),
                 default=float("inf"))
    chose = tokens[index] if index < len(tokens) else None
    gaps = [g for step, tok, g, _ in calls if step == index and tok == chose]
    if not gaps:
        return (margin if margin < float("inf") else None), tokens
    gap = max(gaps) if chose == agent.cfg.eos_idx else gaps[-1]
    return min(gap, margin), tokens


def phase_batched_serve(dev, workdir, checkpoints):
    """The batched streaming evaluator (stream/evaluator.evaluate_batched,
    as cli/stream_eval --fused --batch-size / --scan-sessions runs it) with
    a fused CIF agent from phase 13's checkpoint and a fused test-time
    wait-k agent from phase 10's MMA checkpoint (EOS's row scaled by
    BATCH_EOS_SCALE): B = 1 `evaluate` over a fixed subset, B 8 step-wise
    over that subset, B 64 scanned over all 72 utterances and its step-wise
    _CA pass.  Each agent must write before the source ends (AP < 1), end
    some utterances on EOS and diverge mid-stream within a B 64 chunk.
    Tokens of every batched run equal the B = 1 tokens (the subset and
    BATCH_B1_EXTRA replayed rows), but for proven argmax ties (the B = 1
    top-two gap at the first differing token under TIE_GAP); the B 64
    encoder with feat_valid equals each example's offline encoder alone;
    the serving kernels at the batched shapes vs their plain versions; ms
    per chunk, utterances per second and the device's busy share of one
    profiled B 64 chunk.  Returns the main path's launches."""
    import torch
    from simulst_tpu_torch.models import s2t_emformer as s2t
    from simulst_tpu_torch.ops import cif_integrate as ci
    from simulst_tpu_torch.ops import ffn
    from simulst_tpu_torch.ops.fbank import fbank_batch
    from simulst_tpu_torch.stream import agents as agents_mod
    from simulst_tpu_torch.stream.build import build_agent
    from simulst_tpu_torch.stream.evaluator import (evaluate,
                                                    evaluate_batched,
                                                    merge_honest_ca)

    t_phase = time.perf_counter()
    wavs = batched_serve_audio(np.random.RandomState(SEED + 15))
    long_idx = list(range(BATCH_LONG))
    with torch.no_grad():
        feats = torch.cat([fbank_batch(torch.from_numpy(
            w.astype(np.float32)).to(dev)[None])[0] for w in wavs])
    gcmvn = os.path.join(workdir, "gcmvn_batched.npz")
    np.savez(gcmvn, mean=feats.mean(dim=0).cpu().numpy(),
             std=feats.std(dim=0).cpu().numpy())
    del feats
    vocab = serve_vocab()
    refs = [" ".join(f"w{k}" for k in range(i, i + 12))
            for i in range(len(wavs))]
    final_samples = [len(w) - 15600 - 14 * 10240 for w in wavs[:BATCH_LONG]]
    # B = 1 subset: the shortest and longest final chunks of the long
    # bucket, evenly spaced others, and the whole short bucket
    subset = sorted(set(np.linspace(
        0, BATCH_LONG - 1, BATCH_B1_SUBSET - BATCH_SHORT).round().astype(
            int).tolist())) + list(range(BATCH_LONG,
                                         BATCH_LONG + BATCH_SHORT))

    def build(kind):
        waitk = {}
        if kind == "waitk":
            waitk = dict(waitk=BATCH_WAITK, overrides={
                "simul_attn_type": "waitk_fixed_pre_decision"})
        agent = build_agent(
            checkpoints["mma" if kind == "waitk" else kind], vocab,
            agent_type=kind, global_cmvn_path=gcmvn, fused=True, device=dev,
            max_src_frames=1024, max_tgt_len=BATCH_MAX_TGT[kind], **waitk)
        with torch.no_grad():
            agent.model.decoder.embed_tokens.weight[agent.cfg.eos_idx] *= \
                BATCH_EOS_SCALE[kind]
        return agent

    def timed_batched(agent, chunk_ms, diverged=None):
        """Record the batched sessions and time each chunk call; count in
        `diverged` the mid-stream chunks whose examples wrote different
        numbers of tokens (some WRITE while others READ)."""
        sessions = []
        make = agent.new_batched_session

        def new_batched_session(batch):
            session = make(batch)
            sessions.append(session)
            step = session.process_chunk_batch

            def timed(chunks, finished):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(chunks, finished)
                torch.cuda.synchronize()
                chunk_ms.append((time.perf_counter() - t0) * 1e3)
                if diverged is not None and not finished:
                    diverged.append(len({len(t) for t in out}) > 1)
                return out
            session.process_chunk_batch = timed
            return session

        agent.new_batched_session = new_batched_session
        return sessions

    results, runs_log = {}, {}
    reset_launches()
    for kind in ("cif", "waitk"):
        agent = build(kind)
        r = results[kind] = {}
        # B = 1 over the subset
        b1_sessions, b1_ms = [], []
        make = agent.new_session

        def new_session():
            session = make()
            b1_sessions.append(session)
            step = session.process_chunk

            def timed(samples, finished):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(samples, finished)
                torch.cuda.synchronize()
                b1_ms.append((time.perf_counter() - t0) * 1e3)
                return out
            session.process_chunk = timed
            return session

        agent.new_session = new_session
        before = read_launches()
        t0 = time.perf_counter()
        evaluate(agent, [wavs[i] for i in subset], [refs[i] for i in subset])
        r["b1"] = dict(wall_s=time.perf_counter() - t0, chunk_ms=b1_ms,
                       utterances=len(subset),
                       launches=launch_delta(before))
        agent.new_session = make
        b1_tokens = {}
        for i, session in zip(subset, b1_sessions):
            st = session.state
            b1_tokens[i] = st.tokens[0, :int(st.n_tokens[0])].tolist()
        r["b1_tokens"] = b1_tokens

        # B 8 step-wise over the subset
        sub_wavs = [wavs[i] for i in subset]
        b8_ms = []
        sessions = timed_batched(agent, b8_ms)
        before = read_launches()
        t0 = time.perf_counter()
        evaluate_batched(agent, sub_wavs, [refs[i] for i in subset],
                         batch_size=8)
        r["b8"] = dict(wall_s=time.perf_counter() - t0, chunk_ms=b8_ms,
                       utterances=len(subset), launches=launch_delta(before))
        groups = [(k, [subset[j] for j in g])
                  for k, g in batch_groups(agent, sub_wavs, 8)]
        r["b8_tokens"] = served_tokens(sessions, groups)
        del agent.new_batched_session

        # B 64 scanned over all 72, then its step-wise _CA pass (as
        # cli/stream_eval --batch-size 64 --scan-sessions runs them)
        sessions = []
        make_b = agent.new_batched_session

        def record(batch):
            sessions.append(make_b(batch))
            return sessions[-1]

        agent.new_batched_session = record
        before = read_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scan_scores = evaluate_batched(agent, wavs, refs, batch_size=64,
                                       scan=True)
        torch.cuda.synchronize()
        groups = batch_groups(agent, wavs, 64)
        r["b64_scan"] = dict(wall_s=time.perf_counter() - t0,
                             chunk_calls=sum(k for k, _ in groups),
                             utterances=len(wavs),
                             launches=launch_delta(before))
        r["b64_scan_tokens"] = served_tokens(sessions, groups)
        del agent.new_batched_session
        b64_ms, diverged = [], []
        sessions = timed_batched(agent, b64_ms, diverged)
        before = read_launches()
        t0 = time.perf_counter()
        ca_scores = evaluate_batched(agent, wavs, refs, batch_size=64)
        r["b64"] = dict(wall_s=time.perf_counter() - t0, chunk_ms=b64_ms,
                        utterances=len(wavs), launches=launch_delta(before))
        r["b64_tokens"] = served_tokens(sessions, groups)
        del agent.new_batched_session
        scores = merge_honest_ca(scan_scores, ca_scores)
        if not all(np.isfinite(scores[k]) for k in ("AL", "AP", "DAL",
                                                    "AL_CA")):
            raise AssertionError(f"{kind}: scores {scores}")
        # the traffic must stream: writes before the source ends, examples
        # that diverge mid-stream, and utterances that end on EOS
        # (diverging writes are writes before the source ends)
        if not (scores["AP"] < 1 and scores["truncated"] < len(wavs)
                and any(diverged)):
            raise AssertionError(
                f"{kind}: degenerate traffic (AP {scores['AP']}, "
                f"{scores['truncated']} of {len(wavs)} truncated, "
                f"{sum(diverged)} of {len(diverged)} mid-stream B 64 chunks "
                "with diverging writes)")
        r["diverged_chunks"] = [sum(diverged), len(diverged)]
        r["scores"] = scores
        r["agent"] = agent
    launches = read_launches()
    missing = [k for k in CIF_SERVE_KERNELS if not launches[k]]
    if missing:
        raise AssertionError(f"{missing} did not launch in the batched "
                             f"serving path: {launches}")
    main_s = time.perf_counter() - t_phase

    # tokens: every batched run vs B = 1, ties proven on the B = 1 state;
    # B = 1 replays of a seeded sample of the long-bucket rows outside the
    # subset join it
    extra = sorted(np.random.RandomState(SEED + 17).choice(
        [i for i in long_idx if i not in subset], BATCH_B1_EXTRA,
        replace=False).tolist())
    for kind, r in results.items():
        for i in extra:
            r["b1_tokens"][i] = b1_gap(r["agent"], kind, wavs[i], 0)[1]
        flips, compared = [], 0
        for run in ("b8_tokens", "b64_scan_tokens", "b64_tokens"):
            for i, got in sorted(r[run].items()):
                want = r["b1_tokens"].get(i)
                if want is None:
                    # outside the B = 1 subset: B 64 scanned vs step-wise,
                    # and a B = 1 replay where they differ
                    other = r["b64_tokens" if run == "b64_scan_tokens"
                              else "b64_scan_tokens"][i]
                    if got == other:
                        continue
                    want = r["b1_tokens"][i] = b1_gap(r["agent"], kind,
                                                      wavs[i], 0)[1]
                compared += 1
                if got == want:
                    continue
                j = next((k for k, (a, b) in enumerate(zip(got, want))
                          if a != b), min(len(got), len(want)))
                gap, replay = b1_gap(r["agent"], kind, wavs[i], j)
                if replay != want:
                    raise AssertionError(f"{kind} utt {i}: the B = 1 replay "
                                         "differs from the B = 1 run")
                if gap is None or not gap < TIE_GAP:
                    raise AssertionError(
                        f"{kind} {run} utt {i}: tokens differ from B = 1 at "
                        f"{j} ({got[j:j + 3]} vs {want[j:j + 3]}), top-two "
                        f"gap {gap} not under {TIE_GAP}")
                flips.append(dict(run=run, utt=i, index=j, gap=gap))
        lens = [len(t) for t in r["b64_tokens"].values()]
        log("phase15", agent=kind, compared_with_b1=compared,
            tie_flips=len(flips), flips=flips,
            tokens_b64_min_mean_max=[min(lens), statistics.mean(lens),
                                     max(lens)],
            b1_subset=subset, b1_replayed=extra,
            b64_diverged_midstream_chunks=r["diverged_chunks"],
            long_bucket_final_samples_min_max=[
                min(final_samples), max(final_samples)],
            **{k: r["scores"][k] for k in ("mode", "BLEU", "AL", "AP",
                                           "DAL", "AL_CA", "truncated")})

    # the B 64 encoder with feat_valid vs each example's offline encoder
    agent = results["cif"]["agent"]
    model, cfg = agent.model, agent.cfg
    long_wavs = [wavs[i] for i in long_idx]
    staged = agents_mod.stage_session_wavs(agent, long_wavs)
    n_first, n_steady, n_chunks, sched = agents_mod._session_schedule(
        cfg, long_wavs)
    from simulst_tpu_torch.ops.fbank import num_frames
    c0 = num_frames(n_first)
    cs = num_frames(n_first + n_steady) - c0
    mx = num_frames(sched) - num_frames(n_first + (n_chunks - 2) * n_steady)
    first, mid, last = agents_mod.featurize(
        staged.wav_mat, agent.global_cmvn, c0, cs, n_chunks - 2, mx)
    n_valid = staged.n_valid
    if n_valid is None or int(n_valid.min()) != 0:
        raise AssertionError(f"the long bucket's final counts {n_valid}: "
                             "want ragged, with a zero")
    with torch.no_grad():
        state = s2t.encoder_init_state(model.encoder, cfg, BATCH_LONG,
                                       device=dev)
        outs = []
        for k, x in enumerate([first] + list(mid) + [last]):
            finish = k == n_chunks - 1
            out, state = s2t.encoder_step(model.encoder, cfg, state, x,
                                          finish, n_valid if finish else None)
            outs.append((out.encoder_out, out.lengths))
        enc_err = 0.0
        for i in range(BATCH_LONG):
            mine = torch.cat([o[i, :int(n[i])] for o, n in outs])
            own = torch.cat([first[i], mid[:, i].reshape(-1, first.shape[-1]),
                             last[i, :int(n_valid[i])]])[None]
            alone = s2t.encoder_forward(
                model.encoder, cfg, own,
                torch.tensor([own.shape[1]], device=dev)).encoder_out[0]
            enc_err = max(enc_err, max_err(
                f"batched encoder utt {i}", mine, alone, atol=1e-4, rtol=0))

    # the serving kernels at the batched shapes vs their plain versions
    g = torch.Generator().manual_seed(SEED + 16)

    def randn(*shape):
        return torch.randn(shape, generator=g).to(dev)

    layer = model.encoder.emformer.layers[0].pos_ff
    ln_w = (layer.ln.scale, layer.ln.bias, layer.fc1.weight, layer.fc1.bias,
            layer.fc2.weight, layer.fc2.bias)
    act = cfg.emformer.activation
    dec = model.decoder.layers[0]
    ffn_w = (dec.fc1.weight, dec.fc1.bias, dec.fc2.weight, dec.fc2.bias)
    seg, rc = cfg.emformer.segment, cfg.emformer.right_context
    kernel_report = {}
    with torch.no_grad():
        for b in (8, 64):
            x = randn(b, rc + seg, cfg.embed_dim)
            case = f"fused_ln_ffn_res rows={b * (rc + seg)}"
            err = max_err(case, ffn.fused_ln_ffn_res(x, *ln_w, act),
                          ffn.ln_ffn_res_plain(x, *ln_w, act), **F32_TOL)
            kernel_report[case] = dict(
                max_abs_err=err, tiled=b * (rc + seg) >= ffn.TILED_MIN_ROWS,
                ms=cuda_ms(lambda: ffn.fused_ln_ffn_res(x, *ln_w, act)),
                plain_ms=cuda_ms(lambda: ffn.ln_ffn_res_plain(x, *ln_w,
                                                              act)),
                products_matmul_ms=matmul_yardstick(
                    x.reshape(-1, cfg.embed_dim), ln_w[2], ln_w[4]),
                **dict(zip(("bound_ms", "bound_by"), bound(
                    nbytes(x, x, *ln_w),
                    4 * b * (rc + seg) * cfg.embed_dim * ln_w[2].shape[1]))))
            x = randn(b, 1, cfg.embed_dim)
            case = f"fused_ffn rows={b}"
            dact = cfg.decoder.activation
            err = max_err(case, ffn.fused_ffn(x, *ffn_w, dact),
                          ffn.ffn_plain(x, *ffn_w, dact), **F32_TOL)
            kernel_report[case] = dict(
                max_abs_err=err,
                ms=cuda_ms(lambda: ffn.fused_ffn(x, *ffn_w, dact)),
                plain_ms=cuda_ms(lambda: ffn.ffn_plain(x, *ffn_w, dact)),
                products_matmul_ms=matmul_yardstick(
                    x.reshape(-1, cfg.embed_dim), ffn_w[0], ffn_w[2]),
                **dict(zip(("bound_ms", "bound_by"), bound(
                    nbytes(x, x, *ffn_w),
                    4 * b * cfg.embed_dim * ffn_w[0].shape[1]))))
        # cif_integrate at the B 64 steady chunk (the carried tail + 16
        # frames) and the flush (tail + up to rc + seg frames), the flush's
        # frames past each example's x_valid at zero weight
        for label, s_len, ragged in (("chunk", seg + 1, False),
                                     ("flush", rc + seg + 1, True)):
            x, alpha = cif_inputs(dev, 64, s_len, cfg.embed_dim, s_len + 2,
                                  cfg.cif_beta, 0.45)
            if ragged:
                keep = torch.arange(64, device=dev) % s_len
                alpha = torch.where(torch.arange(s_len, device=dev)[None, :]
                                    <= keep[:, None], alpha,
                                    torch.zeros_like(alpha))
            t = s_len + 2
            out, delays = ci.cif_integrate(x, alpha, cfg.cif_beta, t)
            want = ci.cif_integrate_plain(x, alpha, cfg.cif_beta, t)
            err = max(max_err_to_largest(f"cif_integrate B 64 {label} {w}",
                                         got, ref, rtol=1e-5)
                      for w, got, ref in zip(("out", "delays"),
                                             (out, delays), want))
            nnz = int((ci.portions(*ci.cumsums(alpha), cfg.cif_beta, t)
                       > 0).sum())
            kernel_report[f"cif_integrate (64,{s_len},256,{t}) {label}"] = \
                dict(max_abs_err=err, nonzero_portions=nnz,
                     ms=cuda_ms(lambda: ci.cif_integrate(
                         x, alpha, cfg.cif_beta, t)),
                     plain_ms=cuda_ms(lambda: ci.cif_integrate_plain(
                         x, alpha, cfg.cif_beta, t)),
                     **dict(zip(("bound_ms", "bound_by"), bound(
                         nbytes(x, alpha, out, delays),
                         2 * nnz * (cfg.embed_dim + 1)))))
    for case, entry in kernel_report.items():
        log("phase15", kernel=case, **entry)

    # one B 64 steady chunk under torch.profiler
    session = agent.new_batched_session(BATCH_LONG)
    first_n = int(chunk_geometry(agent)[0])
    steady_n = int(chunk_geometry(agent)[1])
    session.process_chunk_batch([w[:first_n] for w in long_wavs], False)
    chunk = [w[first_n:first_n + steady_n] for w in long_wavs]
    wall_ms, device_ms, n_kernels = profile_chunk(session, chunk)

    gpu = gpu_name_and_power_limit()
    for kind, r in results.items():
        line = {"agent": kind, "gpu": gpu}
        for run in ("b1", "b8", "b64", "b64_scan"):
            x = r[run]
            calls = (len(x["chunk_ms"]) if "chunk_ms" in x
                     else x["chunk_calls"])
            line[run] = dict(
                utterances=x["utterances"], chunk_calls=calls,
                utterances_per_s=x["utterances"] / x["wall_s"],
                wall_s=x["wall_s"],
                launches_per_chunk={k: x["launches"][k] / calls
                                    for k in CIF_SERVE_KERNELS})
            if "chunk_ms" in x:
                line[run].update(
                    median_ms_per_chunk=statistics.median(x["chunk_ms"]),
                    mean_ms_per_chunk=statistics.mean(x["chunk_ms"]))
            else:
                line[run]["mean_ms_per_chunk"] = x["wall_s"] * 1e3 / calls
        log("phase15", **line)
    log("phase15", launches=launches, main_path_s=main_s,
        encoder_feat_valid_vs_alone_max_abs_err=enc_err,
        long_bucket_final_frames=n_valid.tolist(),
        profiled_b64_chunk=dict(wall_ms=wall_ms, device_ms=device_ms,
                                device_busy_share=device_ms / wall_ms,
                                kernels=n_kernels),
        gpu=gpu, phase_s=time.perf_counter() - t_phase)
    return launches


# ---------------------------------------------------------------------------
# phase 18: the Transformer-Transducer (exp/6_transducer.sh)
# ---------------------------------------------------------------------------

# exp/6's --max-tokens 20000 takes 16 utterances of the 1024-frame bucket
TRANSDUCER_UTT, TRANSDUCER_STEPS = 16, 8
TRANSDUCER_ARGS = ["--task", "st", "--model", "transducer", "--loss", "rnnt",
                   "--loss-override", "fastemit_lambda=0.01",
                   "--loss-override", "offline_factor=1.0",
                   "--lr", "5e-4", "--warmup-updates", "4000",
                   "--clip-norm", "10", "--seed", str(SEED)]
# launches per transducer training step: the encoder's as in MMA training
# (no CTC head); 6 label-encoder layers, each one causal self-attention
# core, its out-projection epilogue and one FFN
TRANSDUCER_LAUNCHES_PER_STEP = {
    "fused_ln_ffn_res": 12, "fused_ln_ffn_res_backward": 12,
    "emformer_grouped_attention": 12,
    "emformer_grouped_attention_backward": 12,
    "emformer_grouped_attention_gated": 0,
    "emformer_grouped_attention_gated_backward": 0,
    "fused_linear_res": 18, "fused_linear_res_backward": 18,
    "fused_mha": 6, "fused_mha_backward": 6,
    "fused_ffn": 6, "fused_ffn_backward": 6,
    "convpos_wgrad": 1, "ctc_alphas": 0, "ctc_d_em": 0,
    "alignment_fwd": 0, "alignment_bwd": 0, "cif_integrate": 0}
# the offline decode: the encoder's forward kernels, the label step's FFN
TRANSDUCER_DECODE_KERNELS = ("fused_ln_ffn_res", "emformer_grouped_attention",
                             "fused_linear_res", "fused_ffn")
TRANSDUCER_STREAM_KERNELS = ("fused_ln_ffn_res", "fused_ffn")
# the search for the blank's and EOS's test-time scales
# (transducer_test_time_scales): eight steps do not train the blank's
# probability into place
TRANSDUCER_SCALE_DOUBLINGS, TRANSDUCER_SCALE_BISECTIONS = 6, 5
TRANSDUCER_STREAM_MAX_TGT = 64
# the transducer step's own kernels in its profile, before the shared
# families: the lattice's log-softmax (and the offline CE column's), the
# RNN-T diagonal loop's logaddexp, the joiner's tanh
TRANSDUCER_FAMILIES = (("SoftMax", "log-softmax (lattice and CE column)"),
                       ("logaddexp", "RNN-T diagonal loop: logaddexp"),
                       ("tanh", "joiner tanh"))
TRANSDUCER_B1_LONG = 8        # long-bucket utterances beside the 8 short


def transducer_audio(rng):
    """The transducer's streaming utterances (int16): TRANSDUCER_B1_LONG of
    the long bucket and BATCH_SHORT of the short one (batched-serve's
    lengths, each final chunk its own size), tones under a 1.5 Hz on / off
    envelope over a little noise, so that the encoder's frames differ
    between sound and pause."""
    lengths = list(np.linspace(*BATCH_LONG_SAMPLES, TRANSDUCER_B1_LONG)
                   .astype(int)) + list(np.linspace(
                       *BATCH_SHORT_SAMPLES, BATCH_SHORT).astype(int))
    wavs = []
    for n in lengths:
        t = np.arange(n) / 16000.0
        env = np.sin(2 * np.pi * 1.5 * t + rng.uniform(0, 2 * np.pi)) > 0
        tone = sum(a * np.sin(2 * np.pi * f * t) for a, f in
                   zip(rng.uniform(0.05, 0.3, 3), rng.uniform(100, 3000, 3)))
        wav = env * tone + 0.01 * rng.randn(n)
        wavs.append(np.clip(np.round(wav * 2 ** 15), -32768,
                            32767).astype(np.int16))
    return wavs


def phase_transducer_kernels(dev):
    """Rows 5 / 5b and 2 / 2b at the transducer's label-encoder shapes vs
    their plain versions: the causal self-attention on the train batch's
    (16, 73, 73) labels, its FFN on their 1,168 rows (gelu, rate 0.1),
    and the decode step's FFN on B x beam 40 and B 8 rows; CUDA-event
    times beside SDPA / the products through torch.matmul, with bounds."""
    import torch
    from simulst_tpu_torch.ops import ffn, mha
    g = torch.Generator().manual_seed(SEED + 18)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    b, t, d, hid, heads = TRANSDUCER_UTT, ASR_TOKEN_BUCKET + 1, 256, 2048, 4
    lengths = torch.randint(ASR_MIN_TOKENS + 2, t + 1, (b,), generator=g)
    kmask = (torch.arange(t)[None, :] < lengths[:, None]).to(
        torch.int32).to(dev)
    q, k, v, dout = (randn(b, t, d) for _ in range(4))
    cfg = (heads, True, 0.1, 4321)
    out, lse = mha.fused_mha_forward(q, k, v, kmask, *cfg)
    e_fwd = max_err("fused_mha label encoder", out,
                    mha.mha_plain(q, k, v, kmask, *cfg), **F32_TOL)
    got = mha.fused_mha_backward(q, k, v, kmask, out, lse, dout, *cfg)
    want = mha.mha_plain_backward(q, k, v, kmask, dout, *cfg)
    e_bwd = max(max_err(f"fused_mha_backward label encoder {w}", x, y,
                        **F32_TOL) for w, x, y in zip("qkv", got, want))
    vis = mha_visible_pairs(kmask, t, True)
    shape = f"(B,Tq,Tk,D)=({b},{t},{t},{d}) causal rate 0.1"
    log("phase18-kernels", kernel="fused_mha", shape=shape,
        max_abs_err=e_fwd,
        plain_ms=cuda_ms(lambda: mha.mha_plain(q, k, v, kmask, *cfg)),
        **mha_forward_case(q, k, v, kmask, heads, True, 0.1))
    log("phase18-kernels", kernel="fused_mha_backward", shape=shape,
        max_abs_err=e_bwd,
        ms=cuda_ms(lambda: mha.fused_mha_backward(q, k, v, kmask, out, lse,
                                                  dout, *cfg)),
        plain_ms=cuda_ms(lambda: mha.mha_plain_backward(q, k, v, kmask,
                                                        dout, *cfg)),
        library_ms=sdpa_backward_ms(q, k, v, kmask, dout, *cfg[:3]),
        **dict(zip(("bound_ms", "bound_by"), bound(
            nbytes(q, k, v, kmask, out, lse, dout, *got), 10 * d * vis))))

    xav = (6.0 / (d + hid)) ** 0.5
    w1, b1 = randn(d, hid, scale=xav), randn(hid, scale=0.02)
    w2, b2 = randn(hid, d, scale=xav), randn(d, scale=0.02)
    for rows, rate in ((b * t, 0.1), (BEAM * N_UTT, 0.0), (N_UTT, 0.0)):
        x, dy = randn(rows, d), randn(rows, d)
        fcfg = ("gelu", rate, rate, 99)
        y = ffn.fused_ffn_forward(x, w1, b1, w2, b2, *fcfg)
        err = max_err(f"fused_ffn {rows} rows", y,
                      ffn.ffn_plain(x, w1, b1, w2, b2, *fcfg), **F32_TOL)
        flops = 2 * rows * d * hid
        log("phase18-kernels", kernel="fused_ffn",
            shape=f"x=({rows},{d}) gelu rate {rate}", max_abs_err=err,
            ms=cuda_ms(lambda: ffn.fused_ffn_forward(x, w1, b1, w2, b2,
                                                     *fcfg)),
            plain_ms=cuda_ms(lambda: ffn.ffn_plain(x, w1, b1, w2, b2, *fcfg)),
            library_ms=None, products_matmul_ms=matmul_yardstick(x, w1, w2),
            **dict(zip(("bound_ms", "bound_by"), bound(
                nbytes(x, y, w1, b1, w2, b2), 2 * flops))))
        if rows != b * t:
            continue
        got = ffn.fused_ffn_backward(x, w1, b1, w2, dy, *fcfg)
        want = ffn.ffn_plain_backward(x, w1, b1, w2, dy, *fcfg)
        err = max([max_err("fused_ffn_backward label encoder dx", got[0],
                           want[0], **F32_TOL)] +
                  [max_err_to_largest(f"fused_ffn_backward label encoder "
                                      f"{w}", gw, ww)
                   for w, gw, ww in zip(("dw1", "db1", "dw2", "db2"),
                                        got[1:], want[1:])])
        log("phase18-kernels", kernel="fused_ffn_backward",
            shape=f"x=({rows},{d}) gelu rate {rate}", max_abs_err=err,
            ms=cuda_ms(lambda: ffn.fused_ffn_backward(x, w1, b1, w2, dy,
                                                      *fcfg),
                       samples=5, runs=5),
            plain_ms=cuda_ms(lambda: ffn.ffn_plain_backward(
                x, w1, b1, w2, dy, *fcfg), samples=5, runs=5),
            library_ms=None,
            products_matmul_ms=matmul_yardstick(x, w1, w2, dy),
            **dict(zip(("bound_ms", "bound_by"), bound(
                nbytes(x, dy, w1, b1, w2, *got), 5 * flops))))


def lattice_breakdown(model, batch, lcfg):
    """The loss side of one transducer step on this batch, forward and
    backward, in CUDA-event ms by part: the joiner (its products and tanh
    over the (B, S, U+1, V) lattice), the lattice's log-softmax, the RNN-T
    loss on the log-probs (its gathers and the diagonal loop) and the
    whole criterion; and the RNN-T loss's kernel launches (torch.profiler),
    with the lattice's size."""
    import torch
    from simulst_tpu_torch.losses.rnnt_loss import rnnt_criterion
    from simulst_tpu_torch.models import s2t_emformer as s2t
    from simulst_tpu_torch.models import transducer as tr
    from simulst_tpu_torch.ops.rnnt import rnnt_loss
    cfg = model.cfg
    with torch.no_grad():
        lat, extra = model(batch["feats"], batch["feat_lengths"],
                           batch["prev_tokens"])
        enc = s2t.encoder_forward(model.encoder, cfg, batch["feats"],
                                  batch["feat_lengths"])
        tgt = tr.label_features(model.decoder, cfg, extra["label_tokens"])
    src = enc.encoder_out.requires_grad_()
    tgt = tgt.requires_grad_()
    weights = [model.decoder.embed_tokens.weight,
               model.decoder.joiner.source_projection.weight,
               model.decoder.joiner.target_projection.weight]
    dlat = torch.randn(lat.shape, device=lat.device,
                       generator=torch.Generator(device=lat.device)
                       .manual_seed(SEED))

    def joiner():
        with torch.enable_grad():
            out = tr.joiner_forward(model.decoder, src, tgt)
            torch.autograd.grad(out, [src, tgt] + weights, dlat)

    x = lat.detach().requires_grad_()

    def log_softmax():
        with torch.enable_grad():
            torch.autograd.grad(torch.log_softmax(x, dim=-1), x, dlat)

    lp = torch.log_softmax(lat, dim=-1).requires_grad_()
    targets = extra["label_tokens"][:, 1:]
    args = (targets, extra["encoder_lengths"], extra["label_lengths"] - 1, 0,
            lcfg.fastemit_lambda)

    def loss():
        with torch.enable_grad():
            torch.autograd.grad(rnnt_loss(lp, *args), lp)

    def criterion():
        with torch.enable_grad():
            torch.autograd.grad(rnnt_criterion(x, extra, lcfg)[0], x)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    loss()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        loss()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    b, s, u1, v = lat.shape
    out = dict(lattice_shape=[b, s, u1, v],
               lattice_gib=lat.numel() * 4 / 2 ** 30,
               diagonal_steps=s + u1 - 2,
               rnnt_loss_kernels_fwd_bwd=sum(e.count for e in kernels),
               rnnt_loss_device_ms=sum(e.self_device_time_total
                                       for e in kernels) / 1e3)
    for name, fn in (("joiner", joiner), ("log_softmax", log_softmax),
                     ("rnnt_loss", loss), ("criterion", criterion)):
        out[f"{name}_fwd_bwd_ms"] = cuda_ms(fn, samples=3, runs=1,
                                            warmup=1)
    return out


def phase_transducer(dev, asr, asr_checkpoint, speech, workdir):
    """exp/6_transducer.sh on the card: (train) 8 Adam steps of
    TransducerConfig() through cli/train with exp/6's options, the encoder
    from phase 8's checkpoint, on 16 of phase 7's utterances; launches per
    step, peak memory per step, 3 profiled steps, the loss side of a step
    by part, and one step at dropout 0 kernels vs plain; (offline)
    decode_batch greedy and beam 5 on phase 3's batch, the best
    hypotheses fed back through the decode step with the kernels and the
    plain versions; (streaming) the trained model served through
    stream/build.build_agent: the blank's test-time scale, one utterance
    fused == step-wise, then evaluate at B = 1 and evaluate_batched at B 8
    step-wise and scanned over 16 utterances, tokens == B = 1 but for
    proven ties.  Returns the main path's launches."""
    import torch
    from simulst_tpu_torch import config as cfglib
    from simulst_tpu_torch.cli import generate
    from simulst_tpu_torch.cli import train as cli
    from simulst_tpu_torch.decode.beam import BeamConfig
    from simulst_tpu_torch.losses.rnnt_loss import RNNTLossConfig
    from simulst_tpu_torch.models import transducer as tr
    from simulst_tpu_torch.ops.fbank import fbank_batch
    from simulst_tpu_torch.stream.agents import TransducerAgent
    from simulst_tpu_torch.stream.build import build_agent
    from simulst_tpu_torch.train.checkpoint import (load_checkpoint,
                                                    save_checkpoint)
    from simulst_tpu_torch.train.state import (create_train_state,
                                               make_accum_train_step,
                                               make_train_step)

    t_phase = time.perf_counter()
    batch = {k: v[:TRANSDUCER_UTT] for k, v in asr.items()}
    args = cli.parse_args(TRANSDUCER_ARGS + ["--load-pretrained-encoder-from",
                                             asr_checkpoint])
    model = cli.build_model(args, ASR_VOCAB, device=dev)
    pre, _ = load_checkpoint(asr_checkpoint)
    if not all(torch.equal(v.cpu(), pre[k]) for k, v in
               model.state_dict().items() if k.startswith("encoder.")):
        raise AssertionError("the transducer's encoder is not phase 8's")
    loss_fn = cli.build_loss(args, model)
    optim_cfg = cli.optim_config(args)
    train_step = make_train_step(loss_fn, optim_cfg)
    state = create_train_state(model, optim_cfg)
    generator = torch.Generator().manual_seed(SEED)
    initial = copy.deepcopy(state)
    reset_launches()
    step_ms, losses, rnnt, peak = [], [], [], []
    for _ in range(TRANSDUCER_STEPS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, generator)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        peak.append(torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        losses.append(float(metrics["loss"]) / float(metrics["sample_size"]))
        rnnt.append(float(metrics["rnnt_loss"])
                    / float(metrics["sample_size"]))
    train_launches = read_launches()
    per_step = {k: train_launches[k] / TRANSDUCER_STEPS
                for k in TRANSDUCER_LAUNCHES_PER_STEP}
    if per_step != TRANSDUCER_LAUNCHES_PER_STEP:
        raise AssertionError(f"launches per step {per_step}, expected "
                             f"{TRANSDUCER_LAUNCHES_PER_STEP}")
    if not all(np.isfinite(losses + rnnt)) or \
            state.step != TRANSDUCER_STEPS:
        raise AssertionError(f"losses {losses}, RNN-T terms {rnnt}, "
                             f"updates {state.step}")
    log("phase18", config="TransducerConfig() " + " ".join(
            TRANSDUCER_ARGS[6:10]), utterances=TRANSDUCER_UTT,
        frames=f"{ASR_MIN_FRAMES}-{ASR_FRAMES}",
        target_tokens=int((batch["target"] != 1).sum()),
        steps=TRANSDUCER_STEPS, first_step_ms=step_ms[0],
        median_step_ms=statistics.median(step_ms[1:]), step_ms=step_ms,
        losses=losses, rnnt_loss_per_token=rnnt,
        launches_per_step=per_step, peak_memory_gib_per_step=peak)
    state = profile_steps(state, train_step, batch, generator, "phase18",
                          TRANSDUCER_FAMILIES + KERNEL_FAMILIES)
    log("phase18", loss_side_of_a_step=lattice_breakdown(
        state.model, batch, cfglib.apply_overrides(RNNTLossConfig(),
                                                   args.loss_overrides)))
    trained = state.model.eval()
    del state
    compare_plain_step(initial, loss_fn, optim_cfg, batch, "phase18",
                       make_accum_train_step)
    del initial
    train_s = time.perf_counter() - t_phase

    # offline decode, greedy and beam 5, on phase 3's batch
    t0_off = time.perf_counter()
    decode_launches = {}
    with torch.no_grad():
        for beam in (1, BEAM):
            beam_cfg = BeamConfig(beam_size=beam, max_len=MAX_LEN)
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tokens, lengths = generate.decode_batch(
                trained, speech, beam_cfg)
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            launched = read_launches()
            missing = [k for k in TRANSDUCER_DECODE_KERNELS
                       if not launched[k]]
            if missing:
                raise AssertionError(f"beam {beam}: {missing} did not launch "
                                     f"in the offline decode: {launched}")
            decode_launches = {k: decode_launches.get(k, 0) + n
                               for k, n in launched.items()}
            if tokens.shape != (N_UTT, MAX_LEN) or not (
                    (lengths >= 1) & (lengths <= MAX_LEN)).all():
                raise AssertionError(f"beam {beam}: decode output "
                                     f"{tuple(tokens.shape)}, lengths "
                                     f"{lengths.tolist()}")
            t0 = time.perf_counter()
            generate.decode_batch(trained, speech, beam_cfg)
            torch.cuda.synchronize()
            steady_ms = (time.perf_counter() - t0) * 1e3
            got = hypothesis_logits(generate._build_transducer, trained,
                                    speech, tokens, beam)
            with plain_training():
                want = hypothesis_logits(generate._build_transducer, trained,
                                         speech, tokens, beam)
            live = (torch.arange(MAX_LEN, device=dev)[None, :]
                    < lengths.repeat_interleave(beam)[:, None])
            err = max_err(f"transducer beam {beam} decode logits along the "
                          "best hypotheses, kernels vs plain", got[live],
                          want[live], **F32_TOL)
            log("phase18", offline_beam=beam, batch=N_UTT, max_len=MAX_LEN,
                first_ms_per_batch=first_ms, steady_ms_per_batch=steady_ms,
                token_lengths=lengths.tolist(),
                distinct_tokens=len(set(tokens.flatten().tolist())),
                launches=launched, logits_max_abs_err=err)
    offline_s = time.perf_counter() - t0_off

    # streaming: the trained checkpoint through build_agent, as
    # cli/stream_eval --agent transducer loads it
    t0_stream = time.perf_counter()
    ckpt = os.path.join(workdir, "transducer_checkpoint")
    save_checkpoint(ckpt, trained.state_dict(),
                    {"model": "transducer",
                     "config": cfglib.to_dict(trained.cfg), "cmvn": "global"})
    del trained
    wavs = transducer_audio(np.random.RandomState(SEED + 18))
    with torch.no_grad():
        feats = torch.cat([fbank_batch(torch.from_numpy(
            w.astype(np.float32)).to(dev)[None])[0] for w in wavs])
    gcmvn = os.path.join(workdir, "gcmvn_transducer.npz")
    np.savez(gcmvn, mean=feats.mean(dim=0).cpu().numpy(),
             std=feats.std(dim=0).cpu().numpy())
    del feats
    vocab = serve_vocab()
    refs = [" ".join(f"w{k}" for k in range(i, i + 12))
            for i in range(len(wavs))]
    agent = build_agent(ckpt, vocab, agent_type="transducer",
                        global_cmvn_path=gcmvn, fused=True, device=dev,
                        max_src_frames=1024,
                        max_tgt_len=TRANSDUCER_STREAM_MAX_TGT)
    stepwise = TransducerAgent(agent.model, vocab, agent.acfg,
                               global_cmvn=agent.global_cmvn)
    scales = transducer_test_time_scales(dev, agent, wavs[0])
    with patched([(tr, "joiner_forward", scaled_joiner(scales))]):
        stream_launches = transducer_stream(dev, agent, stepwise, wavs, refs,
                                            scales)

    log("phase18", train_s=train_s, offline_s=offline_s,
        stream_s=time.perf_counter() - t0_stream,
        total_s=time.perf_counter() - t_phase)
    return {k: train_launches[k] + decode_launches.get(k, 0)
            + stream_launches[k] for k in train_launches}


def scaled_joiner(log_scales):
    """models/transducer.joiner_forward with some tokens' probabilities
    scaled at test time: log_scales {token id: log-scale}, each added to
    that token's logit."""
    from simulst_tpu_torch.models import transducer as tr
    real = tr.joiner_forward

    def joiner(p, src_feats, tgt_feats):
        out = real(p, src_feats, tgt_feats)
        for token, log_scale in log_scales.items():
            out[..., token] += log_scale
        return out
    return joiner


def transducer_test_time_scales(dev, agent, wav):
    """The test-time log-scales of the blank's and EOS's probabilities
    under which `wav` streams.  At 0 a briefly trained transducer writes
    at its first frame until its token buffer fills; with the blank's
    large enough, every visible frame is blank and it READs until the
    source ends.  The blank's: doubling from the largest margin of its
    frames at the start state (the best non-blank logit over the blank's,
    the offline encoder over the whole utterance) to a scale at which it
    writes nothing before the source ends, then bisecting towards the last
    at which it does.  Then, where that still fills the buffer, EOS's:
    doubling from 1 to a scale at which the session ends on EOS (an early
    EOS is rejected, a READ), then bisecting towards the first.  Of the
    pairs tried, the one that writes before the source ends and ends on
    EOS with the most words, else the one with the most chunks that wrote
    before the source ended.  Fails when none writes before the source
    ends."""
    import torch
    from simulst_tpu_torch.models import s2t_emformer as s2t
    from simulst_tpu_torch.models import transducer as tr
    from simulst_tpu_torch.ops.fbank import fbank_batch
    from simulst_tpu_torch.stream.evaluator import run_session
    model, cfg = agent.model, agent.cfg
    mean, std = (torch.as_tensor(np.asarray(a, np.float32), device=dev)
                 for a in agent.global_cmvn)
    with torch.no_grad():
        feats = (fbank_batch(torch.from_numpy(wav.astype(np.float32)).to(
            dev)[None]) - mean) / std
        enc = s2t.encoder_forward(model.encoder, cfg, feats, torch.tensor(
            [feats.shape[1]], device=dev))
        start = tr.label_features(model.decoder, cfg, torch.full(
            (1, 1), cfg.blank_idx, dtype=torch.int64, device=dev))
        lat = tr.joiner_forward(model.decoder, enc.encoder_out, start)[0, :, 0]
        blank = lat[:, cfg.blank_idx].clone()
        lat[:, cfg.blank_idx] = float("-inf")
        margins = lat.max(dim=-1).values - blank
    length_ms = len(wav) / 16.0
    tried = []

    def outcome(blank_ls, eos_ls):
        scales = {cfg.blank_idx: blank_ls, cfg.eos_idx: eos_ls}
        with patched([(tr, "joiner_forward", scaled_joiner(scales))]):
            words, delays, _, trunc = run_session(agent, wav)
        mid = {d for d in delays if d < length_ms}
        tried.append(dict(blank_log_scale=blank_ls, eos_log_scale=eos_ls,
                          words=len(words), midstream_chunks=len(mid),
                          first_write_ms=min(mid) if mid else None,
                          truncated=trunc))
        return tried[-1]

    def search(start_hi, grows):
        """Doubling from start_hi while grows(outcome), then bisecting the
        last step: the boundary of grows."""
        lo, hi = 0.0, start_hi
        for _ in range(TRANSDUCER_SCALE_DOUBLINGS):
            if not grows(hi):
                break
            lo, hi = hi, 2 * hi
        for _ in range(TRANSDUCER_SCALE_BISECTIONS):
            mid = (lo + hi) / 2
            if grows(mid):
                lo = mid
            else:
                hi = mid
        return lo

    blank_ls = search(max(float(margins.max()), 1e-3),
                      lambda x: outcome(x, 0.0)["midstream_chunks"] > 0)
    if outcome(blank_ls, 0.0)["truncated"]:
        search(1.0, lambda x: outcome(blank_ls, x)["truncated"])
    best = max(tried, key=lambda r: (
        r["midstream_chunks"] > 0 and not r["truncated"],
        r["words"] if not r["truncated"] else r["midstream_chunks"]))
    if not best["midstream_chunks"]:
        raise AssertionError("no test-time scale makes the transducer write "
                             f"before the source ends: {tried}")
    log("phase18", test_time_log_scales=[best["blank_log_scale"],
                                         best["eos_log_scale"]],
        frame_margins_min_median_max=[float(margins.min()),
                                      float(margins.median()),
                                      float(margins.max())], tried=tried)
    return {cfg.blank_idx: best["blank_log_scale"],
            cfg.eos_idx: best["eos_log_scale"]}


def transducer_stream(dev, agent, stepwise, wavs, refs, scales):
    """Phase 18's streaming runs (the test-time scales in place):
    one utterance through the fused step vs the step-wise session, then
    B = 1 over all, B 8 step-wise and scanned, tokens == B = 1 but for
    proven ties; the traffic must write mid-stream, not fill every buffer
    and part ways within a B 8 chunk.  Returns the fused session's
    launches."""
    import torch
    from simulst_tpu_torch.stream.evaluator import (evaluate,
                                                    evaluate_batched,
                                                    run_session)
    length_ms = len(wavs[0]) / 16.0

    # one utterance: the fused step vs the step-wise session
    make = agent.new_session

    def timed_sessions(chunk_ms, sessions):
        """agent.new_session, each session recorded and its chunk calls
        timed."""
        def new_session():
            session = make()
            sessions.append(session)
            step = session.process_chunk

            def timed(samples, finished):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(samples, finished)
                torch.cuda.synchronize()
                chunk_ms.append((time.perf_counter() - t0) * 1e3)
                return out
            session.process_chunk = timed
            return session
        return new_session

    chunk_ms = []
    agent.new_session = timed_sessions(chunk_ms, [])
    reset_launches()
    fused_run = run_session(agent, wavs[0])
    stream_launches = read_launches()
    missing = [k for k in TRANSDUCER_STREAM_KERNELS
               if not stream_launches[k]]
    if missing:
        raise AssertionError(f"{missing} did not launch in the transducer "
                             f"streaming session: {stream_launches}")
    step_run = run_session(stepwise, wavs[0])
    if fused_run[0] != step_run[0] or fused_run[1] != step_run[1]:
        raise AssertionError(f"transducer fused session {fused_run[:2]} "
                             f"differs from the step-wise {step_run[:2]}")
    log("phase18", stream_utterance_ms=length_ms, words=len(fused_run[0]),
        delays_ms=fused_run[1], chunks=len(chunk_ms),
        median_ms_per_chunk=statistics.median(chunk_ms),
        chunk_ms=chunk_ms, fused_equals_stepwise=True,
        launches_in_session=stream_launches)

    if not any(d < length_ms for d in fused_run[1]):
        raise AssertionError("the transducer wrote nothing before the "
                             f"source ended: {fused_run[:2]}")

    # B = 1 over the 16, then B 8 step-wise and scanned
    b1_ms, b1_sessions = [], []
    agent.new_session = timed_sessions(b1_ms, b1_sessions)
    t0 = time.perf_counter()
    b1_scores = evaluate(agent, wavs, refs)
    b1_s = time.perf_counter() - t0
    agent.new_session = make
    b1_tokens = {i: s.state.tokens[0, :int(s.state.n_tokens[0])].tolist()
                 for i, s in enumerate(b1_sessions)}
    runs, diverged = {}, []
    for scan in (False, True):
        sessions, b8_ms = [], []
        make_b = agent.new_batched_session

        def record(n):
            session = make_b(n)
            sessions.append(session)
            step = session.process_chunk_batch

            def timed(chunks, finished):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(chunks, finished)
                torch.cuda.synchronize()
                b8_ms.append((time.perf_counter() - t0) * 1e3)
                if not finished:
                    diverged.append(len({len(t) for t in out}) > 1)
                return out
            session.process_chunk_batch = timed
            return session

        agent.new_batched_session = record
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = evaluate_batched(agent, wavs, refs, batch_size=8, scan=scan)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        del agent.new_batched_session
        tokens = served_tokens(sessions, batch_groups(agent, wavs, 8))
        flips = []
        for i, got in sorted(tokens.items()):
            want = b1_tokens[i]
            if got == want:
                continue
            j = next((k for k, (a, b) in enumerate(zip(got, want))
                      if a != b), min(len(got), len(want)))
            gap, replay = b1_gap(agent, "transducer", wavs[i], j)
            if replay != want:
                raise AssertionError(f"transducer utt {i}: the B = 1 replay "
                                     "differs from the B = 1 run")
            if gap is None or not gap < TIE_GAP:
                raise AssertionError(
                    f"transducer B 8 {'scanned' if scan else 'step-wise'} "
                    f"utt {i}: tokens differ from B = 1 at {j} "
                    f"({got[j:j + 3]} vs {want[j:j + 3]}), top-two gap "
                    f"{gap} not under {TIE_GAP}")
            flips.append(dict(utt=i, index=j, gap=gap))
        runs["scanned" if scan else "stepwise"] = dict(
            wall_s=wall, utterances_per_s=len(wavs) / wall,
            median_ms_per_chunk=(statistics.median(b8_ms) if b8_ms
                                 else None),
            tie_flips=flips, AP=scores["AP"], AL=scores["AL"])
    # the traffic must write mid-stream, part ways within a B 8 chunk
    # (some examples WRITE while others READ) and not only fill buffers
    if not (b1_scores["AP"] < 1 and b1_scores["truncated"] < len(wavs)
            and any(diverged)):
        raise AssertionError(
            f"degenerate transducer traffic (AP {b1_scores['AP']}, "
            f"{b1_scores['truncated']} of {len(wavs)} truncated, "
            f"{sum(diverged)} of {len(diverged)} mid-stream B 8 chunks with "
            "diverging writes)")
    log("phase18", streaming_utterances=len(wavs),
        b1=dict(wall_s=b1_s, utterances_per_s=len(wavs) / b1_s,
                median_ms_per_chunk=statistics.median(b1_ms),
                **{k: b1_scores[k] for k in ("AP", "AL", "DAL",
                                             "truncated")}),
        b8=runs, b8_diverged_midstream_chunks=[sum(diverged), len(diverged)],
        test_time_log_scales=scales,
        tokens_per_utterance=[len(t) for t in b1_tokens.values()])
    return stream_launches


def profile_chunk(session, chunk):
    """One lock-step chunk call of a batched session under torch.profiler:
    (wall ms, device kernel ms, kernels)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        session.process_chunk_batch(chunk, False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        raise AssertionError("torch.profiler recorded no device kernels")
    return (wall_ms, sum(e.self_device_time_total for e in kernels) / 1e3,
            sum(e.count for e in kernels))


def launch_delta(before):
    now = read_launches()
    return {k: now[k] - before[k] for k in now}


def chunk_geometry(agent):
    """(first, steady) chunk sizes in samples."""
    from simulst_tpu_torch.stream.agents import chunk_geometry_ms
    first_ms, steady_ms = chunk_geometry_ms(agent.cfg)
    return int(first_ms / 1000.0 * 16000), int(steady_ms / 1000.0 * 16000)


# ---------------------------------------------------------------------------
# phase 19: data to score (MuST-C preparation, the remaining train options,
# s2t_transformer_convpos, the fairseq loader, interactive and visualize)
# ---------------------------------------------------------------------------

DATA_TRAIN_SEGMENTS, DATA_DEV_SEGMENTS = 96, 8
DATA_STEPS = 4
DATA_ARGS = ["--task", "st", "--model", "s2t_emformer", "--loss",
             "joint_ctc", "--override", "ctc_layer=true", "--mtl",
             "--encoder-freezing-updates", "2", "--tensorboard", "--lr",
             "1e-3", "--warmup-updates", "10000", "--clip-norm", "10",
             "--seed", str(SEED)]
CONVPOS_ARGS = ["--task", "asr", "--model", "s2t_transformer_convpos",
                "--loss", "joint_ctc", "--lr", "1e-3", "--warmup-updates",
                "10000", "--clip-norm", "10", "--seed", str(SEED)]
# launches per s2t_transformer_convpos training step: 12 encoder
# self-attention cores (their out-projection and residual plain torch, as in
# the JAX package), 6 decoder layers as in ASR training; no LN-FFN, grouped
# attention, conv-pos weight gradient (the non-causal conv-pos is a plain
# grouped conv) or CTC
CONVPOS_LAUNCHES_PER_STEP = {
    "fused_ln_ffn_res": 0, "fused_ln_ffn_res_backward": 0,
    "emformer_grouped_attention": 0,
    "emformer_grouped_attention_backward": 0,
    "fused_linear_res": 12, "fused_linear_res_backward": 12,
    "fused_mha": 24, "fused_mha_backward": 24,
    "fused_ffn": 6, "fused_ffn_backward": 6,
    "convpos_wgrad": 0, "ctc_alphas": 0, "ctc_d_em": 0}
FAIRSEQ_MODELS = ("s2t_emformer", "mma", "cif", "transducer")
# the reference checkpoints' configurations: CTC heads on s2t_emformer and
# CIF, exp/2_mma.sh's monotonic attention (with its soft projections)
FAIRSEQ_OVERRIDES = {
    "s2t_emformer": {"ctc_layer": True}, "cif": {"ctc_layer": True},
    "mma": {"simul_attn_type": "infinite_lookback_fixed_pre_decision",
            "fixed_pre_decision_ratio": 8, "mass_preservation": True}}


def to_fairseq(name, model):
    """The reference's fairseq state dict of a port model's weights (numpy):
    Linear weights transposed, LayerNorm scale as weight, CIF's alpha conv
    as ConvTBC (K, Cin, Cout), the CIF CTC head under its legacy
    decoder.ctc_layer; the names as the reference's modules give them."""
    rules = [(r"^encoder\.subsample\.layers\.", "encoder.subsample."
              "conv_layers."),
             (r"^encoder\.conv_pos\.g$", "encoder.embed_positions.conv."
              "weight_g"),
             (r"^encoder\.conv_pos\.v$", "encoder.embed_positions.conv."
              "weight_v"),
             (r"^encoder\.conv_pos\.bias$", "encoder.embed_positions.conv."
              "bias"),
             (r"^encoder\.emformer\.layers\.(\d+)\.pos_ff\.ln\.",
              r"encoder.emformer_blocks.emformer_layers.\1.pos_ff.0."),
             (r"^encoder\.emformer\.layers\.(\d+)\.pos_ff\.fc1\.",
              r"encoder.emformer_blocks.emformer_layers.\1.pos_ff.1."),
             (r"^encoder\.emformer\.layers\.(\d+)\.pos_ff\.fc2\.",
              r"encoder.emformer_blocks.emformer_layers.\1.pos_ff.4."),
             (r"^encoder\.emformer\.layers\.(\d+)\.ln_input\.",
              r"encoder.emformer_blocks.emformer_layers.\1."
              "layer_norm_input."),
             (r"^encoder\.emformer\.layers\.", "encoder.emformer_blocks."
              "emformer_layers."),
             (r"^encoder\.emformer\.final_ln\.", "encoder.emformer_blocks."
              "final_layer_norm."),
             (r"\.self_attn_ln\.", ".self_attn_layer_norm."),
             (r"\.encoder_attn_ln\.", ".encoder_attn_layer_norm."),
             (r"\.final_ln\.", ".final_layer_norm."),
             (r"^cif\.conv\.", "encoder.cif_layer.alpha_proj.0."),
             (r"^cif\.ln\.", "encoder.cif_layer.alpha_proj.1."),
             (r"^cif\.proj\.", "encoder.cif_layer.alpha_proj.4.")]
    sd = {}
    for key, value in model.state_dict().items():
        a = value.detach().cpu().numpy()
        fkey = key
        for pat, rep in rules:
            fkey = re.sub(pat, rep, fkey)
        if fkey.endswith(".scale"):
            fkey = fkey[:-len("scale")] + "weight"
        if key == "cif.conv.weight":
            a = np.transpose(a, (2, 1, 0))
        elif a.ndim == 2 and key != "decoder.embed_tokens.weight":
            a = a.T
        if name == "cif" and key == "encoder.ctc_layer.weight":
            fkey = "decoder.ctc_layer.weight"
        sd[fkey] = np.ascontiguousarray(a)
    return sd


def write_data_tree(root):
    """The synthetic MuST-C tree: a train split of 96 segments and a dev
    split of 8, 2-12 s each, two talks per split, int16 tones."""
    from simulst_tpu_torch.data.synthetic import write_mustc_tree
    write_mustc_tree(root, "train", DATA_TRAIN_SEGMENTS, seed=SEED + 40)
    write_mustc_tree(root, "dev", DATA_DEV_SEGMENTS, seed=SEED + 41)


def phase_data(dev, workdir, asr, speech, report):
    """Phase 19: prep a synthetic MuST-C tree, train 4 updates with --mtl,
    encoder freezing, tensorboard and the profiler through the native
    loader, one s2t_transformer_convpos step kernels vs plain, fairseq
    checkpoints of the four served models decoded, interactive and
    visualize.  Returns the launches of the data-to-score path."""
    import io
    import sys
    import glob
    import torch
    from scipy.io import wavfile
    from simulst_tpu_torch import config as cfglib
    from simulst_tpu_torch.cli import generate, interactive, prep_mustc
    from simulst_tpu_torch.cli import train as cli
    from simulst_tpu_torch.cli import visualize
    from simulst_tpu_torch.compat import fairseq_converter
    from simulst_tpu_torch.data import manifest as mf
    from simulst_tpu_torch.data import mustc, native
    from simulst_tpu_torch.data.vocab import Vocabulary
    from simulst_tpu_torch.decode.beam import BeamConfig
    from simulst_tpu_torch.ops import mha
    from simulst_tpu_torch.train import state as state_mod
    from simulst_tpu_torch.train.checkpoint import save_checkpoint
    from simulst_tpu_torch.train.state import (create_train_state,
                                               make_accum_train_step,
                                               make_train_step)
    t_phase = time.perf_counter()
    root = os.path.join(workdir, "mustc")
    data = os.path.join(workdir, "data")

    # (a) the tree and cli/prep_mustc: fbank on the card, the native SPM
    t0 = time.perf_counter()
    write_data_tree(root)
    tree_s = time.perf_counter() - t0
    # the sentencepiece package, where the machine has it, is blocked so
    # that the native trainer and reader (data/spm.py) run
    spm_package = sys.modules.get("sentencepiece")
    sys.modules["sentencepiece"] = None
    try:
        t0 = time.perf_counter()
        prep_mustc.main(["--data-root", root, "--out-dir", data, "--splits",
                         "train", "dev", "--device", str(dev)])
        prep_s = time.perf_counter() - t0
        vocab_path = glob.glob(os.path.join(data,
                                            "spm_unigram*_st.model"))[0]
        vocab = Vocabulary.from_spm(vocab_path)
    finally:
        if spm_package is None:
            del sys.modules["sentencepiece"]
        else:
            sys.modules["sentencepiece"] = spm_package
    rows = mf.load_tsv(os.path.join(data, "train_st.tsv"))
    with np.load(os.path.join(data, "gcmvn.npz")) as f:
        gstd = f["std"]
    if len(rows) != DATA_TRAIN_SEGMENTS or not np.isfinite(gstd).all() or \
            type(vocab.spm).__module__ != "simulst_tpu_torch.data.spm":
        raise AssertionError(f"prep: {len(rows)} train rows, gcmvn finite "
                             f"{np.isfinite(gstd).all()}, spm "
                             f"{type(vocab.spm)}")
    log("phase19", step="prep", segments=[DATA_TRAIN_SEGMENTS,
                                          DATA_DEV_SEGMENTS],
        audio_s=sum(int(r["n_frames"]) for r in rows) / 100,
        frames=[min(int(r["n_frames"]) for r in rows),
                max(int(r["n_frames"]) for r in rows)],
        vocab=len(vocab), tree_s=tree_s, prep_s=prep_s)

    # (b) cli/train --mtl --encoder-freezing-updates 2 --tensorboard
    # --profile through the native loader; the encoder after each update
    real_apply, real_load = state_mod.apply_update, native.load_feature_batch
    snap, frozen, loads = {}, [], []

    def apply_update(state, metrics, optim_cfg, freeze_until=None):
        params = dict(state.model.named_parameters())
        if not snap:
            snap.update({n: p.detach().clone() for n, p in params.items()})
        out = real_apply(state, metrics, optim_cfg, freeze_until)
        frozen.append({part: all(torch.equal(params[n], snap[n])
                                 for n in snap if n.startswith(part + "."))
                       for part in ("encoder", "decoder")})
        return out

    def load_feature_batch(specs, *a, **kw):
        loads.append(len(specs))
        return real_load(specs, *a, **kw)

    save = os.path.join(workdir, "data_ckpt")
    prof = os.path.join(workdir, "data_profile")
    reset_launches()
    t0 = time.perf_counter()
    with patched([(state_mod, "apply_update", apply_update),
                  (native, "load_feature_batch", load_feature_batch)]):
        st = cli.main(DATA_ARGS + ["--data", data, "--save-dir", save,
                                   "--max-updates", str(DATA_STEPS),
                                   "--profile", prof, "--device", str(dev)])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = read_launches()
    events = glob.glob(os.path.join(save, "tb", "events.out.tfevents.*"))
    want = [{"encoder": True, "decoder": False}] * 2 + \
        [{"encoder": False, "decoder": False}] * (DATA_STEPS - 2)
    missing = [k for k, n in ASR_LAUNCHES_PER_STEP.items()
               if n and not train_launches[k]]
    with open(os.path.join(save, "train_log.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records if "valid_update" in r]
    if st.step != DATA_STEPS or frozen != want or missing or not loads or \
            len(events) != 1 or os.path.getsize(events[0]) < 100 or \
            not os.path.exists(os.path.join(prof, "trace.json")) or \
            not losses or not np.isfinite(losses).all():
        raise AssertionError(f"train --mtl: updates {st.step}, unchanged "
                             f"after each update {frozen} (want {want}), "
                             f"kernels not launched {missing}, native loads "
                             f"{loads}, events {events}, valid losses "
                             f"{losses}")
    log("phase19", step="train --mtl --encoder-freezing-updates 2 "
        "--tensorboard --profile", updates=DATA_STEPS, s=train_s,
        unchanged_after_each_update=frozen, native_batch_loads=loads,
        valid_losses=losses, launches=train_launches,
        event_bytes=os.path.getsize(events[0]),
        trace_bytes=os.path.getsize(os.path.join(prof, "trace.json")))
    del st

    # (c) s2t_transformer_convpos: rows 5 / 5b at its encoder's shape, one
    # train step kernels vs plain, its device time, a beam-5 decode
    b = asr["feats"].shape[0]
    u = int(subsampled(torch.tensor(asr["feats"].shape[1])))
    kmask = (torch.arange(u, device=dev)[None, :] <
             subsampled(asr["feat_lengths"])[:, None]).to(torch.int32)
    g = torch.Generator().manual_seed(SEED + 43)
    q, k, v, dout = (torch.randn(b, u, 256, generator=g).to(dev)
                     for _ in range(4))
    cfg = (4, False, 0.1, 4321)
    with torch.no_grad():
        out, lse = mha.fused_mha_forward(q, k, v, kmask, *cfg)
        torch.cuda.synchronize()
        e_fwd = max_err("fused_mha convpos encoder", out,
                        mha.mha_plain(q, k, v, kmask, *cfg), **F32_TOL)
        got = mha.fused_mha_backward(q, k, v, kmask, out, lse, dout, *cfg)
        want_g = mha.mha_plain_backward(q, k, v, kmask, dout, *cfg)
        torch.cuda.synchronize()
        e_bwd = max(max_err(f"fused_mha_backward convpos encoder d{w}", x, y,
                            **F32_TOL) for w, x, y in zip("qkv", got, want_g))
        vis = mha_visible_pairs(kmask, u, False)
        shape = f"(B,Tq,Tk,D)=({b},{u},{u},256) key mask rate 0.1"
        fwd_case = mha_forward_case(q, k, v, kmask, 4, False, 0.1)
        fwd_case["plain_ms"] = cuda_ms(lambda: mha.mha_plain(q, k, v, kmask,
                                                             *cfg))
        bwd_case = dict(
            ms=cuda_ms(lambda: mha.fused_mha_backward(
                q, k, v, kmask, out, lse, dout, *cfg)),
            plain_ms=cuda_ms(lambda: mha.mha_plain_backward(
                q, k, v, kmask, dout, *cfg)),
            library_ms=sdpa_backward_ms(q, k, v, kmask, dout, *cfg[:3]),
            **dict(zip(("bound_ms", "bound_by"), bound(
                nbytes(q, k, v, kmask, out, lse, dout, *got),
                10 * 256 * vis))))
    for name, err, case in (("fused_mha", e_fwd, fwd_case),
                            ("fused_mha_backward", e_bwd, bwd_case)):
        log("phase19", kernel=name, shape=shape, max_abs_err=err,
            visible_pairs=vis, **case)
        entry = report.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry.setdefault("shapes", {})["convpos encoder " + shape] = \
            {"max_abs_err": err, **case}
    del q, k, v, dout, out, lse, got, want_g

    args = cli.parse_args(CONVPOS_ARGS)
    model = cli.build_model(args, ASR_VOCAB, device=dev)
    loss_fn = cli.build_loss(args, model)
    optim_cfg = cli.optim_config(args)
    train_step = make_train_step(loss_fn, optim_cfg)
    cstate = create_train_state(model, optim_cfg)
    initial = copy.deepcopy(cstate)
    generator = torch.Generator().manual_seed(SEED)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cstate, metrics = train_step(cstate, asr, generator)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    per_step = {k: launches[k] for k in CONVPOS_LAUNCHES_PER_STEP}
    loss = float(metrics["loss"]) / float(metrics["sample_size"])
    if per_step != CONVPOS_LAUNCHES_PER_STEP or not np.isfinite(loss):
        raise AssertionError(f"convpos step launches {per_step}, expected "
                             f"{CONVPOS_LAUNCHES_PER_STEP}; loss {loss}")
    log("phase19", step="s2t_transformer_convpos train",
        config="S2TConvPosConfig() (s2t_emformer_s widths, conv_pos 128 "
        "taps non-causal)", utterances=b, first_step_ms=first_ms, loss=loss,
        launches_per_step=per_step)
    cstate = profile_steps(cstate, train_step, asr, generator,
                           "phase19-convpos")
    del cstate
    compare_plain_step(initial, loss_fn, optim_cfg, asr, "phase19-convpos",
                       make_accum_train_step)
    model = initial.model.eval()
    beam_cfg = BeamConfig(beam_size=BEAM, max_len=MAX_LEN)
    with torch.no_grad():
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens, lengths = generate.decode_batch(model, speech, beam_cfg)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3
        decode_launches = read_launches()
        kern = hypothesis_logits(generate._build_std, model, speech, tokens)
        with plain_training():
            plain = hypothesis_logits(generate._build_std, model, speech,
                                      tokens)
    live = (torch.arange(MAX_LEN, device=dev)[None, :]
            < lengths.repeat_interleave(BEAM)[:, None])
    err = max_err("convpos decode logits along the best hypotheses, "
                  "kernels vs plain", kern[live], plain[live], **F32_TOL)
    if tokens.shape != (N_UTT, MAX_LEN) or not decode_launches["fused_mha"]:
        raise AssertionError(f"convpos decode {tuple(tokens.shape)}, "
                             f"launches {decode_launches}")
    log("phase19", step="s2t_transformer_convpos decode", beam=BEAM,
        ms_per_batch=decode_ms, token_lengths=lengths.tolist(),
        logits_max_abs_err=err, launches=decode_launches)
    del initial, model, kern, plain

    # (d) fairseq checkpoints of the four served models at full width
    fairseq = {}
    for name in FAIRSEQ_MODELS:
        over = FAIRSEQ_OVERRIDES.get(name, {})
        fargs = SimpleNamespace(
            model=name, seed=SEED + 44, load_params=None,
            load_pretrained_encoder_from=None,
            load_pretrained_decoder_from=None, overrides=over)
        src = cli.build_model(fargs, ASR_VOCAB, device=dev).eval()
        path = os.path.join(workdir, f"{name}_fairseq.pt")
        torch.save({"cfg": None, "model": {
            k: torch.from_numpy(a) for k, a in to_fairseq(name, src).items()}},
            path)
        fargs.seed = SEED + 45
        dst = cli.build_model(fargs, ASR_VOCAB, device=dev).eval()
        fairseq_converter.convert(name, dst, path)
        differ = [k for k, v in src.state_dict().items()
                  if not torch.equal(v, dst.state_dict()[k])]
        with torch.no_grad():
            toks = [generate.decode_batch(m, speech, beam_cfg)
                    for m in (src, dst)]
        same = all(torch.equal(x, y) for x, y in zip(*toks))
        if differ or not same:
            raise AssertionError(f"fairseq {name}: parameters differ "
                                 f"{differ[:5]}, tokens equal {same}")
        fairseq[name] = {"parameters": len(src.state_dict()),
                         "token_lengths": toks[1][1].tolist()}
        del src, dst
    log("phase19", step="fairseq loader, decode beam 5", models=fairseq)

    # (e) cli/interactive on two dev segments, cli/visualize on a CIF model
    dev_rows = mustc.parse_segments(root, "dev", "en", "de")
    wavs = []
    for i, (uid, wav) in enumerate(mustc.iter_segment_audio(dev_rows[:2])):
        wavs.append(os.path.join(workdir, f"{uid}.wav"))
        wavfile.write(wavs[-1], 16000, (wav * 32767).astype(np.int16))
    vocab_txt = vocab_path[:-len(".model")] + ".txt"
    stdin, buf = sys.stdin, io.StringIO()
    sys.stdin = io.StringIO("\n".join(wavs) + "\n")
    try:
        with contextlib.redirect_stdout(buf):
            interactive.main(["--checkpoint", os.path.join(
                save, "checkpoint_last"), "--vocab", vocab_txt, "--beam",
                str(BEAM), "--max-len", str(MAX_LEN), "--device", str(dev)])
    finally:
        sys.stdin = stdin
    hyps = [x for x in buf.getvalue().splitlines() if x.startswith("H-")]
    cif_args = SimpleNamespace(
        model="cif", seed=SEED + 46, load_params=None,
        load_pretrained_encoder_from=None, load_pretrained_decoder_from=None,
        overrides=FAIRSEQ_OVERRIDES["cif"])
    cif = cli.build_model(cif_args, len(vocab), device=dev)
    cif_path = os.path.join(workdir, "visualize_cif")
    save_checkpoint(cif_path, cif.state_dict(),
                    {"model": "cif", "config": cfglib.to_dict(cif.cfg)})
    del cif
    viz = os.path.join(workdir, "viz")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        visualize.main(["--data", data, "--subset", "dev", "--checkpoint",
                        cif_path, "--vocab", vocab_txt, "--n", "2", "--out",
                        viz, "--device", str(dev)])
    npz = sorted(glob.glob(os.path.join(viz, "*.npz")))
    finite = all(np.isfinite(np.load(p)["alpha"]).all() for p in npz)
    if len(hyps) != 2 or len(npz) != 2 or not finite:
        raise AssertionError(f"interactive {hyps}, visualize {npz} "
                             f"(alphas finite {finite})")
    log("phase19", step="interactive, visualize", hypotheses=hyps,
        timelines=buf.getvalue().count("== "),
        s=time.perf_counter() - t_phase)
    return {k: train_launches[k] + per_step.get(k, 0) + decode_launches[k]
            for k in train_launches}


# ---------------------------------------------------------------------------
# 20. bf16 compute (compute_dtype), remat and the model options
# ---------------------------------------------------------------------------

BF16_OVERRIDE = ["--override", "compute_dtype=bfloat16"]
# a bf16 train step, kernels vs plain: every gradient within this share of
# its largest entry (bf16 rounds at 2^-8; the two sides round the same
# intermediates, but sums in another order flip some of those roundings,
# and a flip moves everything downstream by about 2^-8 of it)
BF16_STEP_TOL = 5e-2
# bf16 streaming vs the bf16 offline encoder output (final-LN'd, O(1)
# entries; about 8 bf16 ulps at 2)
BF16_STREAM_ATOL = 0.1
# the FFN activations timed against gelu, at asr-train's LN-FFN rows and
# the decoder step's (beam 5 x 8 utterances)
ACTIVATION_ROWS = (12288, 40)
VARIANT_LAYERS = 4          # the variants' Emformer depth (full width)


def phase_activations(dev):
    """silu and tanh (and gelu, their yardstick) in both FFN kernels,
    forward and backward, fp32 and bf16, against their plain versions at
    ACTIVATION_ROWS rows, rate 0.1, the LN parameters fp32; CUDA-event
    times of each kernel with each activation at each row count and dtype,
    beside their bound.  relu, unchanged here, is held to the parent's bits
    by tools/kernel_bitcheck.py (against its plain version over thousands
    of rows some u lies within a rounding of 0, where relu's derivative
    flips).  Returns {kernel: {case: entry}} for the report."""
    import torch
    from simulst_tpu_torch.ops import ffn
    g = torch.Generator().manual_seed(SEED + 31)
    d, hid = 256, 2048
    xav = (6.0 / (d + hid)) ** 0.5

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    w32 = (1 + randn(d, scale=0.1), randn(d, scale=0.1),
           randn(d, hid, scale=xav), randn(hid, scale=0.02),
           randn(hid, d, scale=xav), randn(d, scale=0.02))
    out = defaultdict(dict)
    for rows in ACTIVATION_ROWS:
        x32, dy32 = randn(rows, d), randn(rows, d)
        for dtype in (torch.float32, torch.bfloat16):
            bf = dtype == torch.bfloat16
            tol, wtol = (BF16_TOL, 1e-2) if bf else (F32_TOL, 1e-4)
            x, dy = x32.to(dtype), dy32.to(dtype)
            g_, b_ = w32[:2]            # LN parameters stay fp32
            w1, b1, w2, b2 = (w.to(dtype) for w in w32[2:])
            tag = f"{rows} rows {'bf16' if bf else 'fp32'}"
            for act in ("gelu", "silu", "tanh"):
                cfg = (act, 0.1, 0.1, 29)
                cases = {
                    "fused_ln_ffn_res": (
                        lambda: ffn.fused_ln_ffn_res_forward(
                            x, g_, b_, w1, b1, w2, b2, *cfg),
                        lambda: ffn.ln_ffn_res_plain(
                            x, g_, b_, w1, b1, w2, b2, *cfg),
                        nbytes(x, x, g_, b_, w1, b1, w2, b2), 2),
                    "fused_ln_ffn_res_backward": (
                        lambda: ffn.fused_ln_ffn_res_backward(
                            x, g_, b_, w1, b1, w2, dy, *cfg),
                        lambda: ffn.ln_ffn_res_plain_backward(
                            x, g_, b_, w1, b1, w2, dy, *cfg),
                        nbytes(x, dy, x, g_, b_, w1, b1, w2) +
                        4 * (2 * d * hid + hid + 3 * d), 5),
                    "fused_ffn": (
                        lambda: ffn.fused_ffn_forward(x, w1, b1, w2, b2,
                                                      *cfg),
                        lambda: ffn.ffn_plain(x, w1, b1, w2, b2, *cfg),
                        nbytes(x, x, w1, b1, w2, b2), 2),
                    "fused_ffn_backward": (
                        lambda: ffn.fused_ffn_backward(x, w1, b1, w2, dy,
                                                       *cfg),
                        lambda: ffn.ffn_plain_backward(x, w1, b1, w2, dy,
                                                       *cfg),
                        nbytes(x, dy, x, w1, b1, w2) +
                        4 * (2 * d * hid + hid + d), 5)}
                for name, (kern, plain, moved, products) in cases.items():
                    got, want = kern(), plain()
                    torch.cuda.synchronize()
                    if isinstance(got, torch.Tensor):
                        err = max_err(f"{name} {act} {tag}", got, want,
                                      **tol)
                    else:
                        err = max([max_err(f"{name} {act} {tag} dx", got[0],
                                           want[0], **tol)] +
                                  [max_err_to_largest(
                                      f"{name} {act} {tag} grad {i}", a, b,
                                      wtol)
                                   for i, (a, b) in enumerate(
                                       zip(got[1:], want[1:]))])
                    fl = products * 2 * rows * d * hid
                    out[name][f"{act} {tag}"] = dict(
                        max_abs_err=err, ms=cuda_ms(kern, samples=5, runs=5),
                        **dict(zip(("bound_ms", "bound_by"),
                                   bound(moved, fl, dtype))))
                    if act in ("silu", "tanh") and rows == ACTIVATION_ROWS[0]:
                        out[name][f"{act} {tag}"]["plain_ms"] = cuda_ms(
                            plain, samples=3, runs=3)
    for name, cases in out.items():
        for case, entry in cases.items():
            act, _, rest = case.partition(" ")
            gelu = cases[f"gelu {rest}"]["ms"]
            entry["vs_gelu"] = entry["ms"] / gelu
        log("phase20", kernel=name, activations=cases)
    return out


def phase_bf16_kernels(dev, batch):
    """Rows 1-6 in bf16 at asr-train's shapes (phase 7's, the inputs cast
    to bf16), rate 0.1: each kernel against its plain version (BF16_TOL;
    weight gradients 1e-2 of the largest entry), its CUDA-event time, the
    plain version's, the bound of its bf16 bytes and fp32 operations and
    the library call or the products' torch.matmul yardstick in bf16.
    Rows 7 and 8 (the CTC DP) take fp32 emissions in a bf16 model, as in
    the JAX package: phase 7's times are theirs.  Returns {kernel:
    entry}."""
    import torch
    import torch.nn.functional as F
    from simulst_tpu_torch.ops import conv_pos, linear_res, mha
    from simulst_tpu_torch.ops import emformer_attn as ea
    from simulst_tpu_torch.ops import ffn
    bf = torch.bfloat16
    g = torch.Generator().manual_seed(SEED + 37)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev).to(bf)

    b, d, hid, heads = ASR_UTT, 256, 2048, 4
    lengths = subsampled(batch["feat_lengths"]).to(torch.int32)
    xav = (6.0 / (d + hid)) ** 0.5
    out = {}

    def entry(name, shape, kern, plain, moved, flops, library=None,
              err=0.0, library_ms=None, **extra):
        out[name] = dict(
            shape=shape, max_abs_err=err, ms=cuda_ms(kern, samples=5,
                                                     runs=5),
            plain_ms=cuda_ms(plain, samples=3, runs=3),
            library_ms=library_ms if library is None else cuda_ms(
                library, samples=5, runs=5),
            **dict(zip(("bound_ms", "bound_by"), bound(moved, flops, bf))),
            **extra)
        log("phase20", kernel=name, bf16=out[name])

    def grads_err(name, got, want):
        return max([max_err(f"{name} bf16 d0", got[0], want[0], **BF16_TOL)]
                   + [max_err_to_largest(f"{name} bf16 grad {i}", a, c, 1e-2)
                      for i, (a, c) in enumerate(zip(got[1:], want[1:]))])

    def yardstick(x, w1, w2, dy=None):
        a, c = (torch.randn(x.shape[0], w1.shape[1], device=dev,
                            dtype=bf) for _ in range(2))
        if dy is None:
            return lambda: (x @ w1, a @ w2)
        return lambda: (x @ w1, dy @ w2.T, a @ w1.T, x.T @ a, c.T @ dy)

    # rows 1 / 1b: every Emformer layer's 12,288 LN-FFN rows
    n = b * (8 * 16 + 256)
    x, dy = randn(n, d), randn(n, d)
    lnw = ((1 + randn(d, scale=0.1)).float(), randn(d, scale=0.1).float(),
           randn(d, hid, scale=xav), randn(hid, scale=0.02),
           randn(hid, d, scale=xav), randn(d, scale=0.02))   # LN params fp32
    cfg = ("gelu", 0.1, 0.1, 17)
    y = ffn.fused_ln_ffn_res_forward(x, *lnw, *cfg)
    flops = 2 * n * d * hid
    entry("fused_ln_ffn_res", f"x=({n},{d}) bf16 gelu rate 0.1",
          lambda: ffn.fused_ln_ffn_res_forward(x, *lnw, *cfg),
          lambda: ffn.ln_ffn_res_plain(x, *lnw, *cfg), nbytes(x, y, *lnw),
          2 * flops, err=max_err("fused_ln_ffn_res bf16", y,
                                 ffn.ln_ffn_res_plain(x, *lnw, *cfg),
                                 **BF16_TOL),
          products_matmul_ms=cuda_ms(yardstick(x, lnw[2], lnw[4]),
                                     samples=5, runs=5))
    got = ffn.fused_ln_ffn_res_backward(x, *lnw[:5], dy, *cfg)
    entry("fused_ln_ffn_res_backward", f"x=({n},{d}) bf16 gelu rate 0.1",
          lambda: ffn.fused_ln_ffn_res_backward(x, *lnw[:5], dy, *cfg),
          lambda: ffn.ln_ffn_res_plain_backward(x, *lnw[:5], dy, *cfg),
          nbytes(x, dy, *lnw[:5], *got), 5 * flops,
          err=grads_err("fused_ln_ffn_res_backward", got,
                        ffn.ln_ffn_res_plain_backward(x, *lnw[:5], dy,
                                                      *cfg)),
          products_matmul_ms=cuda_ms(yardstick(x, lnw[2], lnw[4], dy),
                                     samples=5, runs=5))

    # rows 2 / 2b: the decoder FFN at 32 x 72 rows
    n = b * batch["prev_tokens"].shape[1]
    x, dy = randn(n, d), randn(n, d)
    w = lnw[2:]
    y = ffn.fused_ffn_forward(x, *w, *cfg)
    flops = 2 * n * d * hid
    entry("fused_ffn", f"x=({n},{d}) bf16 gelu rate 0.1",
          lambda: ffn.fused_ffn_forward(x, *w, *cfg),
          lambda: ffn.ffn_plain(x, *w, *cfg), nbytes(x, y, *w), 2 * flops,
          err=max_err("fused_ffn bf16", y, ffn.ffn_plain(x, *w, *cfg),
                      **BF16_TOL),
          products_matmul_ms=cuda_ms(yardstick(x, w[0], w[2]), samples=5,
                                     runs=5))
    got = ffn.fused_ffn_backward(x, *w[:3], dy, *cfg)
    entry("fused_ffn_backward", f"x=({n},{d}) bf16 gelu rate 0.1",
          lambda: ffn.fused_ffn_backward(x, *w[:3], dy, *cfg),
          lambda: ffn.ffn_plain_backward(x, *w[:3], dy, *cfg),
          nbytes(x, dy, *w[:3], *got), 5 * flops,
          err=grads_err("fused_ffn_backward", got,
                        ffn.ffn_plain_backward(x, *w[:3], dy, *cfg)),
          products_matmul_ms=cuda_ms(yardstick(x, w[0], w[2], dy),
                                     samples=5, runs=5))

    # rows 3 / 3b: the grouped attention, (32, 2, 200, 256)
    geom = ea.AttnGeom(U=256, seg=16, lc=32, rc=8, max_mem=5, G=8,
                       num_heads=heads)
    q3, dout = randn(b, geom.ng, geom.nq, d), randn(b, geom.ng, geom.nq, d)
    k, v = randn(b, geom.tk, d), randn(b, geom.tk, d)
    args = (q3, k, v, lengths)
    o = ea.emformer_grouped_attention_forward(*args, geom, 0.1, 23)
    vis = grouped_visible_pairs(ea, geom, *args)
    sd, mask = sdpa_on_context(ea, geom, *args)
    sd = [t.to(bf).requires_grad_() for t in sd]   # on the same bf16 inputs
    with torch.enable_grad():
        sd_out = F.scaled_dot_product_attention(*sd, attn_mask=mask,
                                                dropout_p=0.1)
    sd_dout = torch.randn_like(sd_out)
    shape = f"q3=({b},{geom.ng},{geom.nq},{d}) bf16 rate 0.1"
    entry("emformer_grouped_attention", shape,
          lambda: ea.emformer_grouped_attention_forward(*args, geom, 0.1, 23),
          lambda: ea.grouped_attention_plain(*args, geom, 0.1, 23),
          nbytes(*args, o), 4 * d * vis,
          library=lambda: F.scaled_dot_product_attention(
              *sd, attn_mask=mask, dropout_p=0.1),
          err=max_err("emformer_grouped_attention bf16", o,
                      ea.grouped_attention_plain(*args, geom, 0.1, 23),
                      **BF16_TOL))
    got = ea.emformer_grouped_attention_backward(*args, dout, geom, 0.1, 23)
    want = ea.grouped_attention_plain_backward(*args, dout, geom, 0.1, 23)
    entry("emformer_grouped_attention_backward", shape,
          lambda: ea.emformer_grouped_attention_backward(*args, dout, geom,
                                                         0.1, 23),
          lambda: ea.grouped_attention_plain_backward(*args, dout, geom,
                                                      0.1, 23),
          nbytes(*args, dout, *got), 10 * d * vis,
          library=lambda: torch.autograd.grad(sd_out, sd, sd_dout,
                                              retain_graph=True),
          err=max(max_err(f"grouped attention backward bf16 d{c}", a, w_,
                          **BF16_TOL) for c, a, w_ in zip("qkv", got, want)))
    del sd, sd_out

    # row 3bg: the gated backward at asr-pack's packed rows, (16, 4, 175,
    # 256) at G 7
    pgeom = ea.AttnGeom(U=448, seg=16, lc=32, rc=8, max_mem=5, G=7,
                        num_heads=heads)
    pargs = (randn(16, pgeom.ng, pgeom.nq, d), randn(16, pgeom.tk, d),
             randn(16, pgeom.tk, d),
             torch.full((16,), pgeom.U, dtype=torch.int32, device=dev))
    pdout = randn(16, pgeom.ng, pgeom.nq, d)
    pgate = segment_gate(ea, pgeom, 16, g, dev)
    pvis = grouped_visible_pairs(ea, pgeom, *pargs, pgate)
    sd, mask = sdpa_on_context(ea, pgeom, *pargs, pgate)
    sd = [t.to(bf).requires_grad_() for t in sd]
    with torch.enable_grad():
        sd_out = F.scaled_dot_product_attention(*sd, attn_mask=mask,
                                                dropout_p=0.1)
    sd_dout = torch.randn_like(sd_out)
    pcfg = (pgeom, 0.1, 23, pgate)
    got = ea.emformer_grouped_attention_backward(*pargs, pdout, *pcfg)
    want = ea.grouped_attention_plain_backward(*pargs, pdout, *pcfg)
    entry("emformer_grouped_attention_gated_backward",
          f"q3=(16,{pgeom.ng},{pgeom.nq},{d}) G 7 gated bf16 rate 0.1",
          lambda: ea.emformer_grouped_attention_backward(*pargs, pdout,
                                                         *pcfg),
          lambda: ea.grouped_attention_plain_backward(*pargs, pdout, *pcfg),
          nbytes(*pargs, pdout, *pgate, *got), 10 * d * pvis,
          library=lambda: torch.autograd.grad(sd_out, sd, sd_dout,
                                              retain_graph=True),
          err=max([max_err("gated grouped attention backward bf16 dq",
                           got[0], want[0], **BF16_TOL)]
                  + [max_err_to_largest(
                      f"gated grouped attention backward bf16 d{c}", a, w_,
                      1e-2) for c, a, w_ in zip("kv", got[1:], want[1:])]))
    del sd, sd_out

    # rows 4 / 4b: the Emformer out-projection, 12,800 rows, gate 200 / 192
    w_, bias = randn(d, d, scale=d ** -0.5), randn(d, scale=0.02)
    h, res, dyl = randn(12800, d), randn(12800, d), randn(12800, d)
    lcfg = (200, 192, 0.1, 7)
    y = linear_res.fused_linear_res_forward(h, w_, bias, res, *lcfg)
    entry("fused_linear_res", "h=(12800,256) bf16 period 200 gate 192",
          lambda: linear_res.fused_linear_res_forward(h, w_, bias, res,
                                                      *lcfg),
          lambda: linear_res.linear_res_plain(h, w_, bias, res, *lcfg),
          nbytes(h, w_, bias, res, y), 2 * 12800 * d * d,
          err=max_err("fused_linear_res bf16", y, linear_res.linear_res_plain(
              h, w_, bias, res, *lcfg), **BF16_TOL),
          products_matmul_ms=cuda_ms(lambda: h @ w_, samples=5, runs=5))
    got = linear_res.fused_linear_res_backward(h, w_, dyl, *lcfg)
    entry("fused_linear_res_backward",
          "h=(12800,256) bf16 period 200 gate 192",
          lambda: linear_res.fused_linear_res_backward(h, w_, dyl, *lcfg),
          lambda: linear_res.linear_res_plain_backward(h, w_, dyl, *lcfg),
          nbytes(h, w_, dyl, *got), 4 * 12800 * d * d,
          err=grads_err("fused_linear_res_backward", got,
                        linear_res.linear_res_plain_backward(h, w_, dyl,
                                                             *lcfg)),
          products_matmul_ms=cuda_ms(lambda: (dyl @ w_.T, h.T @ dyl),
                                     samples=5, runs=5))

    # rows 5 / 5b: the decoder's causal self-attention, (32, 72, 72)
    t_len = batch["prev_tokens"].shape[1]
    kmask = (batch["prev_tokens"] != 1).to(torch.int32)
    q, km, vm, do = (randn(b, t_len, d) for _ in range(4))
    mcfg = (heads, True, 0.1, 4321)
    o, lse = mha.fused_mha_forward(q, km, vm, kmask, *mcfg)
    heads_view = [t.view(b, t_len, heads, d // heads).transpose(1, 2)
                  for t in (q, km, vm)]
    smask = sdpa_mask(q, km, kmask, True)
    pairs = mha_visible_pairs(kmask, t_len, True)
    shape = f"({b},{t_len},{t_len}) causal bf16 rate 0.1"
    entry("fused_mha", shape,
          lambda: mha.fused_mha_forward(q, km, vm, kmask, *mcfg),
          lambda: mha.mha_plain(q, km, vm, kmask, *mcfg),
          nbytes(q, km, vm, kmask, o, lse), 4 * d * pairs,
          library=lambda: F.scaled_dot_product_attention(
              *heads_view, attn_mask=smask, dropout_p=0.1),
          err=max_err("fused_mha bf16", o, mha.mha_plain(q, km, vm, kmask,
                                                         *mcfg), **BF16_TOL))
    got = mha.fused_mha_backward(q, km, vm, kmask, o, lse, do, *mcfg)
    entry("fused_mha_backward", shape,
          lambda: mha.fused_mha_backward(q, km, vm, kmask, o, lse, do,
                                         *mcfg),
          lambda: mha.mha_plain_backward(q, km, vm, kmask, do, *mcfg),
          nbytes(q, km, vm, kmask, o, lse, do, *got), 10 * d * pairs,
          err=max(max_err(f"fused_mha_backward bf16 d{c}", a, w2, **BF16_TOL)
                  for c, a, w2 in zip("qkv", got, mha.mha_plain_backward(
                      q, km, vm, kmask, do, *mcfg))),
          library_ms=sdpa_backward_ms(q, km, vm, kmask, do, heads, True,
                                      0.1))

    # row 6: the conv-pos weight gradient, xp (32, 319, 256)
    taps, groups, t_out = 64, 16, 256
    xp, dyc = randn(b, t_out + taps - 1, d), randn(b, t_out, d)
    got = conv_pos.convpos_wgrad(xp, dyc, taps, groups)
    xt, dyt = xp.transpose(1, 2).contiguous(), dyc.transpose(1, 2).contiguous()
    entry("convpos_wgrad", f"xp=({b},{t_out + taps - 1},{d}) bf16",
          lambda: conv_pos.convpos_wgrad(xp, dyc, taps, groups),
          lambda: conv_pos.convpos_wgrad_plain(xp, dyc, taps, groups),
          nbytes(xp, dyc, got), 2 * b * t_out * taps * d * (d // groups),
          library=lambda: torch.nn.grad.conv1d_weight(
              xt, (d, d // groups, taps), dyt, groups=groups),
          err=max_err_to_largest("convpos_wgrad bf16", got,
                                 conv_pos.convpos_wgrad_plain(
                                     xp, dyc, taps, groups), 1e-2))
    return out


# rows 1 / 1b in bf16 on the tensor cores (csrc/wgmma.cuh): asr-train's
# 12,288 rows x 256 x 2048 at every activation, and a padded width and D
# 512 (gelu); (rows, D, hidden)
BF16_TC_SHAPES = {"asr": (12288, 256, 2048), "d200": (3000, 200, 800),
                  "d512": (3000, 512, 2048)}
BF16_TC_ACTIVATIONS = ("gelu", "relu", "silu", "tanh")
def _tiled_relu_mask(forward, x, weights, hid, cfg):
    """h > 0 of `forward`'s hidden on its tiled path (forced; the hidden
    read from the wrapper's scratch), the first `hid` columns."""
    import torch
    from simulst_tpu_torch.ops import ffn
    rows, captured, empty = x.shape[0], [], torch.empty

    def capture(*shape, **kw):
        t = empty(*shape, **kw)
        if t.dim() == 2 and t.shape[0] == rows and t.shape[1] >= hid \
                and t.dtype == x.dtype:
            captured.append(t)
        return t
    with patched([(torch, "empty", capture), (ffn, "TILED_MIN_ROWS", 0),
                  (ffn, "BF16_TILED_MIN_ROWS", 0)]):
        forward(x, *weights, *cfg)
    return captured[-1][:, :hid] > 0


def kernel_relu_mask(x, lnw, cfg):
    """(rows, hidden) bool: where the LN-FFN kernels take relu's derivative
    as 1, h > 0 of the tiled forward's hidden (the forward forced onto its
    tiled path, its hidden read from the wrapper's scratch; the backward
    recomputes u with the same products, the same bits).  relu' jumps
    at u = 0, where the kernels' and torch's roundings (LN in fp32, the
    fc1 input rounded to bf16, sums in other orders) fall on either side
    of 0 for some entries, so the plain backward is held to the kernel
    under the kernel's own mask (`plain_ln_ffn_backward_under`)."""
    from simulst_tpu_torch.ops import ffn
    return _tiled_relu_mask(ffn.fused_ln_ffn_res_forward, x, lnw,
                            lnw[2].shape[1], cfg)


def kernel_ffn_relu_mask(x, w, cfg):
    """kernel_relu_mask of the FFN without LN (w = w1, b1, w2, b2): the
    FFN backward recomputes u with the tiled forward's hidden product."""
    from simulst_tpu_torch.ops import ffn
    return _tiled_relu_mask(ffn.fused_ffn_forward, x, w, w[0].shape[1], cfg)


def plain_ln_ffn_backward_under(x, lnw, dy, cfg, mask):
    """ln_ffn_res_plain_backward with relu's derivative taken from `mask`
    (the kernel's: kernel_relu_mask) instead of u > 0."""
    from simulst_tpu_torch.ops import ffn
    with patched([(ffn, "_act_grad", lambda name, u: mask.to(u.dtype))]):
        return ffn.ln_ffn_res_plain_backward(x, *lnw[:5], dy, *cfg)


def plain_ffn_backward_under(x, w, dy, cfg, mask):
    """ffn_plain_backward with relu's derivative taken from `mask` (the
    kernel's: kernel_ffn_relu_mask)."""
    from simulst_tpu_torch.ops import ffn
    with patched([(ffn, "_act_grad", lambda name, u: mask.to(u.dtype))]):
        return ffn.ffn_plain_backward(x, *w[:3], dy, *cfg)


def sass_hgmma():
    """{wgmma kernel: its HGMMA instructions} in the built library's SASS
    (cuobjdump --dump-sass), the HGMMA count of every other kernel (0
    expected), and {grouped attention backward kernel on the tensor cores
    (mma.sync): its HMMA instructions}."""
    import shutil
    import subprocess
    from simulst_tpu_torch.ops import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", str(_build.build())],
                          capture_output=True, text=True, check=True).stdout
    funcs = _build.sass_functions(sass)
    counts = {name: body.count("HGMMA") for name, body in funcs.items()}
    wgmma = {n: c for n, c in counts.items() if "wgmma_product_kernel" in n}
    hmma = {n: body.count("HMMA") for n, body in funcs.items()
            if "grouped_attn_bwd_tc_kernel" in n}
    return wgmma, sum(c for n, c in counts.items() if n not in wgmma), hmma


# the caller tags of the wgmma products: the FFN and linear-res backwards'
# and the linear-res forward's (its bf16 tiled paths)
WGMMA_CALLERS = ("TagFfnBwd", "TagLinearResBwd", "TagLinearResFwd")


def phase_bf16_tensor_cores(dev):
    """Rows 1 / 1b in bf16 through the wrappers (the LN-FFN forward's tiled
    path and its backward on wgmma_product) at BF16_TC_SHAPES, rates 0 and
    0.1: against the plain versions (BF16_TOL; weight and LN gradients
    within 1e-2 of their largest entry; with relu, the plain backward
    under the kernel's relu mask: `kernel_relu_mask`), each
    called twice (the same bits: no atomics, fixed split sums), the
    decoder FFN's forward (the same tiled path) too; rows 2b and 4b
    (`phase_bf16_backwards`); rows 3b / 3bg and 4 (`phase_bf16_attention`);
    the SASS of every wgmma kernel, those of the two backwards and of the
    linear-res forward among them (WGMMA_CALLERS), holds HGMMA, and that
    of the grouped attention's tensor-core backward (its 8
    instantiations) HMMA.  Returns {kernel: largest error}."""
    import torch
    from simulst_tpu_torch.ops import ffn
    bf = torch.bfloat16
    g = torch.Generator().manual_seed(SEED + 53)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    wgmma, elsewhere, hmma = sass_hgmma()
    # rows 2b, 4b and 4's products, named by their callers' tags
    callers = {c: sum(c in n for n in wgmma) for c in WGMMA_CALLERS}
    log("phase20", wgmma_kernels=len(wgmma),
        hgmma_per_kernel=sorted(wgmma.values()), hgmma_elsewhere=elsewhere,
        wgmma_kernels_of=callers, attention_tc_hmma=sorted(hmma.values()))
    if not wgmma or not all(wgmma.values()) or elsewhere or \
            not all(callers.values()):
        raise AssertionError("phase 20: the wgmma kernels' SASS lacks HGMMA "
                             "(or another kernel has it, or a product is "
                             f"not among them: {callers})")
    if len(hmma) != 8 or not all(hmma.values()):
        raise AssertionError("phase 20: the grouped attention's tensor-core "
                             f"backward lacks HMMA: {hmma}")
    errs = {}
    for shape, (rows, d, hid) in BF16_TC_SHAPES.items():
        xav = (6.0 / (d + hid)) ** 0.5
        x, dy = randn(rows, d).to(bf), randn(rows, d).to(bf)
        lnw = (1 + randn(d, scale=0.1), randn(d, scale=0.1),
               randn(d, hid, scale=xav).to(bf), randn(hid, scale=0.02).to(bf),
               randn(hid, d, scale=xav).to(bf), randn(d, scale=0.02).to(bf))
        assert ffn.slice_plan(rows, hid, 132, d, bf).tiled
        for act in BF16_TC_ACTIVATIONS if shape == "asr" else ("gelu",):
            for rate in (0.0, 0.1):
                cfg = (act, rate, rate, 5)
                case = f"{shape} ({rows},{d},{hid}) {act} rate {rate}"
                y = ffn.fused_ln_ffn_res_forward(x, *lnw, *cfg)
                e_f = max_err(f"fused_ln_ffn_res bf16 {case}", y,
                              ffn.ln_ffn_res_plain(x, *lnw, *cfg),
                              **BF16_TOL)
                yd = ffn.fused_ffn_forward(x, *lnw[2:], *cfg)
                e_d = max_err(f"fused_ffn bf16 {case}", yd,
                              ffn.ffn_plain(x, *lnw[2:], *cfg), **BF16_TOL)
                got = ffn.fused_ln_ffn_res_backward(x, *lnw[:5], dy, *cfg)
                want = plain_ln_ffn_backward_under(
                    x, lnw, dy, cfg, kernel_relu_mask(x, lnw, cfg)) \
                    if act == "relu" else \
                    ffn.ln_ffn_res_plain_backward(x, *lnw[:5], dy, *cfg)
                e_b = max([max_err(
                    f"fused_ln_ffn_res_backward bf16 {case} dx", got[0],
                    want[0], **BF16_TOL)] + [max_err_to_largest(
                    f"fused_ln_ffn_res_backward bf16 {case} grad {i}", a, c,
                    1e-2) for i, (a, c) in enumerate(zip(got[1:], want[1:]))])
                again = (ffn.fused_ln_ffn_res_forward(x, *lnw, *cfg),
                         ffn.fused_ffn_forward(x, *lnw[2:], *cfg),
                         *ffn.fused_ln_ffn_res_backward(x, *lnw[:5], dy,
                                                        *cfg))
                same = all(torch.equal(a, c) for a, c in
                           zip((y, yd, *got), again))
                log("phase20", tensor_cores=case, ln_ffn_err=e_f,
                    ffn_err=e_d, ln_ffn_bwd_err=e_b, twice_bit_for_bit=same)
                if not same:
                    raise AssertionError(f"phase 20: {case} gave other bits "
                                         "the second time")
                for k, e in (("fused_ln_ffn_res", e_f), ("fused_ffn", e_d),
                             ("fused_ln_ffn_res_backward", e_b)):
                    errs[k] = max(errs.get(k, 0.0), e)
    for k, e in phase_bf16_backwards(dev, randn).items():
        errs[k] = max(errs.get(k, 0.0), e)
    for k, e in phase_bf16_attention(dev, randn).items():
        errs[k] = max(errs.get(k, 0.0), e)
    return errs


# rows 2b / 4b in bf16 on the tensor cores: the FFN backward at asr-train's
# decoder rows (32 x 72), the linear-res backward at the Emformer
# out-projection's 12,800 rows with its gate (period 200, 192 residual
# rows) and at the decoder's 2,304 ungated; a padded width and D 512 (FFN
# rows, D, hidden; linear-res rows, D, period, residual rows)
BF16_BWD_SHAPES = {
    "asr": ((2304, 256, 2048), ((12800, 256, 200, 192), (2304, 256, 0, 0))),
    "d200": ((3000, 200, 800), ((3000, 200, 200, 192),)),
    "d512": ((3000, 512, 2048), ((3000, 512, 200, 192),))}


def phase_bf16_backwards(dev, randn):
    """Rows 2b and 4b in bf16 through the wrappers (every product on
    wgmma_product) at BF16_BWD_SHAPES, rate 0.1 and, at asr-train's shapes,
    rate 0: against the plain versions (BF16_TOL on dx / dh; weight and
    bias gradients within 1e-2 of their largest entry; the FFN with relu
    under the kernel's relu mask: `kernel_ffn_relu_mask`), the rate 0.1
    cases called twice (the same bits; tests/test_torch_port_cuda.py
    covers every rate at every width).  Returns {kernel: largest
    error}."""
    import torch
    from simulst_tpu_torch.ops import ffn, linear_res
    bf = torch.bfloat16
    errs = {}

    def grads_err(name, got, want):
        return max([max_err(f"{name} d0", got[0], want[0], **BF16_TOL)]
                   + [max_err_to_largest(f"{name} grad {i}", a, c, 1e-2)
                      for i, (a, c) in enumerate(zip(got[1:], want[1:]))])

    def hold(name, case, call, want, twice):
        got = call()
        err = grads_err(f"{name} bf16 {case}", got, want)
        same = all(torch.equal(a, c) for a, c in zip(got, call())) \
            if twice else None
        log("phase20", tensor_cores=f"{name} {case}", err=err,
            twice_bit_for_bit=same)
        if same is False:
            raise AssertionError(f"phase 20: {name} {case} gave other bits "
                                 "the second time")
        errs[name] = max(errs.get(name, 0.0), err)

    for shape, ((rows, d, hid), linear) in BF16_BWD_SHAPES.items():
        xav = (6.0 / (d + hid)) ** 0.5
        x, dy = randn(rows, d).to(bf), randn(rows, d).to(bf)
        w = (randn(d, hid, scale=xav).to(bf), randn(hid, scale=0.02).to(bf),
             randn(hid, d, scale=xav).to(bf), randn(d, scale=0.02).to(bf))
        # silu and tanh: phase_activations holds row 2b's at 12,288 rows
        rates = (0.0, 0.1) if shape == "asr" else (0.1,)
        for act in ("gelu", "relu") if shape == "asr" else ("gelu",):
            for rate in rates:
                cfg = (act, rate, rate, 5)
                want = plain_ffn_backward_under(
                    x, w, dy, cfg, kernel_ffn_relu_mask(x, w, cfg)) \
                    if act == "relu" else \
                    ffn.ffn_plain_backward(x, *w[:3], dy, *cfg)
                hold("fused_ffn_backward",
                     f"{shape} ({rows},{d},{hid}) {act} rate {rate}",
                     lambda: ffn.fused_ffn_backward(x, *w[:3], dy, *cfg),
                     want, rate > 0)
        for n, dl, period, res_rows in linear:
            h, dyl = randn(n, dl).to(bf), randn(n, dl).to(bf)
            wl = randn(dl, dl, scale=dl ** -0.5).to(bf)
            for rate in rates:
                lcfg = (period, res_rows, rate, 7)
                hold("fused_linear_res_backward",
                     f"{shape} ({n},{dl}) period {period} gate {res_rows} "
                     f"rate {rate}",
                     lambda: linear_res.fused_linear_res_backward(
                         h, wl, dyl, *lcfg),
                     linear_res.linear_res_plain_backward(h, wl, dyl, *lcfg),
                     rate > 0)
    return errs


# rows 3b / 3bg in bf16 on the tensor cores: (B, ng, nq, D, heads, G,
# gated) at asr-train's q3, the packed gated shapes of G 7 and G 3, head
# dim 128, a padded head dim (50, staged 64), D 512 with 8 heads and G 16,
# s2t_emformer_s's unit geometry; row 4 in bf16 on the tensor cores:
# (rows, D_in, D_out, period, residual rows) at the Emformer
# out-projection's 12,800 and 3,200 gated rows, the decoders' 8192 and
# 2,304, a padded D_out and D_in
BF16_ATTN_SHAPES = {"asr": (32, 2, 200, 256, 4, 8, False),
                    "packed-G7": (16, 4, 175, 256, 4, 7, True),
                    "packed-G3": (8, 13, 75, 256, 4, 3, True),
                    "hd128": (4, 2, 200, 512, 4, 8, False),
                    "hd50": (4, 2, 200, 200, 4, 8, False),
                    "d512-8heads": (4, 2, 200, 512, 8, 8, False),
                    "G16": (4, 2, 400, 256, 4, 16, False)}
BF16_LR_FWD_SHAPES = {"12800-gate": (12800, 256, 256, 200, 192),
                      "8192": (8192, 256, 256, 0, 0),
                      "2304": (2304, 256, 256, 0, 0),
                      "3200-gate": (3200, 256, 256, 200, 192),
                      "dout200": (3200, 256, 200, 200, 192),
                      "din200": (3200, 200, 256, 200, 192)}


def segment_gate(ea, geom, b, generator, dev):
    """An example-id gate of packed rows on the card: each row's segments
    in runs of ascending example ids, a key row's id its segment's
    (memory slots, rc blocks and frames, nn/emformer.py `_build_kid`'s
    layout)."""
    import torch
    seg_eid = torch.sort(torch.randint(0, 4, (b, geom.n),
                                       generator=generator), dim=1).values
    kid = torch.cat([seg_eid[:, :-1],
                     seg_eid.repeat_interleave(geom.rc, dim=1),
                     seg_eid.repeat_interleave(geom.seg, dim=1)], dim=1)
    return ea.EidGate(kid.to(torch.int32).to(dev),
                      seg_eid.to(torch.int32).to(dev))


def phase_bf16_attention(dev, randn):
    """Rows 3b / 3bg (the grouped attention's backward on the tensor cores,
    `bwd_plan`) at BF16_ATTN_SHAPES and row 4 (the linear-res forward's
    tiled paths on wgmma_product and the epilogue pass) at
    BF16_LR_FWD_SHAPES, in bf16 through the wrappers, rates 0 and 0.1:
    against the plain versions (BF16_TOL on dq and y; dk, dv within 1e-2
    of their largest entry), each called twice (the same bits).  Returns
    {kernel: largest error}."""
    import torch
    from simulst_tpu_torch.ops import emformer_attn as ea
    from simulst_tpu_torch.ops import linear_res
    bf = torch.bfloat16
    g = torch.Generator().manual_seed(SEED + 59)
    errs = {}

    def hold(name, case, call, want):
        got = call()
        err = max([max_err(f"{name} bf16 {case} d0", got[0], want[0],
                           **BF16_TOL)]
                  + [max_err_to_largest(f"{name} bf16 {case} grad {i}", a, c,
                                        1e-2)
                     for i, (a, c) in enumerate(zip(got[1:], want[1:]))])
        same = all(torch.equal(a, c) for a, c in zip(got, call()))
        log("phase20", tensor_cores=f"{name} {case}", err=err,
            twice_bit_for_bit=same)
        if not same:
            raise AssertionError(f"phase 20: {name} {case} gave other bits "
                                 "the second time")
        errs[name] = max(errs.get(name, 0.0), err)

    for shape, (b, ng, nq, d, heads, G, gated) in BF16_ATTN_SHAPES.items():
        geom = ea.AttnGeom(U=ng * G * 16, seg=16, lc=32, rc=8, max_mem=5,
                           G=G, num_heads=heads)
        assert ea.bwd_plan(geom, ea.padded_head_dim(d // heads),
                           bf) == "tensor_cores"
        q3, dout = randn(b, ng, nq, d).to(bf), randn(b, ng, nq, d).to(bf)
        k, v = randn(b, geom.tk, d).to(bf), randn(b, geom.tk, d).to(bf)
        gate = segment_gate(ea, geom, b, g, dev) if gated else None
        lengths = (torch.full((b,), geom.U) if gated else torch.randint(
            geom.U // 2, geom.U + 1, (b,), generator=g)).to(
                torch.int32).to(dev)
        name = ("emformer_grouped_attention_gated_backward" if gated else
                "emformer_grouped_attention_backward")
        for rate in (0.0, 0.1):
            args = (q3, k, v, lengths, dout, geom, rate, 31, gate)
            hold(name, f"{shape} ({b},{ng},{nq},{d}) {heads} heads G {G} "
                 f"rate {rate}",
                 lambda: ea.emformer_grouped_attention_backward(*args),
                 ea.grouped_attention_plain_backward(*args))
    for shape, (rows, din, dout, period, res_rows) in \
            BF16_LR_FWD_SHAPES.items():
        assert linear_res.fwd_uses_tensor_cores(linear_res.fwd_plan(rows), bf)
        h, res = randn(rows, din).to(bf), randn(rows, dout).to(bf)
        w = randn(din, dout, scale=din ** -0.5).to(bf)
        bias = randn(dout, scale=0.02).to(bf)
        for rate in (0.0, 0.1):
            lcfg = (period, res_rows, rate, 7)
            hold("fused_linear_res",
                 f"{shape} ({rows},{din},{dout}) period {period} gate "
                 f"{res_rows} rate {rate}",
                 lambda: (linear_res.fused_linear_res_forward(h, w, bias, res,
                                                              *lcfg),),
                 (linear_res.linear_res_plain(h, w, bias, res, *lcfg),))
    return errs


def one_step_profile(train_step, state, batch, generator):
    """(state, device ms, wall ms, peak GiB) of one train step after a
    warm-up step: the device time summed over the kernels torch.profiler
    records, the peak memory from a reset before the measured step."""
    import torch
    state, _ = train_step(state, batch, generator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, generator)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and kernel_family(e.key) != POSTERIOR_FAMILY) / 1e3
    if not device or not np.isfinite(float(metrics["loss"])):
        raise AssertionError(f"no device time ({device}) or a non-finite "
                             f"loss {float(metrics['loss'])}")
    return state, device, wall, torch.cuda.max_memory_allocated() / 2 ** 30


def grads_of(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def hold_grads(tag, got, want, tol):
    """max over parameters of |got - want| / the largest |want| entry (a
    key bias against its weight's, as grad_scale); raise beyond tol."""
    rel = {n: (got[n] - want[n]).abs().max().item() / grad_scale(want, n)
           for n in want}
    worst = max(rel, key=rel.get)
    if not rel[worst] <= tol:
        raise AssertionError(f"{tag}: gradient of {worst} off by "
                             f"{rel[worst]:.3e} of its largest entry, "
                             f"beyond {tol}")
    return rel[worst], worst


def phase_bf16_train(dev, batch, fp32):
    """asr-train in bf16: phase 8's batch and exp/1a's options with
    --override compute_dtype=bfloat16 through the CLI's config path, 8
    steps (launches per step as phase 8's), 3 profiled steps, beside phase
    8's fp32 numbers `fp32`; one step at dropout 0 with the kernels and with
    the plain versions from the initial parameters (loss finite, every
    gradient within BF16_STEP_TOL of its largest entry); then the same
    step with --override remat=true against it without remat under
    PyTorch's deterministic algorithms, at dropout 0.1 from one seed, both
    peaks printed.  Returns the 8 steps' launches."""
    import torch
    from simulst_tpu_torch.cli import train as cli
    from simulst_tpu_torch.train.state import (create_train_state,
                                               make_accum_train_step,
                                               make_train_step)

    args = cli.parse_args(ASR_ARGS + BF16_OVERRIDE)
    model = cli.build_model(args, ASR_VOCAB, device=dev)
    if model.cfg.compute_dtype != "bfloat16":
        raise AssertionError(f"compute_dtype {model.cfg.compute_dtype}")
    loss_fn = cli.build_loss(args, model)
    optim_cfg = cli.optim_config(args)
    train_step = make_train_step(loss_fn, optim_cfg)
    state = create_train_state(model, optim_cfg)
    initial = copy.deepcopy(state)
    generator = torch.Generator().manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    step_ms, losses = [], []
    for _ in range(ASR_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, generator)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]) / float(metrics["sample_size"]))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    per_step = {k: launches[k] / ASR_STEPS for k in ASR_LAUNCHES_PER_STEP}
    if per_step != ASR_LAUNCHES_PER_STEP:
        raise AssertionError(f"bf16 launches per step {per_step}, expected "
                             f"{ASR_LAUNCHES_PER_STEP}")
    if not all(np.isfinite(losses)) or state.step != ASR_STEPS:
        raise AssertionError(f"bf16 losses {losses}, updates {state.step}")
    summary = {}
    state = profile_steps(state, train_step, batch, generator, "phase20-asr",
                          out=summary)
    log("phase20", cell="asr-train bf16", steps=ASR_STEPS,
        median_step_ms=statistics.median(step_ms[1:]), step_ms=step_ms,
        losses=losses, launches_per_step=per_step, peak_memory_gib=peak,
        device_ms_per_step=summary["device_ms_per_step"],
        busy_share=summary["busy_share"], fp32=fp32,
        bf16_over_fp32={
            "median_step_ms": statistics.median(step_ms[1:]) /
            fp32["median_step_ms"],
            "device_ms_per_step": summary["device_ms_per_step"] /
            fp32["device_ms_per_step"],
            "peak_memory_gib": peak / fp32["peak_memory_gib"]})
    del state

    # kernels vs plain, one step at dropout 0 from the initial parameters
    grad_step, _ = make_accum_train_step(loss_fn, optim_cfg)
    runs = {}
    for use_plain in (False, True):
        st = copy.deepcopy(initial)
        with plain_training() if use_plain else contextlib.nullcontext():
            m = grad_step(st, batch, None)
        runs[use_plain] = (float(m["loss"]), grads_of(st.model))
        del st
    (loss_k, g_k), (loss_p, g_p) = runs[False], runs[True]
    if not (np.isfinite(loss_k) and np.isfinite(loss_p)):
        raise AssertionError(f"bf16 losses {loss_k} / {loss_p}")
    err, worst = hold_grads("asr-train bf16 kernels vs plain", g_k, g_p,
                            BF16_STEP_TOL)
    log("phase20", cell="asr-train bf16 kernels vs plain",
        loss=[loss_k, loss_p], loss_rel=abs(loss_k - loss_p) / abs(loss_p),
        grads_max_err_to_largest=err, worst_param=worst,
        tolerance=BF16_STEP_TOL)

    # remat: the same step with --override remat=true
    remat_args = cli.parse_args(ASR_ARGS + BF16_OVERRIDE +
                                ["--override", "remat=true"])
    remat_model = cli.build_model(remat_args, ASR_VOCAB, device=dev)
    if not remat_model.cfg.emformer.remat:
        raise AssertionError("--override remat=true did not reach the model")
    remat_model.load_state_dict(initial.model.state_dict())
    remat_state = create_train_state(remat_model, optim_cfg)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        outs, ran = {}, {}
        for tag, st in (("no remat", copy.deepcopy(initial)),
                        ("remat", remat_state)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            before = read_launches()
            m = grad_step(st, batch, torch.Generator().manual_seed(SEED + 1))
            torch.cuda.synchronize()
            outs[tag] = (float(m["loss"]), grads_of(st.model),
                         torch.cuda.max_memory_allocated(dev) / 2 ** 30)
            ran[tag] = {k: v - before[k] for k, v in read_launches().items()
                        if v != before[k]}
            del st
    finally:
        torch.use_deterministic_algorithms(was)
    (l0, g0, peak0), (l1, g1, peak1) = outs["no remat"], outs["remat"]
    bitwise = l0 == l1 and all(torch.equal(g0[n], g1[n]) for n in g0)
    err, worst = hold_grads("asr-train bf16 remat vs no remat", g1, g0,
                            0.0 if bitwise else BF16_STEP_TOL)
    log("phase20", cell="asr-train bf16 remat", dropout=0.1,
        deterministic_algorithms=True, bit_for_bit=bitwise,
        grads_max_err_to_largest=err, worst_param=worst, loss=[l0, l1],
        peak_memory_gib={"no remat": peak0, "remat": peak1},
        remat_over_no_remat=peak1 / peak0,
        launches=ran)   # remat recomputes: the encoder's forwards twice
    return launches


def phase_bf16_serve(dev, speech, fp32_tokens):
    """s2t_emformer_s in bf16 (phase 3's seed, so phase 3's weights):
    the streaming session at B = 1 on the first utterance (encoder step +
    a greedy decoder step per chunk, both in bf16) against the bf16
    offline encoder output (BF16_STREAM_ATOL); the offline batch at beam
    5, ms per batch, its tokens against phase 3's fp32 tokens."""
    import torch
    from simulst_tpu_torch.cli.generate import decode_batch
    from simulst_tpu_torch.decode.beam import BeamConfig
    from simulst_tpu_torch.models import s2t_emformer as s2t
    from simulst_tpu_torch.nn import transformer as tfm

    cfg = s2t.S2TEmformerConfig(compute_dtype="bfloat16")
    model = s2t.S2TEmformerModel(
        cfg, generator=torch.Generator().manual_seed(SEED), device=dev)
    model.eval()
    feats, lengths = speech["feats"], speech["feat_lengths"]
    beam_cfg = BeamConfig(beam_size=BEAM, max_len=MAX_LEN)
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens, tok_lengths = decode_batch(model, speech, beam_cfg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    same = (tokens == fp32_tokens).float().mean().item()

    ecfg = cfg.emformer
    first = (ecfg.segment + ecfg.right_context) * cfg.stride
    steady = ecfg.segment * cfg.stride
    plan = [first] + [steady] * ((N_FRAMES - first) // steady)
    plan.append(N_FRAMES - sum(plan))
    stepper = s2t.make_encoder_stepper(model.encoder, cfg)
    state = s2t.encoder_init_state(model.encoder, cfg, 1, device=dev)
    dstate = tfm.decoder_init_state(cfg.decoder, 1, MAX_LEN, device=dev)
    if state.carry.dtype != torch.bfloat16 or \
            dstate.caches[0].k.dtype != torch.bfloat16:
        raise AssertionError("the bf16 session's state is not bf16")
    token = torch.full((1,), cfg.eos_idx, dtype=torch.int64, device=dev)
    outs, chunk_ms, t = [], [], 0
    for i, c in enumerate(plan):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, state = stepper(state, feats[:1, t:t + c],
                             finish=i == len(plan) - 1)
        outs.append(out.encoder_out)
        enc = torch.cat(outs, dim=1)
        valid = torch.ones(1, enc.shape[1], dtype=torch.bool, device=dev)
        logits, dstate = tfm.decoder_step(model.decoder, cfg.decoder, dstate,
                                          token, enc, valid)
        token = logits.argmax(dim=-1)
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
        t += c
    stream = torch.cat(outs, dim=1)
    off = s2t.encoder_forward(model.encoder, cfg, feats[:1], lengths[:1])
    if stream.dtype != torch.bfloat16 or logits.dtype != torch.bfloat16:
        raise AssertionError(f"streaming dtypes {stream.dtype} / "
                             f"{logits.dtype}")
    err = max_err("bf16 streaming vs offline encoder output", stream,
                  off.encoder_out, atol=BF16_STREAM_ATOL, rtol=0.0)
    log("phase20", cell="serving bf16", beam=BEAM, ms_per_batch=times,
        token_lengths=tok_lengths.tolist(),
        tokens_equal_to_fp32_share=same,
        tokens_equal_to_fp32_rows=[bool(r) for r in
                                   (tokens == fp32_tokens).all(1).tolist()],
        median_ms_per_chunk=statistics.median(chunk_ms),
        streaming_vs_offline_max_abs_err=err, tolerance=BF16_STREAM_ATOL)


def phase_bf16_students(dev, batch):
    """One bf16 train step each of MMA (exp/2's options), CIF (exp/3's)
    and the transducer (exp/6's, on TRANSDUCER_UTT utterances), built
    through the CLI with --override compute_dtype=bfloat16, beside the
    same model's fp32 step (its config switched back, the same weights):
    device ms and peak memory of one step after a warm-up step."""
    import torch
    from simulst_tpu_torch.cli import train as cli
    from simulst_tpu_torch.train.state import (create_train_state,
                                               make_train_step)
    for name, argv, rows in (("mma", MMA_ARGS, ASR_UTT),
                             ("cif", CIF_ARGS, ASR_UTT),
                             ("transducer", TRANSDUCER_ARGS,
                              TRANSDUCER_UTT)):
        args = cli.parse_args(argv + BF16_OVERRIDE)
        model = cli.build_model(args, ASR_VOCAB, device=dev)
        loss_fn = cli.build_loss(args, model)
        optim_cfg = cli.optim_config(args)
        sub = {k: v[:rows] for k, v in batch.items()}
        cells = {}
        for dtype in ("bfloat16", "float32"):
            model.cfg = dataclasses.replace(model.cfg, compute_dtype=dtype)
            state = create_train_state(model, optim_cfg)
            _, device, wall, peak = one_step_profile(
                make_train_step(loss_fn, optim_cfg), state, sub,
                torch.Generator().manual_seed(SEED))
            cells[dtype] = dict(device_ms=device, wall_ms=wall,
                                peak_memory_gib=peak)
            del state
        log("phase20", cell=f"{name}-train", utterances=rows, **cells,
            bf16_over_fp32={k: cells["bfloat16"][k] / cells["float32"][k]
                            for k in cells["float32"]})
        del model


def phase_variants(dev, batch):
    """The model options at full width, one forward and backward each with
    the kernels against the plain versions (fp32, dropout 0; the output
    atol 1e-4, every gradient within 1e-4 of its largest entry): a
    VARIANT_LAYERS-layer Emformer post-LN and with silu, on asr-train's
    32 x 256 frames; a 2-layer post-LN decoder on its targets over that encoder
    output; the VGG frontend (F.conv2d, no kernel of the port) on the
    card against the CPU on two utterances (atol 1e-4)."""
    import torch
    from simulst_tpu_torch.nn import conv as cnv
    from simulst_tpu_torch.nn import emformer as emf
    from simulst_tpu_torch.nn import transformer as tfm
    g = torch.Generator().manual_seed(SEED + 41)
    lengths = subsampled(batch["feat_lengths"])
    u = int(lengths.max())
    nodrop = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
    x = (torch.randn(ASR_UTT, u + 8, 256, generator=g)).to(dev)
    valid = (torch.arange(u, device=dev)[None] < lengths[:, None])[..., None]
    wts = torch.randn(ASR_UTT, u, 256, generator=g).to(dev) * valid

    def run_twice(model, fn):
        outs = []
        for use_plain in (False, True):
            model.zero_grad()
            with plain_training() if use_plain else contextlib.nullcontext():
                with torch.enable_grad():
                    y = fn()
                    (y.float() * wts[:, :y.shape[1]]).sum().backward() \
                        if y.dim() == 3 and y.shape[-1] == 256 else \
                        y.float().sum().backward()
            outs.append((y.detach(), {n: p.grad.clone() for n, p in
                                      model.named_parameters()
                                      if p.grad is not None}))
        (y_k, g_k), (y_p, g_p) = outs
        return max_err("variant output", y_k, y_p, **F32_TOL), g_k, g_p

    results = {}
    for name, over in (("post-LN", dict(normalize_before=False)),
                       ("silu", dict(activation="silu"))):
        cfg = emf.EmformerConfig(num_layers=VARIANT_LAYERS, **nodrop, **over)
        model = emf.Emformer(cfg, generator=torch.Generator().manual_seed(
            SEED)).to(dev)
        before = read_launches()
        err, g_k, g_p = run_twice(model, lambda: emf.emformer_forward(
            model, cfg, x, lengths))
        ran = {k: v - before[k] for k, v in read_launches().items()
               if v != before[k]}
        gerr, worst = hold_grads(f"{name} Emformer", g_k, g_p, 1e-4)
        results[name] = dict(layers=VARIANT_LAYERS, output_max_abs_err=err,
                             grads_max_err_to_largest=gerr, worst=worst,
                             launches=ran)
        if dev.type == "cuda" and not ran.get("fused_ln_ffn_res_backward"):
            raise AssertionError(f"{name}: the LN-FFN kernels did not run")
        del model
    dcfg = tfm.DecoderConfig(vocab_size=ASR_VOCAB, num_layers=2,
                             normalize_before=False, **nodrop)
    dec = tfm.Decoder(dcfg, generator=torch.Generator().manual_seed(SEED),
                      device=dev)
    enc = torch.randn(ASR_UTT, u, 256, generator=g).to(dev)
    err, g_k, g_p = run_twice(dec, lambda: tfm.decoder_forward(
        dec, dcfg, batch["prev_tokens"], enc, valid[..., 0]))
    gerr, worst = hold_grads("post-LN decoder", g_k, g_p, 1e-4)
    results["post-LN decoder"] = dict(layers=2, output_max_abs_err=err,
                                      grads_max_err_to_largest=gerr,
                                      worst=worst)
    del dec
    vgg = cnv.VGGBlock(80, 1, 256, 256, generator=torch.Generator()
                       .manual_seed(SEED)).to(dev)
    feats = batch["feats"][:2, :256].contiguous()
    with torch.enable_grad():
        fx = feats.clone().requires_grad_()
        y, out_len = cnv.vgg_block_apply(vgg, fx, batch["feat_lengths"][:2])
        y.square().sum().backward()
    vgg_cpu = copy.deepcopy(vgg).cpu()
    with torch.enable_grad():
        fc = feats.cpu().clone().requires_grad_()
        yc, _ = cnv.vgg_block_apply(vgg_cpu, fc, batch["feat_lengths"][:2]
                                    .cpu())
        yc.square().sum().backward()
    results["VGG"] = dict(
        shape=list(y.shape), out_lengths=out_len.tolist(),
        output_max_abs_err=max_err("VGG card vs CPU", y, yc.to(dev),
                                   **F32_TOL),
        input_grad_max_err_to_largest=max_err_to_largest(
            "VGG input gradient card vs CPU", fx.grad, fc.grad.to(dev)))
    log("phase20", variants=results)


def phase_bf16(dev, batch, speech, fp32_tokens, fp32_asr):
    """Phase 20: the new FFN activations, rows 1-6 in bf16, asr-train in
    bf16 (the main path: its launches are returned) with remat, serving,
    the students' steps and the model options.  Returns (the bf16
    asr-train steps' launches, {kernel: report fields})."""
    import torch
    t0 = time.perf_counter()
    parts_s, last = {}, [t0]

    def part(name):
        now = time.perf_counter()
        parts_s[name], last[0] = now - last[0], now
    with torch.no_grad():
        activations = phase_activations(dev)
        part("activations")
        tensor_cores = phase_bf16_tensor_cores(dev)
        part("tensor_cores")
        bf16 = phase_bf16_kernels(dev, batch)
        part("kernels")
    for name, err in tensor_cores.items():
        bf16[name]["tensor_core_max_abs_err"] = err
    launches = phase_bf16_train(dev, batch, fp32_asr)
    part("train")
    with torch.no_grad():   # as cli/generate and the agents serve
        phase_bf16_serve(dev, speech, fp32_tokens)
    part("serve")
    phase_bf16_students(dev, batch)
    part("students")
    phase_variants(dev, batch)
    part("variants")
    report = {name: {"activations": activations.get(name),
                     "bf16": bf16.get(name)}
              for name in set(activations) | set(bf16)}
    log("phase20", phase_s=time.perf_counter() - t0, parts_s=parts_s)
    return launches, report


PARALLEL_RANKS = 2
PARALLEL_SEQ_SEGMENTS = 8          # per rank: U 256 on the 1024-frame bucket
PARALLEL_SERVE_SESSIONS = 8
PARALLEL_SERVE_EOS_SCALE = 0.1     # as phase 15's CIF: a random model writes
PARALLEL_UPDATE_RTOL = 1e-4        # an update's loss and norm, full width


def parallel_launches_ok(tag, launches, kernels):
    missing = [k for k in kernels if not launches.get(k)]
    if missing:
        raise AssertionError(f"{tag}: {missing} did not launch: {launches}")


def phase_parallel(dev, batch):
    """21. Two ranks: the dry run's cases, then the full-width
    data-parallel, tensor-parallel, pipelined and seq-sharded training
    paths and sharded CIF serving, each against the one-process path on
    rank 0 (simulst_tpu_torch/multichip.py).  Returns the kernel launches
    of every rank and case, summed."""
    import torch
    from simulst_tpu_torch import multichip as mc
    from simulst_tpu_torch.models.cif import CIFConfig
    from simulst_tpu_torch.models.s2t_emformer import S2TEmformerConfig
    from simulst_tpu_torch import comm

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    backend = ("nccl" if cards >= PARALLEL_RANKS else
               "gloo: the ranks share one card, collectives staged through "
               "the host")
    print(f"phase21 parallel: {PARALLEL_RANKS} ranks, {cards} card(s), "
          f"backend {backend}", flush=True)
    no_drop = dict(dropout=0.0, attention_dropout=0.0,
                   activation_dropout=0.0)
    cfg = S2TEmformerConfig(vocab_size=ASR_VOCAB, ctc_layer=True, **no_drop)
    ecfg = cfg.emformer
    asr = {k: v.cpu().numpy() for k, v in batch.items()}
    piped = {"feats": asr["feats"], "lengths": asr["feat_lengths"],
             "prev": asr["prev_tokens"], "target": asr["target"]}
    U = PARALLEL_RANKS * PARALLEL_SEQ_SEGMENTS * ecfg.segment
    rs = np.random.RandomState(SEED + 21)
    lengths = np.minimum(subsampled(asr["feat_lengths"]), U)
    x = rs.randn(len(lengths), U + ecfg.right_context,
                 cfg.embed_dim).astype(np.float32)
    valid = np.arange(U)[None, :] < lengths[:, None]
    x[:, :U] *= valid[:, :, None]
    w = rs.randn(len(lengths), U, cfg.embed_dim).astype(np.float32)
    w *= valid[:, :, None]
    scfg = CIFConfig(**no_drop)
    torch.cuda.empty_cache()          # the ranks share this card
    with tempfile.TemporaryDirectory() as root:
        cases = [
            ("dryrun", "dryrun_rank",
             {"data": mc.dryrun_data(root, PARALLEL_RANKS)}),
            ("dp", "train_steps", dict(cfg=cfg, params=None, batch=asr)),
            ("tp", "train_steps", dict(cfg=cfg, params=None, batch=asr,
                                       n_data=1, n_model=PARALLEL_RANKS)),
            ("pp", "pipeline_train", dict(cfg=cfg, params=None, batch=piped,
                                          n_micro=2)),
            ("sp", "seq_sharded", dict(ecfg=ecfg, params=None, x=x,
                                       lengths=lengths, weight=w)),
            ("serve", "sharded_streaming", dict(
                kind="cif", cfg=scfg, params=None,
                chunks=mc.streaming_chunks(scfg, PARALLEL_SERVE_SESSIONS,
                                           n_mid=6),
                max_tokens=64, eos_scale=PARALLEL_SERVE_EOS_SCALE))]
        t0 = time.perf_counter()
        ranks = comm.spawn(mc.run_cases, PARALLEL_RANKS, (cases,),
                           dev.type)
        spawn_s = time.perf_counter() - t0
    for line in ranks[0]["dryrun"]["lines"]:
        print(f"phase21 dryrun {line}", flush=True)
    first = ranks[0]
    lines = []
    # data parallel: 16 utterances per rank; tensor parallel: the whole
    # batch on both model ranks, the slices' gradients gathered
    for tag in ("dp", "tp"):
        mc.check(f"{tag} loss", abs(first[tag]["loss"] /
                                    first[tag]["ref_loss"] - 1), 1e-5, lines)
        mc.check_grads(f"{tag} gradients", first[tag], 1e-4, lines)
        for r in ranks[1:]:
            for k, v in first[tag]["params"].items():
                if not np.array_equal(r[tag]["params"][k], v):
                    raise AssertionError(f"{tag}: rank {r[tag]['rank']}'s "
                                         f"{k} differs from rank 0's")
        mc.check_updates(first[tag], [0.0], lines, tag,
                         rtol=PARALLEL_UPDATE_RTOL)
    for r in ranks:
        per_rank = {k: r["dp"]["launches"].get(k)
                    for k in ASR_LAUNCHES_PER_STEP}
        if per_rank != ASR_LAUNCHES_PER_STEP:
            raise AssertionError(f"dp rank {r['dp']['rank']} launches "
                                 f"{per_rank}, expected "
                                 f"{ASR_LAUNCHES_PER_STEP}")
    # pipeline: 6 layers a stage, 2 microbatches of 16
    pp = first["pp"]
    mc.check("pp loss", abs(pp["loss"] / pp["ref_loss"] - 1), 1e-5, lines)
    mc.check_grads("pp gradients", pp, 1e-4, lines)
    mc.check_updates(dict(history=[pp["update"]],
                          ref_history=[pp["ref_update"]],
                          params=pp["params"], ref_params=pp["ref_params"]),
                     [0.0], lines, "pp", rtol=PARALLEL_UPDATE_RTOL)
    stage_kernels = ("fused_ln_ffn_res", "fused_ln_ffn_res_backward",
                     "emformer_grouped_attention",
                     "emformer_grouped_attention_backward")
    parallel_launches_ok("pp stage 0", ranks[0]["pp"]["launches"],
                         stage_kernels + ("convpos_wgrad",))
    parallel_launches_ok("pp stage 1", ranks[1]["pp"]["launches"],
                         stage_kernels + ("fused_mha", "fused_ffn",
                                          "ctc_alphas", "ctc_d_em"))
    # seq-sharded encoder
    sp = first["sp"]
    mc.check("sp output", mc.rel_err(sp["out"], sp["ref_out"]), 1e-4, lines)
    mc.check_grads("sp gradients", sp, 1e-4, lines)
    # sharded serving
    serve = first["serve"]
    if not (np.array_equal(serve["tokens"], serve["ref_tokens"]) and
            np.array_equal(serve["n_tokens"], serve["ref_n_tokens"])):
        raise AssertionError("sharded CIF serving tokens differ from the "
                             "one-process batch's")
    if serve["n_tokens"].sum() == 0:
        raise AssertionError("sharded CIF serving wrote no token")
    for r in ranks:
        parallel_launches_ok(f"rank {r['dp']['rank']} tp",
                             r["tp"]["update_launches"],
                             [k for k, n in ASR_LAUNCHES_PER_STEP.items()
                              if n])
        parallel_launches_ok(f"rank {r['dp']['rank']} sp",
                             r["sp"]["launches"],
                             ("fused_ln_ffn_res", "fused_ln_ffn_res_backward"))
        parallel_launches_ok(f"rank {r['dp']['rank']} serve",
                             r["serve"]["launches"],
                             ("fused_ln_ffn_res", "fused_ffn",
                              "cif_integrate"))
    launches = defaultdict(int)
    for r in ranks:
        for res in r.values():
            for key in ("launches", "update_launches", "train_launches",
                        "seq_launches"):
                for k, v in (res.get(key) or {}).items():
                    launches[k] += v
    log("phase21", ranks=PARALLEL_RANKS, cards=cards, backend=backend,
        gpu=gpu_name_and_power_limit(), checks=lines,
        dryrun_checks=ranks[0]["dryrun"]["lines"],
        case_s={name: res.get("s") for name, res in first.items()
                if isinstance(res, dict) and "s" in res},
        serve_tokens=int(serve["n_tokens"].sum()), spawn_s=spawn_s,
        phase_s=time.perf_counter() - t_phase,
        launches={k: v for k, v in launches.items() if v})
    return {name: launches.get(name, 0) for name in KERNELS}


# ---------------------------------------------------------------------------
# 22. widths
# ---------------------------------------------------------------------------
# (D, heads, hidden) at the corners of the widths the kernels take: head
# dims 16, 32, 64, 128 and 128, hidden up to 4096
WIDTH_CORNERS = ((64, 4, 256), (128, 4, 512), (512, 8, 2048),
                 (512, 4, 2048), (1024, 8, 4096),
                 # above the old maxima (D 1024, head dim 128): D 1280 and
                 # 2048, head dims 160 and 256 (the LN row passes walking
                 # each row, the wide attention kernels)
                 (1280, 8, 2560), (2048, 8, 2048))
# (D, conv_pos_groups): 4, 64 and 1 channels a group, and 96 and 128 above
# the old maximum of 64
WIDTH_CONVPOS = ((64, 16), (1024, 16), (256, 256), (1536, 16),
                 (2048, 16))
# widths the kernels take zero-padded (the wrappers pad them to the next
# width a kernel takes and pass the real width beside it): (D, heads,
# hidden), D 16 / 32 / 48 / 200, hidden 32 / 48 / 100 / 800, head dims 4,
# 8, 12, 50 and 100; fp32, and bf16 at PADDED_BF16
PADDED_CORNERS = ((16, 4, 32), (16, 2, 48), (32, 4, 100), (48, 4, 48),
                  (200, 4, 800), (200, 2, 100))
PADDED_BF16 = (200, 4, 800)
# (D_in, D_out) of the linear-res at the padded widths, bf16 at the first
PADDED_LINEAR = ((48, 200), (16, 16), (16, 48), (200, 16), (200, 200))
# (D, conv_pos_groups): 2, 3, 6 and 50 channels a group, bf16 at the last
PADDED_CONVPOS = ((32, 16), (48, 16), (96, 16), (800, 16))
# (D, heads, hidden, conv_pos_groups) of the timed widths: D 512 (8 heads
# of 64, FFN 2048, 32 channels a group), JAX's 16-wide dry-run model (4
# heads of 4, FFN 32, 2 channels) and D 200 (4 heads of 50, FFN 800, 50
# channels)
WIDTH_TIMED = {"d512": (512, 8, 2048, 16), "d16": (16, 4, 32, 8),
               "d200": (200, 4, 800, 4)}
# the corners' training rows: the offline encoder's 8 x 384 LN-FFN rows
# (the tiled forward), and a decoder step's 40; the attentions' batches
WIDTH_ROWS = {"train": 8 * (8 * 16 + 256), "decode": 40}
WIDTH_BATCH = 8
WIDTH_MODEL = ["--override", "embed_dim=512", "--override",
               "encoder_heads=8", "--override", "decoder_heads=8",
               "--override", "ffn_dim=2048", "--override",
               "decoder_ffn_dim=2048"]
WIDTH_KERNELS = ("fused_ln_ffn_res", "fused_ln_ffn_res_backward",
                 "fused_ffn", "fused_ffn_backward", "fused_mha",
                 "fused_mha_backward", "emformer_grouped_attention",
                 "emformer_grouped_attention_backward", "fused_linear_res",
                 "fused_linear_res_backward", "convpos_wgrad")
# the kernel convergence trajectory (exp/kernel_convergence_check.py)
TRAJ_B, TRAJ_T, TRAJ_U, TRAJ_VOCAB, TRAJ_STEPS = 8, 1024, 24, 128, 30
SCORE_MARGIN = 40.0    # JAX's SCORE_CLAMP / 2


def width_geoms():
    """kind -> (batch, AttnGeom without its heads) of the grouped
    attention: asr-train's 1024-frame geometry, and one streaming
    segment's."""
    from simulst_tpu_torch.ops import emformer_attn as ea
    return {"train": (WIDTH_BATCH, dict(U=256, seg=16, lc=32, rc=8,
                                        max_mem=5, G=8)),
            "decode": (1, dict(U=16, seg=16, lc=32, rc=8, max_mem=5, G=1))}


def phase_width_kernels(dev, padded=False):
    """Rows 1-6 against their plain versions on the card at the corners of
    the widths the kernels take (WIDTH_CORNERS, WIDTH_CONVPOS), at
    training rows (WIDTH_ROWS, 8 utterances of the ASR shapes) and decode
    rows, fp32 and bf16, dropout 0 and 0.1, forward
    and backward: fp32 atol 1e-4, gradients within 1e-4 of their largest
    entry; bf16 BF16_TOL, gradients within 1e-2 of their largest entry (as
    phase 20).  padded: the widths the wrappers pad (PADDED_CORNERS,
    PADDED_LINEAR, PADDED_CONVPOS), fp32 and one bf16 case per row, the
    grouped attention also with the example-id gate (rows 3g / 3bg), each
    wrapper's launches counted.  Returns the largest error per kernel."""
    import torch
    from simulst_tpu_torch.ops import conv_pos, ffn, linear_res, mha
    from simulst_tpu_torch.ops import emformer_attn as ea
    g = torch.Generator().manual_seed(SEED + 41)
    errs, corner = {}, {}

    def randn(dtype, *shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev).to(dtype)

    def hold(name, got, want, dtype, grads=()):
        """got / want: tuples; the entries named in `grads` are weight
        gradients (held to their largest entry)."""
        f32 = dtype == torch.float32
        err = 0.0
        for i, (a, b) in enumerate(zip(got, want)):
            tag = f"{name} output {i}"
            if i in grads:
                err = max(err, max_err_to_largest(tag, a, b,
                                                  1e-4 if f32 else 1e-2))
            else:
                err = max(err, max_err(tag, a, b,
                                       **(F32_TOL if f32 else BF16_TOL)))
        key = name.split(" ")[0]
        for table in (errs, corner):
            table[key] = max(table.get(key, 0.0), err)
        return err

    from simulst_tpu_torch.nn.emformer import EmformerConfig, make_packed_eids
    corners = PADDED_CORNERS if padded else WIDTH_CORNERS
    before = read_launches()
    for d, heads, hid in corners:
        for dtype in (torch.float32, torch.bfloat16):
            if padded and dtype != torch.float32 and \
                    (d, heads, hid) != PADDED_BF16:
                continue
            dt = str(dtype)[6:]
            corner.clear()
            xav = (6.0 / (d + hid)) ** 0.5
            lnw = (1 + randn(torch.float32, d, scale=0.1),
                   randn(torch.float32, d, scale=0.1),
                   randn(dtype, d, hid, scale=xav),
                   randn(dtype, hid, scale=0.02),
                   randn(dtype, hid, d, scale=xav),
                   randn(dtype, d, scale=0.02))
            for kind, rows in WIDTH_ROWS.items():
                x, dy = randn(dtype, rows, d), randn(dtype, rows, d)
                for rate in (0.0, 0.1):
                    cfg = ("gelu", rate, rate, 17)
                    case = f"D {d} hidden {hid} {kind} {rows} rows {dt} " \
                           f"rate {rate}"
                    hold(f"fused_ln_ffn_res {case}", (
                        ffn.fused_ln_ffn_res_forward(x, *lnw, *cfg),),
                        (ffn.ln_ffn_res_plain(x, *lnw, *cfg),), dtype)
                    hold(f"fused_ln_ffn_res_backward {case}",
                         ffn.fused_ln_ffn_res_backward(x, *lnw[:5], dy, *cfg),
                         ffn.ln_ffn_res_plain_backward(x, *lnw[:5], dy,
                                                       *cfg),
                         dtype, grads=range(1, 7))
                    hold(f"fused_ffn {case}", (
                        ffn.fused_ffn_forward(x, *lnw[2:], *cfg),),
                        (ffn.ffn_plain(x, *lnw[2:], *cfg),), dtype)
                    hold(f"fused_ffn_backward {case}",
                         ffn.fused_ffn_backward(x, *lnw[2:5], dy, *cfg),
                         ffn.ffn_plain_backward(x, *lnw[2:5], dy, *cfg),
                         dtype, grads=range(1, 5))
                if padded:      # the linear-res: PADDED_LINEAR below
                    continue
                # the attention out-projection's linear-res (rows 4 / 4b)
                w, bias = randn(dtype, d, d, scale=d ** -0.5), \
                    randn(dtype, d, scale=0.02)
                res = randn(dtype, rows, d)
                hold(f"fused_linear_res D {d} {kind} {dt}", (
                    linear_res.fused_linear_res_forward(
                        x, w, bias, res, 0, 0, 0.1, 7),),
                    (linear_res.linear_res_plain(x, w, bias, res, 0, 0, 0.1,
                                                 7),), dtype)
                hold(f"fused_linear_res_backward D {d} {kind} {dt}",
                     linear_res.fused_linear_res_backward(x, w, dy, 0, 0,
                                                          0.1, 7),
                     linear_res.linear_res_plain_backward(x, w, dy, 0, 0,
                                                          0.1, 7),
                     dtype, grads=(1, 2))
            # fused_mha: the decoder's causal self- and cross-attention at
            # the ASR decoder's shapes, and the decoder step's
            for b, tq, tk, causal in ((WIDTH_BATCH, 72, 72, True),
                                      (WIDTH_BATCH, 72, 256, False),
                                      (40, 1, 256, False)):
                q, do = randn(dtype, b, tq, d), randn(dtype, b, tq, d)
                k, v = randn(dtype, b, tk, d), randn(dtype, b, tk, d)
                lengths = torch.randint(tk // 2, tk + 1, (b,), generator=g)
                kmask = (torch.arange(tk)[None] < lengths[:, None]).to(
                    torch.int32).to(dev)
                for rate in (0.0, 0.1) if tq > 1 else (0.0,):
                    case = (f"head dim {d // heads} ({b},{tq},{tk}) {dt} "
                            f"rate {rate}")
                    out, lse = mha.fused_mha_forward(q, k, v, kmask, heads,
                                                     causal, rate, 9)
                    hold(f"fused_mha {case}", (out,), (mha.mha_plain(
                        q, k, v, kmask, heads, causal, rate, 9),), dtype)
                    hold(f"fused_mha_backward {case}",
                         mha.fused_mha_backward(q, k, v, kmask, out, lse, do,
                                                heads, causal, rate, 9),
                         mha.mha_plain_backward(q, k, v, kmask, do, heads,
                                                causal, rate, 9), dtype)
            # the grouped attention at asr-train's and a streaming
            # segment's geometry
            for kind, (b, gd) in width_geoms().items():
                geom = ea.AttnGeom(**gd, num_heads=heads)
                q3 = randn(dtype, b, geom.ng, geom.nq, d)
                do = randn(dtype, b, geom.ng, geom.nq, d)
                k, v = randn(dtype, b, geom.tk, d), randn(dtype, b, geom.tk,
                                                          d)
                lengths = torch.full((b,), geom.U, dtype=torch.int32,
                                     device=dev)
                lengths[0] = geom.U - 5
                args = (q3, k, v, lengths)
                # rows 3g / 3bg: two examples packed into each row
                gates = (None,)
                if padded and kind == "train":
                    ecfg = EmformerConfig(right_context=gd["rc"],
                                          max_memory=gd["max_mem"])
                    seg_eid = (torch.arange(geom.n, device=dev)
                               >= geom.n // 2).to(torch.int32)
                    frame_eid = seg_eid.repeat_interleave(geom.seg)
                    eids = make_packed_eids(ecfg, frame_eid[None].expand(
                        b, -1), seg_eid[None].expand(b, -1))
                    gates += (ea.EidGate(eids.kid.contiguous(),
                                         eids.seg_eid.contiguous()),)
                for rate in (0.0, 0.1):
                    for gate in gates:
                        case = (f"head dim {d // heads} {kind} {dt} rate "
                                f"{rate}{'' if gate is None else ' gated'}")
                        hold(f"emformer_grouped_attention {case}", (
                            ea.emformer_grouped_attention_forward(
                                *args, geom, rate, 23, gate),),
                            (ea.grouped_attention_plain(*args, geom, rate,
                                                        23, gate),), dtype)
                        hold(f"emformer_grouped_attention_backward {case}",
                             ea.emformer_grouped_attention_backward(
                                 *args, do, geom, rate, 23, gate),
                             ea.grouped_attention_plain_backward(
                                 *args, do, geom, rate, 23, gate), dtype)
            torch.cuda.synchronize()
            log("phase22", corner=f"D {d} heads {heads} hidden {hid} {dt}",
                max_abs_err=dict(corner))
    for din, dout in PADDED_LINEAR if padded else ():
        for dtype in (torch.float32, torch.bfloat16):
            if dtype != torch.float32 and (din, dout) != PADDED_LINEAR[0]:
                continue
            dt = str(dtype)[6:]
            w, bias = randn(dtype, din, dout, scale=din ** -0.5), \
                randn(dtype, dout, scale=0.02)
            for kind, rows in WIDTH_ROWS.items():
                h = randn(dtype, rows, din)
                res, dy = randn(dtype, rows, dout), randn(dtype, rows, dout)
                for cfg in ((0, 0, 0.0, 7), (200, 192, 0.1, 7)):
                    case = f"D_in {din} D_out {dout} {kind} {dt} rate {cfg[2]}"
                    hold(f"fused_linear_res {case}", (
                        linear_res.fused_linear_res_forward(h, w, bias, res,
                                                            *cfg),),
                        (linear_res.linear_res_plain(h, w, bias, res,
                                                     *cfg),), dtype)
                    hold(f"fused_linear_res_backward {case}",
                         linear_res.fused_linear_res_backward(h, w, dy, *cfg),
                         linear_res.linear_res_plain_backward(h, w, dy,
                                                              *cfg),
                         dtype, grads=(1, 2))
    for d, groups in PADDED_CONVPOS if padded else WIDTH_CONVPOS:
        for dtype in (torch.float32, torch.bfloat16):
            if padded and dtype != torch.float32 and \
                    (d, groups) != PADDED_CONVPOS[-1]:
                continue
            for b, t in ((ASR_UTT, 256), (3, 50)):
                xp, dyc = randn(dtype, b, t + 63, d), randn(dtype, b, t, d)
                hold(f"convpos_wgrad {d // groups} channels ({b},{t}) "
                     f"{str(dtype)[6:]}",
                     (conv_pos.convpos_wgrad(xp, dyc, 64, groups),),
                     (conv_pos.convpos_wgrad_plain(xp, dyc, 64, groups),),
                     dtype, grads=(0,))
    torch.cuda.synchronize()
    after = read_launches()
    launched = {k: after[k] - before[k] for k in WIDTH_KERNELS + (
        "emformer_grouped_attention_gated",
        "emformer_grouped_attention_gated_backward")}
    log("phase22", padded=padded, corners=[f"D {d} heads {h} hidden {f}"
                                           for d, h, f in corners],
        convpos_channels=[d // gr for d, gr in (
            PADDED_CONVPOS if padded else WIDTH_CONVPOS)],
        linear_res=list(PADDED_LINEAR) if padded else "D x D",
        max_abs_err=errs, launches=launched)
    missing = [k for k, n in launched.items() if not n and (
        padded or "gated" not in k)]
    if missing:
        raise AssertionError(f"phase 22: {missing} did not launch at "
                             f"{'the padded ' if padded else ''}widths")
    return errs


def phase_width_times(dev, batch, key="d512"):
    """Rows 1-6 at one of WIDTH_TIMED's widths (D 512, 8 heads, hidden
    2048 by default) on asr-train's 32 x 1024-frame shapes, fp32, rate
    0.1: CUDA-event ms of each kernel (through its wrapper, the padding of
    a padded width included), its bound (on the real widths), its plain
    version's ms and the one PyTorch call of the same work (SDPA, the
    products through torch.matmul with TF32 off, conv1d_weight).  Returns
    {kernel: entry}."""
    import torch
    import torch.nn.functional as F
    from simulst_tpu_torch.ops import conv_pos, ffn, linear_res, mha
    from simulst_tpu_torch.ops import emformer_attn as ea
    g = torch.Generator().manual_seed(SEED + 43)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    d, heads, hid, groups = WIDTH_TIMED[key]
    b = ASR_UTT
    xav = (6.0 / (d + hid)) ** 0.5
    out = {}

    def entry(name, shape, kern, plain, moved, flops, library):
        out[name] = dict(shape=shape, ms=cuda_ms(kern, samples=5, runs=5),
                         plain_ms=cuda_ms(plain, samples=3, runs=3),
                         library_ms=cuda_ms(library, samples=5, runs=5),
                         **dict(zip(("bound_ms", "bound_by"),
                                    bound(moved, flops))))
        log("phase22", kernel=name, **{key: out[name]})

    def products(x, w1, w2, dy=None):
        a, c = (torch.randn(x.shape[0], w1.shape[1], device=dev)
                for _ in range(2))
        if dy is None:
            return lambda: (x @ w1, a @ w2)
        return lambda: (x @ w1, dy @ w2.T, a @ w1.T, x.T @ a, c.T @ dy)

    lnw = (1 + randn(d, scale=0.1), randn(d, scale=0.1),
           randn(d, hid, scale=xav), randn(hid, scale=0.02),
           randn(hid, d, scale=xav), randn(d, scale=0.02))
    cfg = ("gelu", 0.1, 0.1, 17)
    for name, n, ln in (("fused_ln_ffn_res", b * (8 * 16 + 256), True),
                        ("fused_ffn", b * batch["prev_tokens"].shape[1],
                         False)):
        x, dy = randn(n, d), randn(n, d)
        ws = lnw if ln else lnw[2:]
        fwd = ffn.fused_ln_ffn_res_forward if ln else ffn.fused_ffn_forward
        bwd = ffn.fused_ln_ffn_res_backward if ln else ffn.fused_ffn_backward
        pfwd = ffn.ln_ffn_res_plain if ln else ffn.ffn_plain
        pbwd = (ffn.ln_ffn_res_plain_backward if ln
                else ffn.ffn_plain_backward)
        bws = ws[:5] if ln else ws[:3]
        y = fwd(x, *ws, *cfg)
        flops = 2 * n * d * hid
        shape = f"x=({n},{d}) hidden {hid} gelu rate 0.1"
        entry(name, shape, lambda: fwd(x, *ws, *cfg),
              lambda: pfwd(x, *ws, *cfg), nbytes(x, y, *ws), 2 * flops,
              products(x, lnw[2], lnw[4]))
        got = bwd(x, *bws, dy, *cfg)
        entry(f"{name}_backward", shape, lambda: bwd(x, *bws, dy, *cfg),
              lambda: pbwd(x, *bws, dy, *cfg), nbytes(x, dy, *bws, *got),
              5 * flops, products(x, lnw[2], lnw[4], dy))

    geom = ea.AttnGeom(U=256, seg=16, lc=32, rc=8, max_mem=5, G=8,
                       num_heads=heads)
    lengths = subsampled(batch["feat_lengths"]).to(torch.int32)
    q3, dout = randn(b, geom.ng, geom.nq, d), randn(b, geom.ng, geom.nq, d)
    args = (q3, randn(b, geom.tk, d), randn(b, geom.tk, d), lengths)
    o = ea.emformer_grouped_attention_forward(*args, geom, 0.1, 23)
    sd, mask = sdpa_on_context(ea, geom, *args)
    sd = [t.requires_grad_() for t in sd]
    with torch.enable_grad():
        sd_out = F.scaled_dot_product_attention(*sd, attn_mask=mask,
                                                dropout_p=0.1)
    sd_dout = torch.randn_like(sd_out)
    vis = grouped_visible_pairs(ea, geom, *args)
    shape = f"q3=({b},{geom.ng},{geom.nq},{d}) {heads} heads rate 0.1"
    entry("emformer_grouped_attention", shape,
          lambda: ea.emformer_grouped_attention_forward(*args, geom, 0.1, 23),
          lambda: ea.grouped_attention_plain(*args, geom, 0.1, 23),
          nbytes(*args, o), 4 * d * vis,
          lambda: F.scaled_dot_product_attention(*sd, attn_mask=mask,
                                                 dropout_p=0.1))
    got = ea.emformer_grouped_attention_backward(*args, dout, geom, 0.1, 23)
    entry("emformer_grouped_attention_backward", shape,
          lambda: ea.emformer_grouped_attention_backward(*args, dout, geom,
                                                         0.1, 23),
          lambda: ea.grouped_attention_plain_backward(*args, dout, geom, 0.1,
                                                      23),
          nbytes(*args, dout, *got), 10 * d * vis,
          lambda: torch.autograd.grad(sd_out, sd, sd_dout,
                                      retain_graph=True))
    del sd, sd_out

    tq = batch["prev_tokens"].shape[1]
    q, do = randn(b, tq, d), randn(b, tq, d)
    k, v = randn(b, tq, d), randn(b, tq, d)
    kmask = torch.ones(b, tq, dtype=torch.int32, device=dev)
    case = mha_forward_case(q, k, v, kmask, heads, True, 0.1)
    o, lse = mha.fused_mha_forward(q, k, v, kmask, heads, True, 0.1, 4321)
    out["fused_mha"] = dict(
        shape=f"({b},{tq},{tq}) causal {heads} heads rate 0.1",
        plain_ms=cuda_ms(lambda: mha.mha_plain(q, k, v, kmask, heads, True,
                                               0.1, 4321), samples=3,
                         runs=3), **case)
    log("phase22", kernel="fused_mha", **{key: out["fused_mha"]})
    vis = mha_visible_pairs(kmask, tq, True)
    entry("fused_mha_backward", out["fused_mha"]["shape"],
          lambda: mha.fused_mha_backward(q, k, v, kmask, o, lse, do, heads,
                                         True, 0.1, 4321),
          lambda: mha.mha_plain_backward(q, k, v, kmask, do, heads, True,
                                         0.1, 4321),
          nbytes(q, k, v, kmask, o, lse, do, q, k, v), 10 * d * vis,
          _sdpa_backward_call(q, k, v, kmask, do, heads, True, 0.1))

    n = b * 400          # the Emformer out-projection's rows, 200 / 192 gate
    h, res, dy = randn(n, d), randn(n, d), randn(n, d)
    w, bias = randn(d, d, scale=d ** -0.5), randn(d, scale=0.02)
    cfg = (200, 192, 0.1, 7)
    y = linear_res.fused_linear_res_forward(h, w, bias, res, *cfg)
    shape = f"({n},{d}) x ({d},{d}) gate 200 / 192 rate 0.1"
    entry("fused_linear_res", shape,
          lambda: linear_res.fused_linear_res_forward(h, w, bias, res, *cfg),
          lambda: linear_res.linear_res_plain(h, w, bias, res, *cfg),
          nbytes(h, w, bias, res, y), 2 * n * d * d, lambda: h @ w)
    got = linear_res.fused_linear_res_backward(h, w, dy, *cfg)
    entry("fused_linear_res_backward", shape,
          lambda: linear_res.fused_linear_res_backward(h, w, dy, *cfg),
          lambda: linear_res.linear_res_plain_backward(h, w, dy, *cfg),
          nbytes(h, w, dy, *got), 4 * n * d * d,
          lambda: (dy @ w.T, h.T @ dy))

    taps, t_out = 64, 256
    xp, dyc = randn(b, t_out + taps - 1, d), randn(b, t_out, d)
    got = conv_pos.convpos_wgrad(xp, dyc, taps, groups)
    xt, dyt = xp.transpose(1, 2).contiguous(), dyc.transpose(1, 2).contiguous()
    entry("convpos_wgrad",
          f"xp=({b},{t_out + taps - 1},{d}) {groups} groups ({d // groups} "
          "channels)",
          lambda: conv_pos.convpos_wgrad(xp, dyc, taps, groups),
          lambda: conv_pos.convpos_wgrad_plain(xp, dyc, taps, groups),
          nbytes(xp, dyc, got), 2 * b * t_out * taps * d * (d // groups),
          lambda: torch.nn.grad.conv1d_weight(xt, (d, d // groups, taps),
                                              dyt, groups=groups))
    return out


def _sdpa_backward_call(q, k, v, kmask, dout, heads, causal, rate):
    """SDPA's backward on fused_mha's inputs, as one call (for timing)."""
    import torch
    import torch.nn.functional as F
    b, tq, d = q.shape
    mask = sdpa_mask(q, k, kmask, causal)
    sd = [x.view(b, x.shape[1], heads, d // heads).transpose(1, 2).detach()
          .clone().requires_grad_() for x in (q, k, v)]
    with torch.enable_grad():
        sd_out = F.scaled_dot_product_attention(*sd, attn_mask=mask,
                                                dropout_p=rate)
    sd_dout = dout.view(b, tq, heads, d // heads).transpose(1, 2)
    return lambda: torch.autograd.grad(sd_out, sd, sd_dout,
                                       retain_graph=True)


def phase_width_train(dev, batch):
    """One train step of s2t_emformer at embed_dim 512, 8 encoder and
    decoder heads, FFN 2048 (dropout 0.1 and SpecAugment, launches
    counted), then compare_plain_step at phase 8's bounds from the same
    initial parameters and batch.  Returns the step's launches (the
    comparison's are not counted)."""
    import torch
    from simulst_tpu_torch.cli import train as cli
    from simulst_tpu_torch.train.state import (create_train_state,
                                               make_accum_train_step,
                                               make_train_step)
    args = cli.parse_args(ASR_ARGS + WIDTH_MODEL)
    model = cli.build_model(args, ASR_VOCAB, device=dev)
    loss_fn = cli.build_loss(args, model)
    optim_cfg = cli.optim_config(args)
    state = create_train_state(model, optim_cfg)
    initial = copy.deepcopy(state)
    train_step = make_train_step(loss_fn, optim_cfg)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    state, metrics = train_step(state, batch, torch.Generator().manual_seed(
        SEED))
    torch.cuda.synchronize()
    launches = read_launches()
    loss = float(metrics["loss"]) / float(metrics["sample_size"])
    if not np.isfinite(loss) or state.step != 1:
        raise AssertionError(f"512-wide step: loss {loss}, {state.step}")
    log("phase22", train="s2t_emformer embed_dim 512, 8 heads, FFN 2048",
        step_ms=(time.perf_counter() - t0) * 1e3, loss=loss,
        params=sum(p.numel() for p in model.parameters()))
    del state
    compare_plain_step(initial, loss_fn, optim_cfg, batch, "phase22",
                       make_accum_train_step)
    return launches


def phase_width_streaming_cif(dev):
    """JAX's 16-wide dry-run CIF model (multichip.streaming_config: 1 + 1
    layers, 2 heads of 8, FFN 32, vocab 24), which every width kernel takes
    padded: one cli/train CIF-loss step (dropout 0, no SpecAugment) on the
    dry run's 8-row batch with its launches counted (every width kernel
    must launch), kernels vs plain on that step at phase 8's bounds; then 8
    fused streaming sessions over the dry run's 5 chunks (EOS's embedding
    row x 0.1, as the dry run) with the kernels and through the plain
    versions: tokens equal.  Returns the step's launches."""
    import torch
    from simulst_tpu_torch import multichip
    from simulst_tpu_torch.cli import train as cli
    from simulst_tpu_torch.models.cif import CIFModel
    from simulst_tpu_torch.stream import fused
    from simulst_tpu_torch.train.state import (create_train_state,
                                               make_accum_train_step,
                                               make_train_step)
    cfg = multichip.streaming_config()
    model = CIFModel(cfg, generator=torch.Generator().manual_seed(SEED),
                     device=dev)
    args = cli.parse_args(["--task", "st", "--model", "cif", "--loss", "cif",
                           "--no-specaugment", "--seed", str(SEED)])
    loss_fn = cli.build_loss(args, model)
    optim_cfg = cli.optim_config(args)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in multichip.dryrun_batch(cfg, 8).items()}
    state = create_train_state(model, optim_cfg)
    initial = copy.deepcopy(state)
    torch.cuda.synchronize()
    reset_launches()
    state, metrics = make_train_step(loss_fn, optim_cfg)(state, batch)
    torch.cuda.synchronize()
    launches = read_launches()
    loss = float(metrics["loss"]) / float(metrics["sample_size"])
    missing = [k for k in WIDTH_KERNELS + ("cif_integrate",)
               if not launches[k]]
    if missing or not np.isfinite(loss):
        raise AssertionError(f"16-wide CIF step: loss {loss}, {missing} did "
                             f"not launch: {launches}")
    log("phase22", train="the dry run's CIF model: embed_dim 16, 2 heads, "
        "FFN 32", loss=loss, launches={k: v for k, v in launches.items()
                                       if v})
    compare_plain_step(initial, loss_fn, optim_cfg, batch, "phase22",
                       make_accum_train_step)
    model = initial.model
    model.eval()
    with torch.no_grad():
        model.decoder.embed_tokens.weight[cfg.eos_idx] *= 0.1
    chunks = [torch.as_tensor(c, device=dev)
              for c in multichip.streaming_chunks(cfg, 8)]

    def session():
        step = fused.make_cif_fused_step(model, cfg)
        st = fused.cif_fused_init(model, cfg, 32, batch=8)
        with torch.no_grad():
            for i, ch in enumerate(chunks):
                st, _ = step(st, ch, finish=i == len(chunks) - 1)
        return st.tokens.cpu(), st.n_tokens.cpu()

    got = session()
    with plain_training():
        want = session()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"16-wide CIF streaming: kernel tokens "
                             f"{got[1].tolist()} differ from plain "
                             f"{want[1].tolist()}")
    log("phase22", streaming="the dry run's CIF model, 8 fused sessions",
        tokens=int(got[1].sum()), n_tokens=got[1].tolist())
    return launches


def phase_convergence(dev):
    """exp/kernel_convergence_check.py on the port: 30 Adam steps (lr
    1e-3) of s2t_emformer_s with joint CTC (B 8, T 1024, U 24, vocab 128,
    bf16, dropout 0), once with the kernels and once through the plain
    versions, from the same initial parameters and batch.  Both final
    losses must fall under 0.8 of the first and the largest relative
    deviation of the two trajectories stay under 0.03; the plain run
    records its largest pre-softmax Emformer score, printed against JAX's
    margin SCORE_CLAMP / 2."""
    import torch
    from simulst_tpu_torch.losses.joint_ctc import (JointCTCConfig,
                                                    joint_ctc_loss)
    from simulst_tpu_torch.models import s2t_emformer as s2t
    from simulst_tpu_torch.nn import emformer as emf
    cfg = s2t.S2TEmformerConfig(vocab_size=TRAJ_VOCAB, ctc_layer=True,
                                compute_dtype="bfloat16")
    init = s2t.S2TEmformerModel(
        cfg, generator=torch.Generator().manual_seed(SEED), device=dev)
    g = torch.Generator().manual_seed(SEED + 1)
    feats = torch.randn(TRAJ_B, TRAJ_T, 80, generator=g).to(dev)
    lengths = torch.full((TRAJ_B,), TRAJ_T, dtype=torch.int64, device=dev)
    tokens = torch.randint(4, TRAJ_VOCAB, (TRAJ_B, TRAJ_U),
                           generator=g).to(dev)
    lcfg = JointCTCConfig()

    def trajectory():
        model = copy.deepcopy(init)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        losses = []
        for _ in range(TRAJ_STEPS):
            opt.zero_grad(set_to_none=True)
            logits, extra = model(feats, lengths, tokens)
            loss = joint_ctc_loss(logits, extra, tokens, lcfg)[0] / (
                TRAJ_B * TRAJ_U)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        return losses

    t0 = time.perf_counter()
    scores = emf.enable_score_monitor()
    try:
        with plain_training():
            plain = trajectory()
    finally:
        emf.disable_score_monitor()
    kernels = trajectory()
    rel = [abs(a - b) / max(abs(a), 1e-6) for a, b in zip(plain, kernels)]
    max_score = max(scores) if scores else float("nan")
    log("phase22", trajectory="s2t_emformer_s joint CTC bf16 dropout 0",
        steps=TRAJ_STEPS, plain_losses=plain, kernel_losses=kernels,
        max_rel_deviation=max(rel), max_pre_softmax_score=max_score,
        score_margin=SCORE_MARGIN, seconds=time.perf_counter() - t0)
    if not (plain[-1] < 0.8 * plain[0] and kernels[-1] < 0.8 * kernels[0]):
        raise AssertionError(f"trajectory not converging: plain {plain[0]} "
                             f"-> {plain[-1]}, kernels {kernels[0]} -> "
                             f"{kernels[-1]}")
    if not max(rel) < 0.03:
        raise AssertionError(f"kernel trajectory departs from plain: "
                             f"{max(rel)}")
    if not (scores and max_score < SCORE_MARGIN):
        raise AssertionError(f"pre-softmax scores {max_score} reach the "
                             f"margin {SCORE_MARGIN}")


# the tone-language CIF leg's updates here: tools/synthetic_smoke.py runs
# 1000, as the JAX script does; 400 keep the run inside its time (on an
# H100 the leg read BLEU 86.4-97.6 at 400 updates, 98.1 at 600, 100 at
# 1000)
SYNTHETIC_UPDATES = 400


def phase_synthetic(workdir):
    """tools/synthetic_smoke.py's CIF leg (the tone-language corpus,
    SYNTHETIC_UPDATES bf16 updates of CIF at embed_dim 64, checkpoint
    averaging, fused scanned batched streaming under global CMVN), its
    CLIs run as a user runs them, each in a process of its own; BLEU > 20,
    AL > 0."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tools"))
    import synthetic_smoke as smoke
    t0 = time.perf_counter()
    data = smoke.build_corpus(os.path.join(workdir, "tones"))
    corpus_s = time.perf_counter() - t0
    scores = smoke.run_leg(workdir, data, "cif", updates=SYNTHETIC_UPDATES)
    log("phase22", synthetic="cif", corpus_s=corpus_s,
        seconds=time.perf_counter() - t0, BLEU=scores["BLEU"],
        AL=scores["AL"], AP=scores.get("AP"), DAL=scores.get("DAL"))


def phase_widths(dev, batch, workdir):
    """Phase 22: the kernels at every width the JAX package trains.  The
    corners vs plain (22a; the widths the wrappers pad too), the times at
    D 512, 16 and 200 (22b), the path of this slice: a 512-wide train step
    (22c, its launches counted: every width-dependent kernel must launch),
    JAX's 16-wide dry-run CIF model through a train step and fused
    streaming (22d, launches counted the same way) and the tone-language
    CIF leg through the CLIs (22e); then the kernel convergence
    trajectory.  Returns (the launches of the 512- and 16-wide steps, the
    times by width)."""
    import torch
    t0 = time.perf_counter()
    with torch.no_grad():
        phase_width_kernels(dev)
        phase_width_kernels(dev, padded=True)
        t1 = time.perf_counter()
        times = {key: phase_width_times(dev, batch, key)
                 for key in WIDTH_TIMED}
    t2 = time.perf_counter()
    launches = phase_width_train(dev, batch)
    missing = [k for k in WIDTH_KERNELS if not launches[k]]
    if missing:
        raise AssertionError(f"phase 22: {missing} did not launch at the "
                             f"new widths: {launches}")
    log("phase22", launches=launches)
    t3 = time.perf_counter()
    narrow = phase_width_streaming_cif(dev)
    launches = {k: launches[k] + narrow[k] for k in launches}
    t4 = time.perf_counter()
    phase_synthetic(workdir)
    log("phase22", kernels_s=t1 - t0, times_s=t2 - t1, train_s=t3 - t2,
        narrow_s=t4 - t3, synthetic_s=time.perf_counter() - t4)
    phase_convergence(dev)
    return launches, times


# ---------------------------------------------------------------------------
# 23. triples
# ---------------------------------------------------------------------------
TRIPLE_UTT, TRIPLE_STEPS = 16, 2
# the model options of exp/2_mma.sh and exp/3_cif.sh (MMA_ARGS, CIF_ARGS)
MMA_MODEL_ARGS = MMA_ARGS[6:12]
CIF_MODEL_ARGS = CIF_ARGS[6:10]
# their optimizer options
MMA_OPTIM_ARGS = MMA_ARGS[MMA_ARGS.index("--lr"):]
CIF_OPTIM_ARGS = CIF_ARGS[CIF_ARGS.index("--lr"):]
# the six (task, model, loss) triples the JAX package's cli/train trains
# besides the s2t_emformer, transducer, convpos and MT ones: argv, and the
# launches per step the layer count predicts (the MMA pairings' 6 decoder
# layers each run one alignment recursion; the CIF pairings one
# integrate-and-fire; the joint-CTC pairings and the CIF loss at
# exp/3_cif.sh's ctc_factor 0.3 one CTC loss on the encoder's CTC head)
TRIPLES = {
    "asr cif cif": (["--task", "asr", "--model", "cif", "--loss", "cif"]
                    + CIF_ARGS[6:], CIF_LAUNCHES_PER_STEP),
    "asr mma mma": (["--task", "asr"] + MMA_ARGS[2:],
                    MMA_LAUNCHES_PER_STEP),
    **{f"{task} mma joint_ctc": (
        ["--task", task, "--model", "mma", "--loss", "joint_ctc",
         "--override", "ctc_layer=true"] + MMA_MODEL_ARGS + MMA_OPTIM_ARGS,
        {**MMA_LAUNCHES_PER_STEP, "ctc_alphas": 1, "ctc_d_em": 1})
       for task in ("asr", "st")},
    **{f"{task} cif joint_ctc": (
        ["--task", task, "--model", "cif", "--loss", "joint_ctc"]
        + CIF_MODEL_ARGS + CIF_OPTIM_ARGS,
        CIF_LAUNCHES_PER_STEP) for task in ("asr", "st")}}
# the triples whose one step is held to the plain versions'
TRIPLES_COMPARED = ("st mma joint_ctc", "st cif joint_ctc")


def phase_triples(dev, batch, asr_checkpoint):
    """Each of TRIPLES through cli/train's parse_args, build_model (full
    width: MMAConfig() / CIFConfig(), s2t_emformer_s's widths, the encoder
    loaded from phase 8's checkpoint through --load-pretrained-encoder-from,
    as exp/2_mma.sh and exp/3_cif.sh load it), build_loss and train step:
    TRIPLE_STEPS updates on the first TRIPLE_UTT of phase 7's utterances,
    every loss finite and the launches per step as predicted; then, for
    TRIPLES_COMPARED, one step at dropout 0 without SpecAugment kernels vs
    plain on phase 7's batch (compare_plain_step): within phase 8's bounds,
    or twice the rounding floor measured beside them where that floor
    reaches half a bound (`mma joint_ctc`'s did on the H100: its gradients
    moved 8.0e-5 to 1.4e-4 of their largest entries and its gradient norm
    9.5e-6 to 2.8e-5 under one rounding of the parameters, against phase
    8's 1e-4 and 1e-5).  Returns the launches of all the triples'
    steps."""
    import torch
    from simulst_tpu_torch.cli import train as cli
    from simulst_tpu_torch.train.state import (create_train_state,
                                               make_accum_train_step,
                                               make_train_step)
    sub = {k: v[:TRIPLE_UTT] for k, v in batch.items()}
    total = {}
    for name, (argv, predicted) in TRIPLES.items():
        t0 = time.perf_counter()
        args = cli.parse_args(argv + ["--load-pretrained-encoder-from",
                                      asr_checkpoint])
        model = cli.build_model(args, ASR_VOCAB, device=dev)
        loss_fn = cli.build_loss(args, model)
        optim_cfg = cli.optim_config(args)
        state = create_train_state(model, optim_cfg)
        initial = copy.deepcopy(state) if name in TRIPLES_COMPARED else None
        generator = torch.Generator().manual_seed(SEED)
        train_step = make_train_step(loss_fn, optim_cfg)
        torch.cuda.synchronize()
        reset_launches()
        losses = []
        for _ in range(TRIPLE_STEPS):
            state, metrics = train_step(state, sub, generator)
            losses.append(float(metrics["loss"])
                          / float(metrics["sample_size"]))
        torch.cuda.synchronize()
        launches = read_launches()
        per_step = {k: launches[k] / TRIPLE_STEPS for k in predicted}
        log("phase23", triple=name, argv=" ".join(argv[:6]),
            config=type(model.cfg).__name__, embed_dim=model.cfg.embed_dim,
            utterances=TRIPLE_UTT, losses=losses, launches_per_step=per_step,
            s=time.perf_counter() - t0)
        if per_step != predicted:
            raise AssertionError(f"{name}: launches per step {per_step}, "
                                 f"expected {predicted}")
        if not all(np.isfinite(losses)) or state.step != TRIPLE_STEPS:
            raise AssertionError(f"{name}: losses {losses}, updates "
                                 f"{state.step}")
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        del state
        if initial is not None:
            compare_plain_step(initial, loss_fn, optim_cfg, batch,
                               "phase23", make_accum_train_step,
                               floor_margin=2.0)
            del initial
    return total


def run(dev):
    import torch
    from simulst_tpu_torch.cli.generate import decode_batch
    from simulst_tpu_torch.decode.beam import BeamConfig
    from simulst_tpu_torch.models import s2t_emformer as s2t
    from simulst_tpu_torch.nn import transformer as tfm
    from simulst_tpu_torch.ops import _build
    from simulst_tpu_torch.ops.fbank import fbank_batch, utterance_cmvn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_name_and_power_limit()
    started = time.perf_counter()

    def mark(phase):
        """The run's seconds when `phase` (and the ones before it) ended."""
        log("elapsed", after_phase=phase, s=time.perf_counter() - started)

    # 1. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log("phase1", build_s=time.perf_counter() - t0, library=str(lib_path),
        nvcc_log=str(lib_path.with_suffix(".log")),
        torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0))
    print(f"phase1 gpu: {gpu}", flush=True)

    with torch.inference_mode():
        mark(1)
        # 2. serving kernels vs plain
        report = phase_kernels(dev)

        mark(2)
        # 3. offline decode
        cfg = s2t.S2TEmformerConfig()
        model = s2t.S2TEmformerModel(
            cfg, generator=torch.Generator().manual_seed(SEED), device=dev)
        model.eval()
        wavs = torch.from_numpy(synthetic_audio(
            np.random.RandomState(SEED), N_UTT, N_FRAMES)).to(dev)
        feats = utterance_cmvn(fbank_batch(wavs))
        assert feats.shape == (N_UTT, N_FRAMES, cfg.input_feat), feats.shape
        lengths = torch.full((N_UTT,), N_FRAMES, dtype=torch.int64, device=dev)
        batch = {"feats": feats, "feat_lengths": lengths}
        beam_cfg = BeamConfig(beam_size=BEAM, max_len=MAX_LEN)

        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens, tok_lengths = decode_batch(model, batch, beam_cfg)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        serving = read_launches()
        if not all(serving[k] for k in SERVING_KERNELS):
            raise AssertionError(f"a kernel did not launch in the offline "
                                 f"decode: {serving}")
        if tokens.shape != (N_UTT, MAX_LEN) or not (
                (tok_lengths >= 1) & (tok_lengths <= MAX_LEN)).all():
            raise AssertionError(f"decode output {tuple(tokens.shape)}, "
                                 f"lengths {tok_lengths.tolist()}")
        t0 = time.perf_counter()
        decode_batch(model, batch, beam_cfg)
        torch.cuda.synchronize()
        steady_ms = (time.perf_counter() - t0) * 1e3

        mark(3)
        # 4. streaming session on the first utterance
        stepper = s2t.make_encoder_stepper(model.encoder, cfg)
        ecfg = cfg.emformer
        first = (ecfg.segment + ecfg.right_context) * cfg.stride
        steady = ecfg.segment * cfg.stride
        plan = [first] + [steady] * ((N_FRAMES - first) // steady)
        plan.append(N_FRAMES - sum(plan))            # the flush
        state = s2t.encoder_init_state(model.encoder, cfg, 1, device=dev)
        dstate = tfm.decoder_init_state(cfg.decoder, 1, MAX_LEN, device=dev)
        reset_launches()
        token = torch.full((1,), cfg.eos_idx, dtype=torch.int64, device=dev)
        outs, chunk_ms, t = [], [], 0
        for i, c in enumerate(plan):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, state = stepper(state, feats[:1, t:t + c],
                                 finish=i == len(plan) - 1)
            outs.append(out.encoder_out)
            enc = torch.cat(outs, dim=1)
            valid = torch.ones(1, enc.shape[1], dtype=torch.bool, device=dev)
            logits, dstate = tfm.decoder_step(model.decoder, cfg.decoder,
                                              dstate, token, enc, valid)
            token = logits.argmax(dim=-1)
            torch.cuda.synchronize()
            chunk_ms.append((time.perf_counter() - t0) * 1e3)
            t += c
        session = read_launches()
        for k in ("fused_ln_ffn_res", "fused_ffn", "fused_mha"):
            if not session[k]:
                raise AssertionError(f"{k} did not launch in the streaming "
                                     f"session: {session}")

        # checks of the main path's outputs (launches here are not counted)
        enc_k = s2t.encoder_forward(model.encoder, cfg, feats, lengths)
        with plain_versions():
            enc_p = s2t.encoder_forward(model.encoder, cfg, feats, lengths)
        assert enc_k.encoder_out.shape == (N_UTT, N_FRAMES // cfg.stride,
                                           cfg.embed_dim)
        offline_err = max_err("offline encoder_out kernels vs plain",
                              enc_k.encoder_out, enc_p.encoder_out,
                              atol=1e-4, rtol=0.0)
        log("phase3", batch=N_UTT, frames=N_FRAMES, beam=BEAM, max_len=MAX_LEN,
            first_ms_per_batch=first_ms, steady_ms_per_batch=steady_ms,
            token_lengths=tok_lengths.tolist(), launches=serving,
            encoder_out_max_abs_err=offline_err)
        stream_out = torch.cat(outs, dim=1)
        off1 = s2t.encoder_forward(model.encoder, cfg, feats[:1], lengths[:1])
        stream_err = max_err("streaming vs offline encoder output", stream_out,
                             off1.encoder_out, atol=1e-4, rtol=0.0)
        log("phase4", chunks=plan, median_ms_per_chunk=statistics.median(
                chunk_ms), mean_ms_per_chunk=statistics.mean(chunk_ms),
            first_chunk_ms=chunk_ms[0], streaming_vs_offline_max_abs_err=
            stream_err, launches_in_session=session)
        del model, enc_k, enc_p, off1

    mark(4)
    # 5. training kernels vs plain at the MT shapes
    from simulst_tpu_torch.data.synthetic import synthetic_pairs
    mt_batch = {k: torch.from_numpy(v).to(dev) for k, v in synthetic_pairs(
        np.random.RandomState(SEED), MT_PAIRS, MT_MIN_LEN, MT_MAX_LEN,
        8000).items()}
    with torch.no_grad():
        report.update(phase_train_kernels(dev, mt_batch))

    mark(5)
    # 6. MT training steps; the trained teacher is decoded in phase 16
    workdir = tempfile.TemporaryDirectory()
    checkpoints = {kind: os.path.join(workdir.name, f"{kind}_checkpoint")
                   for kind in ("cif", "mma", "mt")}
    training = phase_train(dev, mt_batch, checkpoints["mt"])
    mt_src = mt_batch["src_tokens"]
    del mt_batch

    mark(6)
    # 7. ASR training kernels vs plain at the 32 x 1024-frame shapes
    asr = asr_batch(dev)
    with torch.no_grad():
        report.update(phase_asr_kernels(dev, asr))

    mark(7)
    # 8. ASR training steps; the trained encoder is MMA's starting point
    asr_checkpoint = os.path.join(workdir.name, "asr_checkpoint_last")
    asr_training, asr_median_ms, asr_fp32 = phase_asr_train(dev, asr,
                                                            asr_checkpoint)

    mark(8)
    # 9. the MMA alignment kernels vs plain
    with torch.no_grad():
        report.update(phase_mma_kernels(dev))

    mark(9)
    # 10. MMA training steps from the ASR encoder
    mma_training, mma_model = phase_mma_train(dev, asr, asr_checkpoint)
    from simulst_tpu_torch import config as cfglib
    from simulst_tpu_torch.train.checkpoint import save_checkpoint
    save_checkpoint(checkpoints["mma"], mma_model.state_dict(),
                    {"model": "mma", "config": cfglib.to_dict(mma_model.cfg)})

    mark(10)
    # 11. MMA streaming on the first utterance of the batch
    with torch.no_grad():
        phase_mma_stream(dev, mma_model, asr["feats"][:1])
    del mma_model

    mark(11)
    # 12. the CIF kernel vs plain
    with torch.no_grad():
        report.update(phase_cif_kernels(dev))

    mark(12)
    # 13. CIF training steps from the ASR encoder
    cif_training = phase_cif_train(dev, asr, asr_checkpoint,
                                   checkpoints["cif"])

    mark(13)
    # 14. CIF and MMA through the streaming evaluator
    cif_serving = phase_serve(dev, workdir.name, checkpoints)

    mark(14)
    # 15. the batched streaming evaluator (B 1, 8 and 64, scanned)
    batched_serving = phase_batched_serve(dev, workdir.name, checkpoints)

    mark(15)
    # 16. offline decoding of MMA, CIF and MT; cli/generate main
    speech = {"feats": feats, "feat_lengths": lengths}
    with torch.no_grad():
        offline_decode = phase_offline_decode(dev, workdir.name, checkpoints,
                                              speech, mt_src)
    del mt_src

    mark(16)
    # 17. sequence-packed ASR training (cli/train --pack)
    pack_training, pack_report = phase_asr_pack(dev, asr, asr_median_ms)
    report.update(pack_report)

    mark(17)
    # 18. the transducer: its label-encoder kernels vs plain, then exp/6's
    # training from phase 8's encoder, offline decode and streaming
    with torch.no_grad():
        phase_transducer_kernels(dev)
    transducer = phase_transducer(dev, asr, asr_checkpoint, speech,
                                  workdir.name)

    mark(18)
    # 19. data to score: MuST-C preparation, train --mtl with encoder
    # freezing, tensorboard and the profiler, s2t_transformer_convpos, the
    # fairseq loader, interactive and visualize
    data_to_score = phase_data(dev, workdir.name, asr, speech, report)

    mark(19)
    # 20. bf16 compute (--override compute_dtype=bfloat16), remat and the
    # model options: the FFN kernels' silu and tanh, rows 1-6 in bf16,
    # asr-train in bf16 (its launches are this path's) with remat, bf16
    # serving, MMA, CIF and transducer bf16 steps, post-LN and VGG
    bf16_training, bf16_report = phase_bf16(dev, asr, speech, tokens,
                                            asr_fp32)
    for name, fields in bf16_report.items():
        report.setdefault(name, {}).update(fields)

    mark(20)
    # 21. parallel: two ranks (the dry run, then the full-width data-,
    # tensor-, pipeline- and sequence-parallel paths and sharded serving)
    parallel = phase_parallel(dev, asr)

    mark(21)
    # 22. widths: the kernels at the corners of the widths the JAX package
    # trains, their times at D 512, a 512-wide train step, the
    # tone-language CIF leg and the kernel convergence trajectory
    widths, width_times = phase_widths(dev, asr, workdir.name)

    mark(22)
    # 23. the six (task, model, loss) triples that the JAX package trains
    # besides the ones above, full width from phase 8's encoder
    triples = phase_triples(dev, asr, asr_checkpoint)
    del asr, speech, feats, lengths
    workdir.cleanup()

    mark(23)
    # 24. report
    paths = {"serving": serving, "training": training,
             "asr-training": asr_training, "mma-training": mma_training,
             "cif-training": cif_training, "cif-serving": cif_serving,
             "batched-serving": batched_serving,
             "offline-decode": offline_decode, "asr-pack": pack_training,
             "transducer": transducer, "data-to-score": data_to_score,
             "bf16-training": bf16_training, "parallel": parallel,
             "widths": widths, "triples": triples}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": paths[path][name],
         "launches_by_path": {p: counts[name] for p, counts in paths.items()},
         **{key: report[name].get(key) for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "shape", "bf16", "activations")},
         **{key: t[name] for key, t in width_times.items() if name in t}}
        for name, (_, src, tpu, path) in KERNELS.items()]}), flush=True)
    # the whole run's time (logged as "phase21" until phase 21 existed)
    log("total", total_s=time.perf_counter() - started)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke test needs an NVIDIA GPU")
    run(torch.device("cuda", 0))


if __name__ == "__main__":
    main()
