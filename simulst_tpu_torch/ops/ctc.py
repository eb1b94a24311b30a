"""CTC loss, its alpha-beta gradient and the Viterbi alignment
(counterpart of simulst_tpu/ops/ctc.py).

Log-space dynamic programmes over the S = 2L+1 augmented states [blank,
y1, blank, y2, ...] of each example.  `ctc_raw_smoothed` is the training
loss on RAW logits: its forward runs the alpha recursion (`ctc_alphas`),
its backward the beta recursion fused with the occupancy posterior
(`ctc_d_em`), then assembles dlogits = scatter(d_em) + d_lse softmax - the
smoothing term in one (B, T, V) pass.  `ctc_alphas` and `ctc_d_em` run the
CUDA kernels of csrc/ctc.cu on a CUDA tensor (one block per example, one
state a thread up to S 1024 and several above, up to MAX_STATES) and
their plain versions `alphas_plain` / `d_em_plain` (a loop over T) on a
CPU tensor.  Frames at t >= input_length are frozen: alpha and beta carry
over, d_em is 0.

NEG = -1e30 is a finite sentinel for impossible states, not -inf, so that
logaddexp of two blocked states stays finite and the zero_infinity test
(nll <= 1e30 / 2) holds.

`ctc_loss_raw` is its nll alone (the CIF criterion's CTC term).
`ctc_loss` (on log-probs, differentiable through autograd), `best_alignment`
and `alignment_to_labels` are plain torch, as they are XLA in the JAX
package.  Emissions are a gather of the label columns (the JAX one-hot
einsum is a trick for the TPU's matrix unit).
"""
from __future__ import annotations

import torch

from simulst_tpu_torch.ops import _build

NEG = -1e30
MAX_STATES = 16 * 1024   # the kernels' S (csrc/ctc.cu kMaxStates)


def ctc_labels(targets, blank: int):
    """targets (B, L) -> augmented labels (B, 2L+1): [blank, y1, blank, ...]."""
    b, l = targets.shape
    labels = torch.full((b, 2 * l + 1), blank, dtype=torch.int64,
                        device=targets.device)
    labels[:, 1::2] = targets
    return labels


def _ctc_masks(targets, blank: int):
    """(labels, can_skip): a skip from s-2 is allowed where the label is not
    blank and differs from label s-2."""
    labels = ctc_labels(targets, blank)
    shift2 = torch.nn.functional.pad(labels, (2, 0), value=-1)[:, :-2]
    return labels, (labels != blank) & (labels != shift2)


def _emissions(log_probs, labels):
    """(B, T, V) x (B, S) -> (T, B, S) fp32 label scores per frame."""
    b, t, _ = log_probs.shape
    em = log_probs.float().gather(2, labels[:, None, :].expand(
        b, t, labels.shape[1]))
    return em.permute(1, 0, 2)


def _neg_col(x, n=1):
    return x.new_full((x.shape[0], n), NEG)


def _alpha0(em0, target_lengths):
    iota = torch.arange(em0.shape[1], device=em0.device)[None, :]
    first = (iota == 0) | ((iota == 1) & (target_lengths > 0)[:, None])
    return torch.where(first, em0, torch.full_like(em0, NEG))


def _alpha_step(alpha, em_t, can_skip, live):
    s = alpha.shape[1]
    a1 = torch.cat([_neg_col(alpha), alpha], 1)[:, :s]
    a2 = torch.cat([_neg_col(alpha, 2), alpha], 1)[:, :s]
    a2 = torch.where(can_skip, a2, torch.full_like(a2, NEG))
    new = em_t + torch.logaddexp(torch.logaddexp(alpha, a1), a2)
    return torch.where(live[:, None], new, alpha)


def _alphas(em, can_skip, input_lengths, target_lengths):
    """(T, B, S) alphas; differentiable through autograd."""
    alpha = _alpha0(em[0], target_lengths)
    out = [alpha]
    for t in range(1, em.shape[0]):
        alpha = _alpha_step(alpha, em[t], can_skip, t < input_lengths)
        out.append(alpha)
    return torch.stack(out)


def alphas_plain(em, can_skip, input_lengths, target_lengths):
    """(T, B, S) alphas of the emissions em (T, B, S); can_skip (B, S)."""
    return _alphas(em.float(), can_skip != 0, input_lengths, target_lengths)


def d_em_plain(em, alphas, can_skip, input_lengths, target_lengths, scale,
               nll):
    """(T, B, S) d_em[t] = scale * exp(alpha[t] + beta[t] + nll) on live
    frames, 0 past the input length; beta[t] excludes em[t]."""
    t_len, b, s = em.shape
    skip = can_skip != 0
    end = 2 * target_lengths.long()
    iota = torch.arange(s, device=em.device)[None, :]
    last = (iota == end[:, None]) | (
        (iota == torch.clamp(end - 1, min=0)[:, None])
        & (target_lengths > 0)[:, None])
    beta = torch.where(last, torch.zeros_like(em[0]),
                       torch.full_like(em[0], NEG))
    d_em = torch.empty_like(em)
    for t in range(t_len - 1, -1, -1):
        live = (t < input_lengths)[:, None]
        d = scale[:, None] * torch.exp(alphas[t] + beta + nll[:, None])
        d_em[t] = torch.where(live, d, torch.zeros_like(d))
        b0 = em[t] + beta
        b1 = torch.cat([b0, _neg_col(b0)], 1)[:, 1:]
        b2m = torch.where(skip, b0, torch.full_like(b0, NEG))
        b2 = torch.cat([b2m, _neg_col(b0, 2)], 1)[:, 2:]
        new = torch.logaddexp(torch.logaddexp(b0, b1), b2)
        beta = torch.where(live, new, beta)
    return d_em


def _kernel_args(name, em, can_skip, input_lengths, target_lengths, *more):
    """Contiguous fp32 (em, *more) and int32 (can_skip, input_lengths,
    target_lengths) on em's device, or raise."""
    t, b, s = em.shape
    if can_skip.shape != (b, s) or input_lengths.shape != (b,) or \
            target_lengths.shape != (b,) or s > MAX_STATES:
        raise ValueError(f"{name}: kernel takes em (T, B, S <= "
                         f"{MAX_STATES}), can_skip (B, S), lengths (B,); "
                         f"got em "
                         f"{tuple(em.shape)}, can_skip "
                         f"{tuple(can_skip.shape)}")
    if em.dtype != torch.float32:
        raise TypeError(f"{name}: em must be float32, got {em.dtype}")
    f32 = [x.contiguous() for x in (em, *more)]
    _build.check_cuda(name, f32[0], **{f"input{i}": x
                                       for i, x in enumerate(f32[1:])})
    ints = [x.to(torch.int32).contiguous() for x in
            (can_skip, input_lengths, target_lengths)]
    _build.check_cuda(name, ints[0], input_lengths=ints[1],
                      target_lengths=ints[2])
    if ints[0].device != em.device:
        raise ValueError(f"{name}: can_skip and lengths must be on "
                         f"{em.device}")
    return f32, ints


def ctc_alphas(em, can_skip, input_lengths, target_lengths):
    """(T, B, S) fp32 alphas: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if em.device.type == "cpu":
        return alphas_plain(em, can_skip, input_lengths, target_lengths)
    (em,), (skip, il, tl) = _kernel_args("ctc_alphas", em, can_skip,
                                         input_lengths, target_lengths)
    t, b, s = em.shape
    alphas = torch.empty_like(em)
    _build.launch("simulst_ctc_alpha", em.data_ptr(), skip.data_ptr(),
                  il.data_ptr(), tl.data_ptr(), alphas.data_ptr(), t, b, s,
                  _build.stream_of(em))
    ctc_alphas.launches += 1
    return alphas


def ctc_d_em(em, alphas, can_skip, input_lengths, target_lengths, scale, nll):
    """(T, B, S) fp32 d_em: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if em.device.type == "cpu":
        return d_em_plain(em, alphas, can_skip, input_lengths,
                          target_lengths, scale, nll)
    (em, alphas, scale, nll), (skip, il, tl) = _kernel_args(
        "ctc_d_em", em, can_skip, input_lengths, target_lengths, alphas,
        scale, nll)
    t, b, s = em.shape
    d_em = torch.empty_like(em)
    _build.launch("simulst_ctc_d_em", em.data_ptr(), alphas.data_ptr(),
                  skip.data_ptr(), il.data_ptr(), tl.data_ptr(),
                  scale.data_ptr(), nll.data_ptr(), d_em.data_ptr(), t, b, s,
                  _build.stream_of(em))
    ctc_d_em.launches += 1
    return d_em


def d_em_log1p_mismatches(device) -> int:
    """The fp32 inputs, of all 2^32 bit patterns, at which the d_em kernel's
    branch-free log1p differs from the CUDA math library's log1pf in any
    bit (csrc/ctc.cu log1p_select); 0 for the kernel to be bit for bit."""
    count = torch.zeros(1, dtype=torch.int64, device=device)
    _build.launch("simulst_ctc_log1p_check", count.data_ptr(),
                  _build.stream_of(count))
    return int(count.item())


def _nll_from_alpha(alpha_last, target_lengths):
    """-log P(target) per example from the last alphas (B, S)."""
    end = 2 * target_lengths.long()
    a_last = alpha_last.gather(1, end[:, None])[:, 0]
    a_prev = alpha_last.gather(1, torch.clamp(end - 1, min=0)[:, None])[:, 0]
    a_prev = torch.where(target_lengths > 0, a_prev,
                         torch.full_like(a_prev, NEG))
    return -torch.logaddexp(a_last, a_prev)


class _CTCRawSmoothed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, input_lengths, targets, target_lengths, blank,
                zero_infinity, with_smooth):
        b, t, v = logits.shape
        labels, can_skip = _ctc_masks(targets.long(), blank)
        lf = logits.float()
        lse = torch.logsumexp(lf, dim=-1)                          # (B, T)
        em = (_emissions(lf, labels) - lse.T[:, :, None]).contiguous()
        alphas = ctc_alphas(em, can_skip, input_lengths, target_lengths)
        nll_b = _nll_from_alpha(alphas[-1], target_lengths)
        keep = torch.ones_like(nll_b, dtype=torch.bool)
        if zero_infinity:
            keep = (nll_b <= -NEG / 2) & torch.isfinite(nll_b)
        nll_sum = torch.where(keep, nll_b, torch.zeros_like(nll_b)).sum()
        valid = torch.arange(t, device=logits.device)[None, :] < \
            input_lengths[:, None]
        smooth = (torch.where(valid, v * lse - lf.sum(-1),
                              torch.zeros_like(lse)).sum() if with_smooth
                  else lse.new_zeros(()))
        ctx.save_for_backward(logits, input_lengths, target_lengths, labels,
                              can_skip, lse, em, alphas, nll_b, keep)
        ctx.with_smooth = with_smooth
        return nll_sum, smooth

    @staticmethod
    def backward(ctx, gy_nll, gy_smooth):
        (logits, input_lengths, target_lengths, labels, can_skip, lse, em,
         alphas, nll_b, keep) = ctx.saved_tensors
        b, t, v = logits.shape
        scale = -gy_nll * keep.float()
        d_em = ctc_d_em(em, alphas, can_skip, input_lengths, target_lengths,
                        scale, nll_b).permute(1, 0, 2)             # (B, T, S)
        dlogits = torch.zeros(b, t, v, dtype=torch.float32,
                              device=logits.device)
        dlogits.scatter_add_(2, labels[:, None, :].expand(b, t, -1), d_em)
        valid = (torch.arange(t, device=logits.device)[None, :] <
                 input_lengths[:, None]).float()
        d_lse = -d_em.sum(-1)
        if ctx.with_smooth:
            d_lse = d_lse + gy_smooth * v * valid
        dlogits += d_lse[:, :, None] * torch.exp(logits.float()
                                                 - lse[:, :, None])
        if ctx.with_smooth:
            dlogits -= gy_smooth * valid[:, :, None]
        return dlogits.to(logits.dtype), None, None, None, None, None, None


def ctc_raw_smoothed(logits, input_lengths, targets, target_lengths,
                     blank: int = 0, zero_infinity: bool = True,
                     with_smooth: bool = True):
    """(nll_sum, smooth_sum) from RAW logits (B, T, V): nll_sum equals
    ctc_loss(log_softmax(logits), ...); smooth_sum is the sum over valid
    frames of -sum_v log_softmax(logits)[t, v] (0 when not with_smooth).
    Gradients flow to logits only."""
    return _CTCRawSmoothed.apply(logits, input_lengths, targets,
                                 target_lengths, blank, zero_infinity,
                                 with_smooth)


def ctc_loss_raw(logits, input_lengths, targets, target_lengths,
                 blank: int = 0, zero_infinity: bool = True):
    """The CTC nll sum from RAW logits: ctc_loss(log_softmax(logits), ...)
    through the alpha / d_em kernels, without the smoothing term."""
    return ctc_raw_smoothed(logits, input_lengths, targets, target_lengths,
                            blank, zero_infinity, False)[0]


def ctc_loss(log_probs, input_lengths, targets, target_lengths,
             blank: int = 0, zero_infinity: bool = True):
    """Sum-reduced CTC negative log likelihood of log-softmaxed (B, T, V)
    log_probs and right-padded targets (B, L), F.ctc_loss's semantics;
    differentiable through autograd."""
    labels, can_skip = _ctc_masks(targets.long(), blank)
    em = _emissions(log_probs, labels)
    alpha = _alphas(em, can_skip, input_lengths, target_lengths)[-1]
    nll = _nll_from_alpha(alpha, target_lengths)
    if zero_infinity:
        nll = torch.where((nll > -NEG / 2) | ~torch.isfinite(nll),
                          torch.zeros_like(nll), nll)
    return nll.sum()


def best_alignment(log_probs, input_lengths, targets, target_lengths,
                   blank: int = 0):
    """CTC Viterbi forced alignment: (B, T) int64 augmented-state indices
    (even = blank, odd s -> target[(s - 1) // 2]); frames at t >=
    input_length repeat the final state."""
    labels, can_skip = _ctc_masks(targets.long(), blank)
    em = _emissions(log_probs, labels)
    t_len, _, s = em.shape
    alpha = _alpha0(em[0], target_lengths)
    choices = [torch.zeros_like(labels)]
    for t in range(1, t_len):
        a1 = torch.cat([_neg_col(alpha), alpha], 1)[:, :s]
        a2 = torch.cat([_neg_col(alpha, 2), alpha], 1)[:, :s]
        a2 = torch.where(can_skip, a2, torch.full_like(a2, NEG))
        best, choice = torch.stack([alpha, a1, a2]).max(dim=0)
        live = (t < input_lengths)[:, None]
        alpha = torch.where(live, em[t] + best, alpha)
        choices.append(torch.where(live, choice, torch.zeros_like(choice)))
    end = 2 * target_lengths.long()
    a_last = alpha.gather(1, end[:, None])[:, 0]
    masked = torch.where((target_lengths > 0)[:, None], alpha,
                         torch.full_like(alpha, NEG))
    prev = torch.clamp(end - 1, min=0)
    a_prev = masked.gather(1, prev[:, None])[:, 0]
    state = torch.where(a_last >= a_prev, end, prev)
    states = [None] * t_len
    for t in range(t_len - 1, -1, -1):
        states[t] = state
        ch = choices[t].gather(1, state[:, None])[:, 0]
        state = torch.where(t < input_lengths, state - ch, state)
    return torch.stack(states, dim=1)


def alignment_to_labels(states, targets, blank: int = 0):
    """Augmented-state indices (B, T) -> label ids."""
    return ctc_labels(targets.long(), blank).gather(1, states.long())


ctc_alphas.launches = 0
ctc_d_em.launches = 0
