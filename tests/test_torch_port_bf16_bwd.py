"""The bf16 backwards of the FFN and the linear-res epilogue, and the CTC
dynamic programme above S 1024, in simulst_tpu_torch vs the JAX package,
on the CPU.

On the card the FFN backward (`fused_ffn`) and the linear-res backward
(`fused_linear_drop_res`) run their bf16 products on the tensor cores and
are held there to their plain versions (tests/test_torch_port_cuda.py);
here the plain bf16 backwards are held to JAX's XLA backward in bf16 (the
path the JAX package takes off the TPU: `ffn_reference`, and the
Emformer's `linear` plus its gated residual), at rate 0, seeded numpy
inputs, JAX with jax_default_matmul_precision float32
(tests/conftest.py).  The activation gradient (dx, dh) is held to JAX's
at BF16_TOL (chip_smoke's: atol 3e-2, rtol 1e-2) entry by entry.  JAX
returns the weight and bias gradients in bf16, rounded and summed there
(up to 1.4e-2 of their largest entry from JAX's fp32 backward at these
shapes), where the port keeps them in fp32 as the Pallas kernels do; so
each is held within BF16_GRAD_RTOL (2e-2) of its largest entry of JAX's
bf16 gradient, and no further from JAX's fp32 backward on the same
inputs than BF16_RATIO (2) times JAX's own bf16 gradient is.  With relu
the port's backward runs under JAX's relu mask (u > 0 of JAX's bf16 u;
the two u differ by a bf16 rounding, which can flip an entry near 0).

The CTC cases run S = 2L + 1 = 1025 and 2049 states, the shapes the card's
kernels take with several states a thread, B 2 and T a few frames above
the target length: the port's `ctc_loss` and its gradient against JAX's,
its `ctc_raw_smoothed` (the CPU side of the card's alpha and d_em
kernels) and its gradient, and the plain alphas against JAX's XLA scan
(finite entries atol 1e-5 and rtol 1e-6, sentinels equal, as
tests/test_torch_port_asr.py holds the DP).  The logits favour each
target label at its frame on the diagonal alignment, as a trained model's
do: the occupancy posteriors then lie on few paths, whose running sums
stay small.  (On random logits over a thousand frames the posteriors
spread over paths whose log-probabilities reach -3000, where the two
frameworks' logaddexp roundings, an ulp of the running sum per frame,
move a posterior by 1e-3.)
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each
import jax.numpy as jnp  # noqa: E402

from simulst_tpu.nn.core import linear as j_linear  # noqa: E402
from simulst_tpu.ops import ctc as jctc  # noqa: E402
from simulst_tpu.ops.ffn_pallas import ffn_reference  # noqa: E402
from simulst_tpu_torch.ops import ctc as tctc  # noqa: E402
from simulst_tpu_torch.ops import ffn as tffn  # noqa: E402
from simulst_tpu_torch.ops import linear_res as tlr  # noqa: E402

BF16_TOL = dict(atol=3e-2, rtol=1e-2)   # chip_smoke.BF16_TOL
BF16_GRAD_RTOL = 2e-2
BF16_RATIO = 2.0
ROWS = 40


def _bf16(rng, *shape, scale=1.0):
    """A seeded bf16 array as numpy fp32 (its values exact in bf16)."""
    a = (rng.randn(*shape) * scale).astype(np.float32)
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _t(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _j(a):
    return jnp.asarray(a, jnp.bfloat16)


def _hold(got, want_bf16, want_f32, names):
    """The port's bf16 backward (torch) against JAX's in bf16 and fp32
    (jax arrays): the first output at BF16_TOL, the others, weight and
    bias gradients, as the module docstring says."""
    for i, (name, a, b, c) in enumerate(zip(names, got, want_bf16,
                                            want_f32)):
        a = a.float().numpy()
        b, c = np.asarray(b.astype(jnp.float32)), np.asarray(c)
        if i == 0:
            np.testing.assert_allclose(a, b, **BF16_TOL, err_msg=name)
            continue
        assert np.abs(a - b).max() <= BF16_GRAD_RTOL * np.abs(b).max(), name
        assert np.abs(a - c).max() <= BF16_RATIO * np.abs(b - c).max(), name


@pytest.mark.parametrize("d,hidden", [(256, 512), (200, 800)])
@pytest.mark.parametrize("activation", ["gelu", "relu"])
def test_ffn_bf16_backward_matches_jax_xla(monkeypatch, activation, d,
                                           hidden):
    """dx, dW1, db1, dW2, db2 of the port's plain bf16 FFN backward
    against jax.vjp of `ffn_reference` in bf16 and fp32, rate 0 (`_hold`);
    D 256 / FFN 512 and the padded D 200 / FFN 800."""
    rng = np.random.RandomState(d + hidden)
    xav = (6.0 / (d + hidden)) ** 0.5
    x, dy = _bf16(rng, ROWS, d), _bf16(rng, ROWS, d)
    w1, b1 = _bf16(rng, d, hidden, scale=xav), _bf16(rng, hidden, scale=0.02)
    w2, b2 = _bf16(rng, hidden, d, scale=xav), _bf16(rng, d, scale=0.02)
    fn = lambda *a: ffn_reference(*a, None, None, activation)  # noqa: E731
    _, vjp = jax.vjp(fn, *map(_j, (x, w1, b1, w2, b2)))
    want = vjp(_j(dy))
    _, vjp = jax.vjp(fn, *map(jnp.asarray, (x, w1, b1, w2, b2)))
    want_f32 = vjp(jnp.asarray(dy))
    if activation == "relu":   # under JAX's mask: u > 0 of its bf16 u
        mask = torch.from_numpy(np.array((_j(x) @ _j(w1) + _j(b1)) > 0))
        monkeypatch.setattr(tffn, "_act_grad",
                            lambda name, u: mask.to(u.dtype))
    got = tffn.ffn_plain_backward(_t(x), _t(w1), _t(b1), _t(w2), _t(dy),
                                  activation)
    # both in the order (dx, dW1, db1, dW2, db2)
    _hold(got, want, want_f32, ("dx", "dw1", "db1", "dw2", "db2"))


@pytest.mark.parametrize("period,res_rows", [(0, 0), (7, 5)])
def test_linear_res_bf16_backward_matches_jax_xla(period, res_rows):
    """dh, dW, db of the port's plain bf16 linear-res backward against
    jax.vjp of the JAX package's XLA path in bf16 and fp32 (`linear`, then
    the residual on rows with row % period < res_rows), rate 0 (`_hold`);
    gated (period 7, 5 residual rows) and ungated."""
    rng = np.random.RandomState(period + 3)
    d = 256
    h, res, dy = (_bf16(rng, ROWS, d) for _ in range(3))
    w, b = _bf16(rng, d, d, scale=d ** -0.5), _bf16(rng, d, scale=0.02)
    rows = np.arange(ROWS)[:, None]
    gate = (rows % period < res_rows) if period else np.ones((ROWS, 1),
                                                              bool)

    def fn(h_, w_, b_):
        y = j_linear({"weight": w_, "bias": b_}, h_)
        return jnp.where(gate, y + jnp.asarray(res, h_.dtype), y)
    _, vjp = jax.vjp(fn, _j(h), _j(w), _j(b))
    want = vjp(_j(dy))
    _, vjp = jax.vjp(fn, *map(jnp.asarray, (h, w, b)))
    want_f32 = vjp(jnp.asarray(dy))
    got = tlr.linear_res_plain_backward(_t(h), _t(w), _t(dy), period,
                                        res_rows)
    _hold(got, want, want_f32, ("dh", "dw", "db"))


def _peaked_ctc_case(L, extra=4, v=17):
    """B 2, T = L + extra frames, V v: targets of L and L - 3 labels (one
    repeat, which needs a blank between), logits favouring target label i
    at frame i and blank past the labels (scale 2 noise, +8 boosts)."""
    rng = np.random.RandomState(L)
    t = L + extra
    logits = (rng.randn(2, t, v) * 2.0).astype(np.float32)
    targets = rng.randint(1, v, (2, L)).astype(np.int32)
    targets[0, 5] = targets[0, 4]
    tgt_len = np.array([L, L - 3], np.int32)
    for b in range(2):
        n = tgt_len[b]
        logits[b, np.arange(n), targets[b, :n]] += 8.0
        logits[b, n:, 0] += 8.0
    in_len = np.array([t, t - 1], np.int32)
    return logits, in_len, targets, tgt_len


@pytest.mark.parametrize("L", [512, 1024])
def test_ctc_above_1024_states_matches_jax(L):
    """S 1025 and 2049: ctc_loss on log-probs (rtol 1e-5) and its autograd
    gradient (atol 1e-5), ctc_raw_smoothed's sums (rtol 1e-5) and dlogits
    (atol 1e-5), the plain alphas against JAX's XLA scan (finite entries
    atol 1e-5 rtol 1e-6, the -1e30 sentinels equal)."""
    logits, in_len, targets, tgt_len = _peaked_ctc_case(L)
    j_args = [jnp.asarray(a) for a in (in_len, targets, tgt_len)]
    t_args = [torch.from_numpy(a) for a in (in_len, targets, tgt_len)]

    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits), -1))
    loss_j, grad_j = jax.value_and_grad(
        lambda x: jctc.ctc_loss(x, *j_args))(jnp.asarray(lp))
    lt = torch.from_numpy(lp).requires_grad_()
    loss_t = tctc.ctc_loss(lt, *t_args)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(grad_j),
                               atol=1e-5, rtol=0)

    (nll_j, sm_j), res = jctc._ctc_ab_fwd(jnp.asarray(logits), *j_args, 0,
                                          True, True)
    _, vjp = jax.vjp(lambda lg: jctc.ctc_raw_smoothed(lg, *j_args),
                     jnp.asarray(logits))
    (dlogits_j,) = vjp((jnp.float32(1.0), jnp.float32(0.1)))
    lg = torch.from_numpy(logits).requires_grad_()
    nll_t, sm_t = tctc.ctc_raw_smoothed(lg, *t_args)
    (nll_t + 0.1 * sm_t).backward()
    np.testing.assert_allclose(nll_t.item(), float(nll_j), rtol=1e-5)
    np.testing.assert_allclose(sm_t.item(), float(sm_j), rtol=1e-5)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(dlogits_j),
                               atol=1e-5, rtol=0)

    alphas_j = np.asarray(res[6])
    labels, can_skip = tctc._ctc_masks(t_args[1].long(), 0)
    em = (tctc._emissions(torch.from_numpy(logits), labels)
          - torch.logsumexp(torch.from_numpy(logits), -1).T[:, :, None])
    alphas_t = tctc.alphas_plain(em, can_skip, t_args[0], t_args[2]).numpy()
    assert alphas_t.shape == (L + 4, 2, 2 * L + 1)
    sentinel = alphas_j <= tctc.NEG / 2
    np.testing.assert_array_equal(alphas_t[sentinel], alphas_j[sentinel])
    np.testing.assert_allclose(alphas_t[~sentinel], alphas_j[~sentinel],
                               atol=1e-5, rtol=1e-6)
