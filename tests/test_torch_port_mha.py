"""simulst_tpu_torch fused_mha (plain forward and backward, what the
wrapper runs on a CPU tensor) vs the JAX package's fused_mha in Pallas
interpret mode and its jax.vjp, on the CPU.

Seeded numpy inputs, fp32, width 32 with 2 heads; causal and not, ragged
key masks, and a batch row whose keys are all masked (its query rows see
no key and must come out as exact zeros).  Tolerance atol 2e-5, rtol 2e-5:
the JAX kernel's exp(min(s, 80)) with a 1e-30 denominator and the port's
running-max softmax agree to fp32 rounding at these scores.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from simulst_tpu.ops.mha_pallas import fused_mha as j_fused_mha  # noqa: E402
from simulst_tpu_torch.ops.mha import (  # noqa: E402
    KEY_TILE, backward_scratch_shapes, fused_mha, fused_mha_backward,
    mha_plain)

H, D = 2, 32
TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(seed, b, tq, tk, empty_row):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(b, t, D).astype(np.float32)
                   for t in (tq, tk, tk, tq))
    lengths = rng.randint(1, tk + 1, size=b)
    kmask = (np.arange(tk)[None, :] < lengths[:, None]).astype(np.int32)
    if empty_row:
        kmask[-1] = 0
    return q, k, v, kmask, do


@pytest.mark.parametrize("causal,tq,tk,empty_row", [
    (True, 12, 12, False),
    (False, 9, 14, True),
    (False, 16, 16, False),
])
def test_fused_mha_plain_matches_pallas_interpret(causal, tq, tk, empty_row):
    q, k, v, kmask, do = _inputs(tq + tk, 3, tq, tk, empty_row)
    seed = jnp.array([0], jnp.int32)

    def jf(q_, k_, v_):
        return j_fused_mha(q_, k_, v_, jnp.asarray(kmask), seed, H, causal,
                           0.0, True)

    ref, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_grads = vjp(jnp.asarray(do))
    tq_, tk_, tv_ = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fused_mha(tq_, tk_, tv_, torch.from_numpy(kmask), H, causal)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    for got, want in zip((tq_.grad, tk_.grad, tv_.grad), ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if empty_row:
        assert not out[-1].any()


@pytest.mark.parametrize("causal,tk", [(False, 23), (False, 64),
                                       (True, 9)])
def test_fused_mha_decoder_step_matches_pallas_interpret(causal, tk):
    """Tq = 1, the decoder step's cross-attention, which the CUDA forward
    runs on its decode kernel: 5 rows (a beam) with ragged key masks and
    one row whose keys are all masked (exact zeros)."""
    q, k, v, kmask, do = _inputs(70 + tk, 5, 1, tk, True)
    seed = jnp.array([0], jnp.int32)

    def jf(q_, k_, v_):
        return j_fused_mha(q_, k_, v_, jnp.asarray(kmask), seed, H, causal,
                           0.0, True)

    ref, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_grads = vjp(jnp.asarray(do))
    tq_, tk_, tv_ = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fused_mha(tq_, tk_, tv_, torch.from_numpy(kmask), H, causal)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    for got, want in zip((tq_.grad, tk_.grad, tv_.grad), ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not out[-1].any()


def test_fused_mha_backward_entry_matches_autograd():
    """fused_mha_backward (the entry the CUDA kernel serves) gives what
    autograd through fused_mha gives, with dropout on."""
    q, k, v, kmask, do = _inputs(5, 2, 10, 10, False)
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    km = torch.from_numpy(kmask)
    out = fused_mha(*t, km, H, True, 0.1, 321)
    out.backward(torch.from_numpy(do))
    got = fused_mha_backward(*(x.detach() for x in t), km, out.detach(), None,
                             torch.from_numpy(do), H, True, 0.1, 321)
    for g, x in zip(got, t):
        torch.testing.assert_close(g, x.grad, atol=0, rtol=0)
    torch.testing.assert_close(out, mha_plain(*t, km, H, True, 0.1, 321),
                               atol=0, rtol=0)


# (B, heads, Tq, Tk) -> the dS scratch's last axis: Tk rounded up to whole
# 64-key tiles, which the dK / dV kernel writes in full and the dQ kernel
# reads as aligned 16-byte rows
@pytest.mark.parametrize("b,heads,tq,tk,tk64", [
    (64, 4, 128, 128, 128),   # MT decoder self-attention
    (32, 4, 72, 256, 256),    # ASR decoder cross-attention
    (32, 4, 72, 72, 128),     # ASR decoder self-attention
    (3, 4, 50, 77, 128),
    (1, 4, 1, 1, 64)])        # a decoder step
def test_backward_scratch_shapes(b, heads, tq, tk, tk64):
    delta, ds = backward_scratch_shapes(b, heads, tq, tk)
    assert delta == (b, heads, tq)
    assert ds == (b, heads, tq, tk64)
    assert ds[-1] % KEY_TILE == 0 and ds[-1] - tk < KEY_TILE
