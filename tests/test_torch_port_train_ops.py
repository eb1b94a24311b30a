"""The backward passes and dropout masks of simulst_tpu_torch's kernels, on
the CPU.

fused_ffn's and fused_linear_res's plain backwards (what their autograd
Functions run on a CPU tensor, mirroring the JAX _bwd_kernel formulas) vs
jax.vjp of the JAX functions at dropout 0: ffn_reference (exact GELU, as
the port) for gelu and relu, and fused_ffn / fused_linear_drop_res in
Pallas interpret mode for relu and the linear epilogue.  Seeded numpy
inputs, fp32; tolerance atol 1e-5, rtol 1e-5 (order of sums only).  Then
the Philox masks: keep rate within 3 sigma, forward and backward drawing
the same mask, two seeds drawing different masks.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from simulst_tpu.ops.ffn_pallas import ffn_reference  # noqa: E402
from simulst_tpu.ops.ffn_pallas import fused_ffn as j_fused_ffn  # noqa: E402
from simulst_tpu.ops.linear_res_pallas import fused_linear_drop_res  # noqa: E402
from simulst_tpu_torch.ops.ffn import ffn_plain, fused_ffn  # noqa: E402
from simulst_tpu_torch.ops.linear_res import fused_linear_res  # noqa: E402
from simulst_tpu_torch.ops.philox import drop_scale, keep_mask  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
SEED0 = jnp.array([0], jnp.int32)


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _torch_grads(fn, arrays, dy):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    out.backward(torch.from_numpy(dy))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("activation", ["relu", "gelu"])
@pytest.mark.parametrize("rows", [5, 130])
def test_ffn_backward_matches_jax_vjp(activation, rows):
    rng = np.random.RandomState(rows)
    arrays = (_rand(rng, rows, 64), _rand(rng, 64, 128, scale=0.1),
              _rand(rng, 128, scale=0.1), _rand(rng, 128, 64, scale=0.1),
              _rand(rng, 64, scale=0.1))
    dy = _rand(rng, rows, 64)
    refs = [lambda *a: ffn_reference(*a, None, None, activation)]
    if activation == "relu":     # interpret-mode tanh GELU differs from erf
        refs.append(lambda *a: j_fused_ffn(*a, SEED0, "relu", 0.0, 0.0, True))
    out, grads = _torch_grads(
        lambda *t: fused_ffn(*t, activation=activation), arrays, dy)
    for ref_fn in refs:
        ref, vjp = jax.vjp(ref_fn, *map(jnp.asarray, arrays))
        np.testing.assert_allclose(out, np.asarray(ref), **TOL)
        for got, want in zip(grads, vjp(jnp.asarray(dy))):
            np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("period,res_rows", [(0, 0), (50, 46)])
def test_linear_res_backward_matches_jax_vjp(period, res_rows):
    rng = np.random.RandomState(period)
    arrays = (_rand(rng, 150, 128), _rand(rng, 128, 128, scale=0.05),
              _rand(rng, 128, scale=0.05), _rand(rng, 150, 128))
    dy = _rand(rng, 150, 128)
    ref, vjp = jax.vjp(
        lambda h, w, b, r: fused_linear_drop_res(h, w, b, r, SEED0, 0.0,
                                                 period, res_rows, True),
        *map(jnp.asarray, arrays))
    out, grads = _torch_grads(
        lambda *t: fused_linear_res(*t, period, res_rows), arrays, dy)
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    for got, want in zip(grads, vjp(jnp.asarray(dy))):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_philox_keep_rate_within_3_sigma(rate):
    n = 200_000
    kept = keep_mask(7, (n,), rate).sum().item()
    sigma = (n * rate * (1 - rate)) ** 0.5
    assert abs(kept - n * (1 - rate)) < 3 * sigma


def test_philox_seeds_and_streams_differ():
    a = keep_mask(1, (64, 64), 0.5)
    assert not torch.equal(a, keep_mask(2, (64, 64), 0.5))
    assert not torch.equal(a, keep_mask(1, (64, 64), 0.5, stream=1))
    assert torch.equal(a, keep_mask(1, (64, 64), 0.5))


def test_dropout_masks_match_between_forward_and_backward():
    """The forward and the plain backward of fused_ffn and fused_linear_res
    apply the masks ops/philox.py draws for (seed, offset): the same
    functions written out with those masks give the same outputs, and
    torch autograd through them the same gradients."""
    rng = np.random.RandomState(3)
    x, w1, b1 = _rand(rng, 20, 16), _rand(rng, 16, 64), _rand(rng, 64)
    w2, b2, dy = _rand(rng, 64, 16), _rand(rng, 16), _rand(rng, 20, 16)
    seed, rate = 12345, 0.3
    ma = drop_scale(seed, (20, 64), rate, 0)
    mo = drop_scale(seed, (20, 16), rate, 1)
    assert (ma == 0).any() and (mo == 0).any()

    def explicit(x_, w1_, b1_, w2_, b2_):
        return ((torch.relu(x_ @ w1_ + b1_) * ma) @ w2_ + b2_) * mo

    out_e, grads_e = _torch_grads(explicit, (x, w1, b1, w2, b2), dy)
    out_k, grads_k = _torch_grads(
        lambda *t: fused_ffn(*t, "relu", rate, rate, seed),
        (x, w1, b1, w2, b2), dy)
    np.testing.assert_allclose(out_k, out_e, **TOL)
    for got, want in zip(grads_k, grads_e):
        np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        ffn_plain(*map(torch.from_numpy, (x, w1, b1, w2, b2)), "relu", rate,
                  rate, seed).numpy(), out_e, **TOL)

    args = (x, _rand(rng, 16, 64), _rand(rng, 64), _rand(rng, 20, 64))
    dy = _rand(rng, 20, 64)
    m = drop_scale(seed, (20, 64), rate, 0)
    out_e, grads_e = _torch_grads(
        lambda h_, w_, b_, r_: r_ + (h_ @ w_ + b_) * m, args, dy)
    out_k, grads_k = _torch_grads(
        lambda *t: fused_linear_res(*t, 0, 0, rate, seed), args, dy)
    np.testing.assert_allclose(out_k, out_e, **TOL)
    for got, want in zip(grads_k, grads_e):
        np.testing.assert_allclose(got, want, **TOL)
