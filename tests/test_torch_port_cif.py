"""The CIF slice of simulst_tpu_torch vs the JAX package, on the CPU: the
integrate-and-fire product (plain version vs the JAX einsum twin and the
Pallas kernel in interpret mode, gradients vs the custom VJP, and the
autograd Function that wraps the CUDA kernel on the card, its kernel
replaced by the plain version), `cif_function` with and without teacher
forcing, the streaming CIF layer against the offline one and JAX's, the
CIF loss and every gradient of a small CIFModel, and `cif_decoder_step`.

Small model: 2 + 2 layers, width 64, 2 heads, FFN 64, vocab 40, segment 4
/ left context 8 / right context 2 frames after subsampling, the CTC head;
JAX init bridged to the port (compat/jax_bridge.load_jax_params); inputs
from numpy seeds; fp32 with jax_default_matmul_precision float32
(tests/conftest.py); dropout 0.  Tolerances: the product, its delays and
the CIF outputs rtol 1e-5 and atol 1e-5 plus what the cumulative sums'
rounding moves (`_tol`: XLA's cumsum does not add in order, and the two
cumsums differ by up to an ulp of the largest sum, 7.6e-6 at a sum of
70, which shifts a portion by as much); fire counts and lengths exactly;
gradients within 1e-5 of their largest entry for the product, 1e-4
for `cif_function` and the model (a key bias of its weight's); the loss and its metrics rtol 1e-5; decoder-step logits
atol 1e-4, rtol 1e-4.  The fire counts floor(sum(alpha) / beta) are
exact here: every test's sums lie more than 1e-3 from a multiple of beta
(asserted where a count is compared), far beyond fp32 rounding.
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each
import jax.numpy as jnp  # noqa: E402

from simulst_tpu.losses import cif_loss as jcl  # noqa: E402
from simulst_tpu.models import cif as jcif  # noqa: E402
from simulst_tpu.ops import cif as jops  # noqa: E402
from simulst_tpu.ops import cif_pallas as cp  # noqa: E402
from simulst_tpu_torch.compat.jax_bridge import load_jax_params  # noqa: E402
from simulst_tpu_torch.losses import cif_loss as tcl  # noqa: E402
from simulst_tpu_torch.models import cif as tcif  # noqa: E402
from simulst_tpu_torch.ops import cif as tops  # noqa: E402
from simulst_tpu_torch.ops import cif_integrate as ci  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = dict(vocab_size=40, input_feat=8, conv_channels=16, embed_dim=64,
             ffn_dim=64, encoder_layers=2, encoder_heads=2, decoder_layers=2,
             decoder_heads=2, decoder_ffn_dim=64, segment_length=16,
             left_context=32, right_context=8, max_memory=2,
             max_target_positions=64, dropout=0.0, attention_dropout=0.0,
             activation_dropout=0.0)


def _inputs(seed, b, s, c):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, c).astype(np.float32)
    alpha = (1.0 / (1.0 + np.exp(-rng.randn(b, s)))).astype(np.float32)
    return x, alpha


def _t(a):
    return torch.from_numpy(np.array(a))


def _tol(x, alpha, beta):
    """(out, delays) tolerances: rtol 1e-5, atol 1e-5 plus four ulps of the
    largest cumulative sum, times the largest |x| for out and the frame
    count / beta for the delays (a shifted bucket edge moves two
    portions)."""
    ulp = float(np.spacing(np.float32(alpha.sum(axis=1).max())))
    return (dict(rtol=1e-5, atol=1e-5 + 4 * ulp * np.abs(x).max()),
            dict(rtol=1e-5, atol=1e-5 + 4 * ulp * x.shape[1] / beta))


def _close_to_largest(got, want, rtol, name="", scale=None):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    ref = np.abs(np.asarray(want if scale is None else scale)).max()
    assert err <= rtol * max(ref, 1e-30), (name, err, ref)


def _away_from_fires(alpha_sum, beta, margin=1e-3):
    """The fire counts floor(alpha_sum / beta) are not within rounding of a
    step."""
    r = np.asarray(alpha_sum, np.float64) / beta
    assert (np.abs(r - np.round(r)) > margin).all(), r


@pytest.fixture
def interpret(monkeypatch):
    """The Pallas kernel in interpret mode, as tests/test_cif_pallas.py
    runs it."""
    monkeypatch.setattr(cp.pl, "pallas_call",
                        functools.partial(cp.pl.pallas_call, interpret=True))


@pytest.mark.parametrize("b,s,t,c,beta", [(2, 40, 16, 8, 1.0),
                                          (2, 130, 128, 16, 1.0),
                                          (1, 100, 130, 8, 0.8),
                                          (3, 29, 1, 4, 1.0)])
def test_plain_matches_reference_and_pallas(b, s, t, c, beta, interpret):
    x, alpha = _inputs(s + t, b, s, c)
    got = ci.cif_integrate_plain(_t(x), _t(alpha), beta, t)
    ref = cp.cif_integrate_reference(jnp.asarray(x), jnp.asarray(alpha),
                                     beta, t)
    pallas = cp._forward_pallas(jnp.asarray(x), jnp.asarray(alpha), beta, t)
    for g, r, p, tol in zip(got, ref, pallas, _tol(x, alpha, beta)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **tol)
        np.testing.assert_allclose(g.numpy(), np.asarray(p), **tol)
    assert ci.cif_integrate(_t(x), _t(alpha), beta, t)[0].shape == (b, t, c)


@pytest.mark.parametrize("beta", [1.0, 0.8])
@pytest.mark.parametrize("through_function", [False, True])
def test_gradients_match_custom_vjp(beta, through_function, interpret,
                                    monkeypatch):
    """d(sum out^2 + sum delays) by x and alpha: the plain version under
    autograd, or the autograd Function the card runs (its kernel replaced
    by the plain forward), vs jax.grad through cif_integrate's custom VJP
    over the Pallas kernel."""
    x, alpha = _inputs(2, 2, 20, 4)
    t = 16

    def f_jax(xx, aa):
        out, delays = cp.cif_integrate(xx, aa, beta, t)
        return (out ** 2).sum() + delays.sum()

    gx_j, ga_j = jax.grad(f_jax, argnums=(0, 1))(jnp.asarray(x),
                                                 jnp.asarray(alpha))
    xt, at = _t(x).requires_grad_(), _t(alpha).requires_grad_()
    if through_function:
        monkeypatch.setattr(ci, "cif_integrate_forward",
                            ci.cif_integrate_plain)
        out, delays = ci._CIFIntegrate.apply(xt, at, beta, t)
    else:
        out, delays = ci.cif_integrate_plain(xt, at, beta, t)
    ((out ** 2).sum() + delays.sum()).backward()
    _close_to_largest(xt.grad.numpy(), gx_j, 1e-5, "dx")
    _close_to_largest(at.grad.numpy(), ga_j, 1e-5, "dalpha")


@pytest.mark.parametrize("teacher", [False, True])
@pytest.mark.parametrize("beta,tail_thres", [(1.0, 0.5), (0.8, 0.4),
                                             (1.0, 0.0)])
def test_cif_function_matches_jax(teacher, beta, tail_thres):
    """Every CifOut field, and the gradients by x and alpha of a weighted
    sum of out and delays (the delays linear, as DAL takes them: a square
    would cube the tail's 1 / tail_weight scale, and a tail weight of
    0.083, counted at tail_thres 0, turns the sums' rounding into 3e-4 of
    the largest gradient; linear, 8e-5)."""
    x, alpha = _inputs(5, 3, 24, 6)
    alpha[1, 18:] = 0.0                       # padding
    t = 12 if teacher else 34
    tgt = np.array([9, 4, 11], np.int64)
    _away_from_fires(alpha.sum(1), beta)
    kw = dict(beta=beta, tail_thres=tail_thres, max_out_len=t)
    w = np.random.RandomState(6).randn(t, 6).astype(np.float32)
    v = np.random.RandomState(7).randn(t).astype(np.float32)

    def f_jax(xx, aa):
        r = jops.cif_function(xx, aa, target_lengths=jnp.asarray(tgt)
                              if teacher else None, **kw)
        return (r.cif_out * w).sum() + (r.delays * v).sum(), r

    (_, rj), (gx_j, ga_j) = jax.value_and_grad(
        f_jax, argnums=(0, 1), has_aux=True)(jnp.asarray(x),
                                             jnp.asarray(alpha))
    xt, at = _t(x).requires_grad_(), _t(alpha).requires_grad_()
    r = tops.cif_function(xt, at, target_lengths=_t(tgt) if teacher
                          else None, **kw)
    ((r.cif_out * _t(w)).sum() + (r.delays * _t(v)).sum()).backward()
    np.testing.assert_array_equal(r.cif_lengths.numpy(),
                                  np.asarray(rj.cif_lengths))
    tol_out, tol_delays = _tol(x, alpha, beta)
    for name, tol in (("cif_out", tol_out), ("alpha_sum", TOL),
                      ("delays", tol_delays), ("tail_weights", TOL)):
        np.testing.assert_allclose(getattr(r, name).detach().numpy(),
                                   np.asarray(getattr(rj, name)),
                                   err_msg=name, **tol)
    _close_to_largest(xt.grad.numpy(), gx_j, 1e-4, "dx")
    _close_to_largest(at.grad.numpy(), ga_j, 1e-4, "dalpha")


def _layer_pair(beta, seed=0):
    cfg_kw = dict(SMALL, cif_beta=beta)
    jcfg = jcif.CIFConfig(**cfg_kw)
    jp = jcif.cif_layer_init(jax.random.PRNGKey(seed), jcfg)
    layer = tcif.CIFLayer(tcif.CIFConfig(**cfg_kw))
    layer.load_state_dict(load_jax_params(jax.tree_util.tree_map(np.asarray,
                                                                 jp)))
    return jcfg, jp, tcif.CIFConfig(**cfg_kw), layer


@pytest.mark.parametrize("beta", [1.0, 0.8])
@pytest.mark.parametrize("chunks", [[5, 5, 5, 5], [7, 6, 0, 4, 3], [20]])
def test_cif_layer_step_streams_as_offline_and_as_jax(beta, chunks):
    """Chunks of encoder frames through cif_layer_step (the carried tail,
    the conv cache, an empty chunk) emit, all together, the offline
    cif_layer_forward's fired features; each step's fired features and
    counts equal JAX's cif_layer_step's."""
    jcfg, jp, cfg, layer = _layer_pair(beta)
    s = sum(chunks)
    x = np.random.RandomState(7).randn(1, s, 64).astype(np.float32)
    with torch.no_grad():
        off, alpha = tcif.cif_layer_forward(
            layer, cfg, _t(x), torch.ones(1, s, dtype=torch.bool),
            max_out_len=s + 2)
    _away_from_fires(alpha.sum(1).numpy(), beta)
    n_off = int(off.cif_lengths[0])
    jstate = jcif.cif_layer_init_state(jp, jcfg, 1)
    state = tcif.cif_layer_init_state(layer, cfg, 1)
    outs, t0 = [], 0
    for i, c in enumerate(chunks):
        finish = i == len(chunks) - 1
        xc = x[:, t0:t0 + c]
        t0 += c
        fj, nj, jstate = jcif.cif_layer_step(jp, jcfg, jstate,
                                             jnp.asarray(xc), finish)
        with torch.no_grad():
            fired, n, state = tcif.cif_layer_step(layer, cfg, state, _t(xc),
                                                  finish)
        assert int(n[0]) == int(nj[0])
        np.testing.assert_allclose(fired.numpy(), np.asarray(fj), **TOL)
        np.testing.assert_allclose(state.prev_weight.numpy(),
                                   np.asarray(jstate.prev_weight), **TOL)
        outs.append(fired[:, :int(n[0])])
    streamed = torch.cat(outs, dim=1)
    assert streamed.shape[1] == n_off
    np.testing.assert_allclose(streamed.numpy(), off.cif_out[:, :n_off],
                               rtol=1e-4, atol=1e-5)


# (name, config overrides, loss overrides)
MODEL_CASES = [
    ("fake+highway+sg_alpha, quant sum, DAL 0.1",
     dict(cif_highway=True, cif_sg_alpha=True),
     dict(quant_type="sum", latency_factor=0.1)),
    ("fake, quant align", {}, dict(quant_type="align")),
    ("infinite lookback, beta 0.8, quant align",
     dict(cif_infinite_lookback=True, cif_beta=0.8),
     dict(quant_type="align", latency_factor=0.1)),
]


def _batch():
    """Two utterances of 96 / 70 frames with 7 / 4 target tokens + EOS."""
    rng = np.random.RandomState(9)
    target = np.ones((2, 8), np.int64)
    prev = np.ones((2, 8), np.int64)
    for j, n in enumerate((7, 4)):
        toks = np.append(rng.randint(4, 40, n), 2)
        target[j, :n + 1] = toks
        prev[j, :n + 1] = np.append(2, toks[:-1])
    return {"feats": rng.randn(2, 96, 8).astype(np.float32),
            "feat_lengths": np.array([96, 70], np.int64),
            "target": target, "prev_tokens": prev}


@pytest.mark.parametrize("case", MODEL_CASES, ids=[c[0] for c in MODEL_CASES])
def test_cif_loss_and_gradients_match_jax(case):
    """cif_loss(model(...)) with exp/3_cif.sh's CTC factor 0.3 and quantity
    factor 1.0: the loss and its metrics rtol 1e-5, every parameter's
    gradient within 1e-4 of its largest entry."""
    _, model_kw, loss_kw = case
    cfg_kw = dict(SMALL, **model_kw)
    jmodel = jcif.CIFModel(jcif.CIFConfig(**cfg_kw))
    jp = jmodel.init(jax.random.PRNGKey(0))
    batch = _batch()
    jb = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
          for k, v in batch.items()}
    loss_kw = dict(loss_kw, cif_beta=cfg_kw.get("cif_beta", 1.0))

    def jloss(params):
        logits, extra = jmodel.forward(params, jb["feats"],
                                       jb["feat_lengths"], jb["prev_tokens"])
        return jcl.cif_loss(logits, extra, jb["target"], jb["feat_lengths"],
                            jcl.CIFLossConfig(**loss_kw))

    (loss_j, metrics_j), grads_j = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jp)
    model = tcif.CIFModel(tcif.CIFConfig(**cfg_kw), device="cpu")
    model.load_state_dict(load_jax_params(jax.tree_util.tree_map(np.asarray,
                                                                 jp)))
    tb = {k: _t(v) for k, v in batch.items()}
    logits, extra = model(tb["feats"], tb["feat_lengths"], tb["prev_tokens"])
    loss, metrics = tcl.cif_loss(logits, extra, tb["target"],
                                 tb["feat_lengths"],
                                 tcl.CIFLossConfig(**loss_kw))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    for key in ("nll_loss", "ctc_loss", "quantity", "q_acc", "latency",
                "sample_size"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(metrics_j[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    ref = load_jax_params(jax.tree_util.tree_map(np.asarray, grads_j))
    assert sorted(n for n, _ in model.named_parameters()) == sorted(ref)
    for name, p in model.named_parameters():
        # a key bias adds one q.b to every score of a query row, which the
        # softmax ignores: its exact gradient is 0 and both sides hold
        # rounding noise, held against its weight's largest entry
        scale = ref[name[:-len("bias")] + "weight"] \
            if name.endswith("k_proj.bias") and "self_attn" in name or \
            name.endswith("encoder_attn.k_proj.bias") and \
            model_kw.get("cif_infinite_lookback") else None
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        _close_to_largest(got.numpy(), ref[name], 1e-4, name, scale=scale)


@pytest.mark.parametrize("model_kw", [dict(cif_highway=True),
                                      dict(cif_infinite_lookback=True)],
                         ids=["fake+highway", "infinite lookback"])
def test_cif_decoder_step_matches_jax(model_kw):
    """Ten steps at B = 2 over a buffer with 3 and 6 fired features, so
    that both examples overshoot (the EOS bias) and read the clamped last
    feature: logits atol 1e-4, rtol 1e-4; the step counts and the cache
    fills equal."""
    cfg_kw = dict(SMALL, **model_kw)
    jcfg = jcif.CIFConfig(**cfg_kw)
    jp = jcif.CIFModel(jcfg).init(jax.random.PRNGKey(1))
    model = tcif.CIFModel(tcif.CIFConfig(**cfg_kw), device="cpu").eval()
    model.load_state_dict(load_jax_params(jax.tree_util.tree_map(np.asarray,
                                                                 jp)))
    rng = np.random.RandomState(4)
    buf = rng.randn(2, 12, 64).astype(np.float32)
    cif_len = np.array([3, 6])
    jstate = jcif.cif_decoder_init_state(jcfg, 2, 12)
    tstate = tcif.cif_decoder_init_state(model.cfg, 2, 12)
    jstep = jax.jit(functools.partial(jcif.cif_decoder_step,
                                      overshoot_weight=1.5),
                    static_argnums=(1,))
    tokens = np.array([2, 2])
    for _ in range(10):
        jl, jstate = jstep(jp["decoder"], jcfg, jstate, jnp.asarray(tokens),
                           jnp.asarray(buf), jnp.asarray(cif_len))
        with torch.no_grad():
            tl, tstate = tcif.cif_decoder_step(
                model.decoder, model.cfg, tstate, _t(tokens), _t(buf),
                _t(cif_len), overshoot_weight=1.5)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        tokens = rng.randint(4, 40, 2)
    np.testing.assert_array_equal(tstate.step.numpy(),
                                  np.asarray(jstate.step))
    for tc, jc in zip(tstate.caches + tstate.cross_caches,
                      jstate.caches + jstate.cross_caches):
        np.testing.assert_array_equal(tc.length.numpy(),
                                      np.asarray(jc.length))
