"""The s2t_emformer joint-CTC training slice of simulst_tpu_torch vs the JAX
package, on the CPU.

Small config: 2 + 2 layers, width 64, 2 heads, FFN 128, segment 4 / left
context 8 / right context 2 frames after subsampling, conv-pos 64 taps in
16 groups, vocab 40, CTC head; JAX init bridged to the port
(compat/jax_bridge.load_jax_params, the 3-D conv and conv-pos v / g
included); seeded numpy inputs; fp32 with jax_default_matmul_precision
float32 (tests/conftest.py).  Where the JAX function reaches a Pallas
kernel it runs in interpret mode, as the JAX package's own tests run it.
Tolerances, each stated again at its test: CTC sums rtol 1e-5 and dlogits
within 1e-5 of the largest entry; the DP kernels' finite entries atol 1e-5
and their -1e30 sentinels equal; the conv-pos weight gradient within 1e-5
of its largest entry; LN-FFN and grouped-attention gradients atol 1e-5;
the model's loss rtol 1e-5 and every parameter's gradient within 1e-4 of
its largest entry (a key bias, whose exact gradient is 0, of its
weight's); one Adam step's parameters atol 1e-6.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each
import jax.numpy as jnp  # noqa: E402

from simulst_tpu.data import dataset as jds  # noqa: E402
from simulst_tpu.data import synthetic as jsyn  # noqa: E402
from simulst_tpu.data.vocab import Vocabulary as JVocab  # noqa: E402
from simulst_tpu.losses import joint_ctc as jjc  # noqa: E402
from simulst_tpu.models import s2t_emformer as js2t  # noqa: E402
from simulst_tpu.ops import ctc as jctc  # noqa: E402
from simulst_tpu.ops import specaugment as jspec  # noqa: E402
from simulst_tpu.ops.conv_pos_pallas import convpos_wgrad_pallas  # noqa: E402
from simulst_tpu.ops.emformer_attn_pallas import AttnGeom as JGeom  # noqa: E402
from simulst_tpu.ops.emformer_attn_pallas import \
    emformer_grouped_attention as j_attn  # noqa: E402
from simulst_tpu.ops.ffn_pallas import fused_ln_ffn_res as j_ln_ffn  # noqa: E402
from simulst_tpu.ops.ffn_pallas import ln_ffn_res_reference  # noqa: E402
from simulst_tpu.train.optim import OptimConfig as JOptim  # noqa: E402
from simulst_tpu.train.state import create_train_state as j_create  # noqa: E402
from simulst_tpu.train.state import make_train_step as j_make_step  # noqa: E402
from simulst_tpu_torch.cli import train as tcli  # noqa: E402
from simulst_tpu_torch.compat.jax_bridge import (flatten_tree,  # noqa: E402
                                                 load_jax_params)
from simulst_tpu_torch.data import dataset as tds  # noqa: E402
from simulst_tpu_torch.data import synthetic as tsyn  # noqa: E402
from simulst_tpu_torch.data.vocab import Vocabulary as TVocab  # noqa: E402
from simulst_tpu_torch.models import s2t_emformer as ts2t  # noqa: E402
from simulst_tpu_torch.nn.core import RngStream  # noqa: E402
from simulst_tpu_torch.ops import conv_pos as tconv  # noqa: E402
from simulst_tpu_torch.ops import ctc as tctc  # noqa: E402
from simulst_tpu_torch.ops import emformer_attn as tattn  # noqa: E402
from simulst_tpu_torch.ops import ffn as tffn  # noqa: E402
from simulst_tpu_torch.ops import specaugment as tspec  # noqa: E402
from simulst_tpu_torch.ops.philox import drop_scale  # noqa: E402
from simulst_tpu_torch.train.optim import OptimConfig  # noqa: E402
from simulst_tpu_torch.train.state import (create_train_state,  # noqa: E402
                                           make_train_step)

SMALL = dict(vocab_size=40, input_feat=8, conv_channels=16, embed_dim=64,
             ffn_dim=128, encoder_layers=2, encoder_heads=2, decoder_layers=2,
             decoder_heads=2, decoder_ffn_dim=128, segment_length=16,
             left_context=32, right_context=8, max_memory=2,
             max_target_positions=64, ctc_layer=True)
NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
T = 128          # feature frames: U = 32 after subsampling, 8 segments, G = 4
OPTIM = dict(lr=1e-3, warmup_updates=10000, clip_norm=10.0)  # 1a_pretrain_asr
ASR_ARGS = ["--task", "asr", "--model", "s2t_emformer", "--loss",
            "joint_ctc", "--override", "ctc_layer=true"]


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _close_to_largest(got, want, rtol, scale=None, name=""):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    ref = np.abs(np.asarray(want if scale is None else scale)).max()
    assert err <= rtol * max(ref, 1e-30), (name, err, ref)


# ---------------------------------------------------------------------------
# CTC
# ---------------------------------------------------------------------------

def _ctc_case(L=6):
    """4 examples, V 17, L labels (T 23 at L 6, else 2L + 8 frames): one
    with frames past its length, one whose target cannot fit its frames
    (zero_infinity), one with an empty target."""
    rng = np.random.RandomState(0)
    t = 23 if L == 6 else 2 * L + 8
    logits = _rand(rng, 4, t, 17, scale=2.0)
    in_len = np.array([t, t - 4, 5, 7], np.int32)
    targets = rng.randint(4, 17, (4, L)).astype(np.int32)
    targets[1, 2] = targets[1, 1]
    tgt_len = np.array([L, L // 2, L, 0], np.int32)
    return logits, in_len, targets, tgt_len


def test_ctc_raw_smoothed_matches_jax():
    """nll and smoothing sums rtol 1e-5; dlogits within 1e-5 of the largest
    entry (upstream weights 1.3 and 0.7)."""
    logits, in_len, targets, tgt_len = _ctc_case()

    def jfn(lg):
        return jctc.ctc_raw_smoothed(lg, jnp.asarray(in_len),
                                     jnp.asarray(targets),
                                     jnp.asarray(tgt_len), 0, True, True)

    (nll_j, sm_j), vjp = jax.vjp(jfn, jnp.asarray(logits))
    (grad_j,) = vjp((jnp.float32(1.3), jnp.float32(0.7)))
    lt = torch.from_numpy(logits).requires_grad_()
    nll_t, sm_t = tctc.ctc_raw_smoothed(lt, *map(torch.from_numpy, (
        in_len, targets, tgt_len)))
    (1.3 * nll_t + 0.7 * sm_t).backward()
    np.testing.assert_allclose(nll_t.item(), float(nll_j), rtol=1e-5)
    np.testing.assert_allclose(sm_t.item(), float(sm_j), rtol=1e-5)
    _close_to_largest(lt.grad.numpy(), grad_j, 1e-5)
    lt.grad = None            # zero_infinity: no nll gradient for example 2
    tctc.ctc_raw_smoothed(lt, *map(torch.from_numpy, (in_len, targets,
                                                      tgt_len)),
                          with_smooth=False)[0].backward()
    assert not lt.grad[2].any() and lt.grad[0].any()


@pytest.mark.parametrize("L", [6, 16, 32])
def test_ctc_dp_matches_pallas_interpret(L):
    """The plain alphas and d_em vs alphas_pallas / d_em_pallas in interpret
    mode: finite entries atol 1e-5, sentinels equal; S = 2L + 1 = 13, 33
    and 65 states, across the CUDA d_em kernel's groups of 32.  At L 16 and
    32 (40 and 72 frames) the alphas reach -130 and also take rtol 1e-6:
    torch's and XLA's logaddexp round differently, about an ulp of the
    running sum per frame."""
    logits, in_len, targets, tgt_len = _ctc_case(L)
    labels, can_skip = jctc._ctc_masks(jnp.asarray(targets), 0)
    lse = jax.nn.logsumexp(jnp.asarray(logits), axis=-1)
    em = jctc._emissions(jnp.asarray(logits), labels) - \
        jnp.moveaxis(lse, 0, 1)[:, :, None]
    il, tl = jnp.asarray(in_len), jnp.asarray(tgt_len)
    alphas_j = np.asarray(jctc.alphas_pallas(em, can_skip, il, tl,
                                             interpret=True))
    t_args = [torch.from_numpy(np.asarray(a)) for a in (em, can_skip)]
    t_len = [torch.from_numpy(a) for a in (in_len, tgt_len)]
    alphas_t = tctc.alphas_plain(*t_args, *t_len).numpy()
    sentinel = alphas_j <= tctc.NEG / 2
    np.testing.assert_array_equal(alphas_t[sentinel], alphas_j[sentinel])
    np.testing.assert_allclose(alphas_t[~sentinel], alphas_j[~sentinel],
                               atol=1e-5, rtol=0 if L == 6 else 1e-6)
    rng = np.random.RandomState(1)
    nll, scale = _rand(rng, 4), rng.rand(4).astype(np.float32)
    d_em_j = np.asarray(jctc.d_em_pallas(
        em, jnp.asarray(alphas_j), can_skip, il, tl, jnp.asarray(scale),
        jnp.asarray(nll), interpret=True))
    d_em_t = tctc.d_em_plain(t_args[0], torch.from_numpy(alphas_j),
                             t_args[1], *t_len, torch.from_numpy(scale),
                             torch.from_numpy(nll)).numpy()
    np.testing.assert_allclose(d_em_t, d_em_j, atol=1e-5, rtol=0)
    assert not d_em_t[5:, 2].any() and not d_em_t[in_len[1]:, 1].any()


def test_ctc_loss_and_best_alignment_match_jax():
    """ctc_loss on log-probs (rtol 1e-5) and its autograd gradient (1e-5
    of the largest entry); the Viterbi states and labels exactly."""
    logits, in_len, targets, tgt_len = _ctc_case()
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
    j_args = [jnp.asarray(a) for a in (in_len, targets, tgt_len)]
    t_args = [torch.from_numpy(a) for a in (in_len, targets, tgt_len)]
    loss_j, grad_j = jax.value_and_grad(
        lambda x: jctc.ctc_loss(x, *j_args))(jnp.asarray(lp))
    lt = torch.from_numpy(lp).requires_grad_()
    loss_t = tctc.ctc_loss(lt, *t_args)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    _close_to_largest(lt.grad.numpy(), grad_j, 1e-5)
    states_j = np.asarray(jctc.best_alignment(jnp.asarray(lp), *j_args))
    states_t = tctc.best_alignment(torch.from_numpy(lp), *t_args)
    np.testing.assert_array_equal(states_t.numpy(), states_j)
    np.testing.assert_array_equal(
        tctc.alignment_to_labels(states_t, t_args[1]).numpy(),
        np.asarray(jctc.alignment_to_labels(jnp.asarray(states_j),
                                            j_args[1])))


# ---------------------------------------------------------------------------
# kernels' plain versions vs the Pallas kernels / their XLA twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("geom", [(2, 12, 4, 256, 16), (3, 9, 7, 64, 16)])
def test_convpos_wgrad_matches_pallas_interpret(geom):
    """The plain weight gradient, in torch's (D, D / groups, K) layout, vs
    convpos_wgrad_pallas's (K, D / groups, D): within 1e-5 of the largest
    entry."""
    b, t, k, d, groups = geom
    rng = np.random.RandomState(0)
    xp, dy = _rand(rng, b, t + k - 1, d), _rand(rng, b, t, d)
    want = np.asarray(convpos_wgrad_pallas(jnp.asarray(xp), jnp.asarray(dy),
                                           k, groups, interpret=True))
    got = tconv.convpos_wgrad_plain(torch.from_numpy(xp),
                                    torch.from_numpy(dy), k, groups)
    _close_to_largest(got.numpy(), np.transpose(want, (2, 1, 0)), 1e-5)


def _vjp_compare(jfn, tfn, arrays, dy, atol=1e-5):
    ref, vjp = jax.vjp(jfn, *map(jnp.asarray, arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = tfn(*ts)
    out.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=1e-5)
    for i, (t, want) in enumerate(zip(ts, vjp(jnp.asarray(dy)))):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   atol=atol, rtol=1e-5, err_msg=str(i))


@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_ln_ffn_backward_matches_jax_vjp(activation):
    """fused_ln_ffn_res's plain backward (what its autograd Function runs on
    a CPU tensor) vs jax.vjp at rate 0: of the Pallas kernel in interpret
    mode for relu, of ln_ffn_res_reference for gelu (the interpret-mode
    kernel's tanh GELU differs from the exact erf form); atol 1e-5."""
    rng = np.random.RandomState(4)
    arrays = (_rand(rng, 70, 64), 1 + _rand(rng, 64, scale=0.1),
              _rand(rng, 64, scale=0.1), _rand(rng, 64, 128, scale=0.1),
              _rand(rng, 128, scale=0.1), _rand(rng, 128, 64, scale=0.1),
              _rand(rng, 64, scale=0.1))
    if activation == "relu":
        def jfn(*a):
            return j_ln_ffn(*a, jnp.array([0], jnp.int32), "relu", 0.0, 0.0,
                            True)
    else:
        def jfn(*a):
            return ln_ffn_res_reference(*a, None, None, "gelu")
    _vjp_compare(jfn, lambda *t: tffn.fused_ln_ffn_res(*t, activation),
                 arrays, _rand(rng, 70, 64))


def test_grouped_attention_backward_matches_pallas_interpret():
    """emformer_grouped_attention's plain backward vs jax.vjp of the Pallas
    kernel in interpret mode at rate 0 (U 32, segment 4, lc 8, rc 2, 2
    memory slots, G 4, 2 heads of 32): atol 1e-5."""
    g = dict(U=32, seg=4, lc=8, rc=2, max_mem=2, G=4, num_heads=2)
    jgeom, tgeom = JGeom(**g), tattn.AttnGeom(**g)
    rng = np.random.RandomState(5)
    arrays = (_rand(rng, 2, tgeom.ng, tgeom.nq, 64), _rand(rng, 2, tgeom.tk, 64),
              _rand(rng, 2, tgeom.tk, 64))
    lengths = np.array([32, 21], np.int32)
    seed = jnp.array([0], jnp.int32)
    _vjp_compare(
        lambda q, k, v: j_attn(q, k, v, jnp.asarray(lengths), seed, None,
                               jgeom, 0.0, True),
        lambda q, k, v: tattn.emformer_grouped_attention(
            q, k, v, torch.from_numpy(lengths), tgeom),
        arrays, _rand(rng, 2, tgeom.ng, tgeom.nq, 64))


def test_dropout_masks_keep_rate_and_backward():
    """The LN-FFN's and the grouped attention's dropout: the masks are
    ops/philox.py's at the documented offsets and streams (keep rate 0.9
    within 1%), and the plain forward and backward (what the autograd
    Functions run on the CPU) equal the functions written out with those
    masks and differentiated by autograd: atol 1e-5."""
    rng = np.random.RandomState(6)
    seed, rate = 2024, 0.1
    x, g, b = _rand(rng, 150, 32), 1 + _rand(rng, 32, scale=0.1), \
        _rand(rng, 32, scale=0.1)
    w1, b1, w2, b2 = _rand(rng, 32, 64, scale=0.2), _rand(rng, 64), \
        _rand(rng, 64, 32, scale=0.2), _rand(rng, 32)
    dy = _rand(rng, 150, 32)
    ma = drop_scale(seed, (150, 64), rate, 0)
    mo = drop_scale(seed, (150, 32), rate, 1)
    for m in (ma, mo):
        assert abs(float((m != 0).float().mean()) - 0.9) < 0.01

    def explicit(x_, g_, b_, w1_, b1_, w2_, b2_):
        h = torch.layer_norm(x_, (32,), g_, b_, 1e-5)
        return x_ + ((torch.relu(h @ w1_ + b1_) * ma) @ w2_ + b2_) * mo

    arrays = (x, g, b, w1, b1, w2, b2)
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    want = explicit(*ts)
    want.backward(torch.from_numpy(dy))
    grads = [t.grad for t in ts]
    got = tffn.fused_ln_ffn_res(*map(torch.from_numpy, arrays), "relu", rate,
                                rate, seed)
    torch.testing.assert_close(got, want.detach(), atol=1e-5, rtol=1e-5)
    back = tffn.ln_ffn_res_plain_backward(*map(torch.from_numpy, arrays[:6]),
                                          torch.from_numpy(dy), "relu", rate,
                                          rate, seed)
    for got_g, want_g in zip(back, grads):
        torch.testing.assert_close(got_g, want_g, atol=1e-5, rtol=1e-5)

    geom = tattn.AttnGeom(U=32, seg=4, lc=8, rc=2, max_mem=2, G=4,
                          num_heads=2)
    q3, k, v = (torch.from_numpy(a) for a in (
        _rand(rng, 2, geom.ng, geom.nq, 32), _rand(rng, 2, geom.tk, 32),
        _rand(rng, 2, geom.tk, 32)))
    lengths = torch.tensor([32, 21], dtype=torch.int32)
    qh, kh, vh, visible, _ = tattn._context(q3, k, v, lengths, geom)
    m = drop_scale(seed, (2, geom.ng, 2, geom.nq, geom.ctx), rate, 0)
    assert abs(float((m != 0).float().mean()) - 0.9) < 0.01
    dout = torch.from_numpy(_rand(rng, 2, geom.ng, geom.nq, 32))
    ts = [t.clone().requires_grad_() for t in (q3, k, v)]
    qh, kh, vh, visible, _ = tattn._context(*ts, lengths, geom)
    p = tattn.masked_softmax(qh @ kh.transpose(-1, -2) * 16 ** -0.5, visible)
    want = tattn._merge((p * m) @ vh)
    want.backward(dout)
    got = tattn.grouped_attention_plain(q3, k, v, lengths, geom, rate, seed)
    torch.testing.assert_close(got, want.detach(), atol=1e-5, rtol=1e-5)
    back = tattn.grouped_attention_plain_backward(q3, k, v, lengths, dout,
                                                  geom, rate, seed)
    for got_g, t in zip(back, ts):
        torch.testing.assert_close(got_g, t.grad, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# SpecAugment and the batcher
# ---------------------------------------------------------------------------

def test_specaugment_applies_jax_draws_and_stays_in_bounds():
    """The applying half, fed the widths and starts the JAX function draws,
    equals jax spec_augment exactly; the port's own draws stay within the
    "lb" policy's bounds."""
    rng = np.random.RandomState(7)
    feats = _rand(rng, 3, 300, 80)
    lengths = np.array([300, 250, 60], np.int32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jspec.spec_augment(key, jnp.asarray(feats),
                                         jnp.asarray(lengths)))
    keys = jax.random.split(key, 8)

    def uniform_int(k, maxval):
        u = np.asarray(jax.random.uniform(k, (3, 1)))
        return torch.from_numpy(np.floor(u * np.asarray(maxval)).astype(
            np.int64))

    freq, time = [], []
    for i in range(2):
        w = uniform_int(keys[2 * i], 28)
        freq.append((w, uniform_int(keys[2 * i + 1],
                                    np.maximum(80 - w.numpy(), 1))))
    max_t = np.minimum(100, lengths)[:, None]
    for i in range(2, 4):
        w = uniform_int(keys[2 * i], max_t + 1)
        time.append((w, uniform_int(keys[2 * i + 1], np.maximum(
            lengths[:, None] - w.numpy(), 1))))
    got = tspec.apply_masks(torch.from_numpy(feats),
                            tspec.Masks(freq=freq, time=time))
    np.testing.assert_array_equal(got.numpy(), want)

    masks = tspec.draw_masks(torch.Generator().manual_seed(0),
                             torch.from_numpy(lengths), 80)
    for w, s in masks.freq:
        assert ((0 <= w) & (w <= 27) & (0 <= s) & (s + w <= 80)).all()
    for w, s in masks.time:
        lens = torch.from_numpy(lengths)[:, None]
        assert ((0 <= w) & (w <= torch.clamp(lens, max=100)) & (0 <= s)
                & (s <= torch.clamp(lens - w, min=1))).all()


def test_make_batches_match_jax(tmp_path):
    """The port's speech batcher on a MuST-C-shaped manifest equals the JAX
    package's batch for batch (ids, features, lengths, targets)."""
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jrows = jsyn.mustc_like_rows(120, seed=3, tmpdir=str(tmp_path / "j"))
    trows = tsyn.mustc_like_rows(120, seed=3, tmpdir=str(tmp_path / "t"))
    syms = ["<s>", "<pad>", "</s>", "<unk>"] + [f"▁{c * 3}"
                                                for c in "abcdefghij"]
    jcfg = jds.BatcherConfig(max_tokens=6000)
    tcfg = tds.BatcherConfig(max_tokens=6000)
    jb = list(jds.make_batches(jds.SpeechDataset(jrows, JVocab(syms), jcfg,
                                                 "src_text"),
                               epoch=1, num_shards=1, shard_id=0))
    tb = list(tds.make_batches(tds.SpeechDataset(trows, TVocab(syms), tcfg,
                                                 "src_text"), epoch=1))
    assert len(jb) == len(tb) > 3
    for a, b in zip(jb, tb):
        assert a["ids"] == b["ids"] and a["n_real"] == b["n_real"]
        for key in ("feats", "feat_lengths", "target", "prev_tokens"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


# ---------------------------------------------------------------------------
# the model, the loss and the train step
# ---------------------------------------------------------------------------

def _batch():
    """Two utterances of 128 / 90 frames with 7 / 4 target tokens + EOS."""
    rng = np.random.RandomState(9)
    feats = _rand(rng, 2, T, 8)
    target = np.ones((2, 8), np.int32)
    prev = np.ones((2, 8), np.int32)
    for j, n in enumerate((7, 4)):
        toks = np.append(rng.randint(4, 40, n), 2)
        target[j, :n + 1] = toks
        prev[j, :n + 1] = np.append(2, toks[:-1])
    return {"feats": feats, "feat_lengths": np.array([T, 90], np.int32),
            "target": target, "prev_tokens": prev}


def _jax_loss(jmodel):
    def fn(params, batch, rng):
        logits, extra = jmodel.forward(params, batch["feats"],
                                       batch["feat_lengths"],
                                       batch["prev_tokens"])
        return jjc.joint_ctc_loss(logits, extra, batch["target"],
                                  jjc.JointCTCConfig())
    return fn


@pytest.fixture(scope="module")
def asr_pair():
    jmodel = js2t.S2TEmformerModel(js2t.S2TEmformerConfig(**SMALL,
                                                          **NO_DROPOUT))
    jp = jmodel.init(jax.random.PRNGKey(0))
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        _jax_loss(jmodel), has_aux=True))(jp, jb, None)
    jstate, jmetrics = jax.jit(j_make_step(_jax_loss(jmodel),
                                           JOptim(**OPTIM)))(
        j_create(jp, JOptim(**OPTIM)), jb, jax.random.PRNGKey(0))
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731
    return dict(params=as_np(jp), batch=batch, loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=as_np(grads), stepped=as_np(jstate.params),
                step_metrics={k: float(v) for k, v in jmetrics.items()})


def _port_model(jparams, **overrides):
    cfg = ts2t.S2TEmformerConfig(**SMALL, **overrides)
    model = ts2t.S2TEmformerModel(cfg, device="cpu")
    model.load_state_dict(load_jax_params(jparams))
    return model


def _port_loss(*flags):
    return tcli.build_loss(tcli.parse_args(ASR_ARGS + list(flags)), None)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grad_scale(grads, name):
    """The largest gradient entry a parameter's error is held against: its
    own, but a decoder key bias's exact gradient is 0 (it adds one q.b to
    every score of a row), so both sides hold rounding noise there: its
    weight's."""
    if name.endswith("k_proj.bias"):
        name = name[:-len("bias")] + "weight"
    return grads[name]


def test_joint_ctc_loss_and_gradients_match_jax(asr_pair):
    """joint_ctc_loss(model.forward(...)) at dropout 0 without SpecAugment:
    the loss and its CTC term rtol 1e-5, the greedy-CTC metrics, and every
    parameter's gradient within 1e-4 of its largest entry."""
    model = _port_model(asr_pair["params"])
    loss, metrics = _port_loss("--no-specaugment")(
        model, _torch_batch(asr_pair["batch"]), None)
    loss.backward()
    jm = asr_pair["metrics"]
    np.testing.assert_allclose(loss.item(), asr_pair["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ctc_loss"]), jm["ctc_loss"],
                               rtol=1e-5)
    for key in ("blank_rate", "ctc_recall", "ctc_precision", "sample_size"):
        np.testing.assert_allclose(float(metrics[key]), jm[key], rtol=1e-6,
                                   err_msg=key)
    ref = load_jax_params(asr_pair["grads"])
    assert sorted(n for n, _ in model.named_parameters()) == sorted(ref)
    for name, p in model.named_parameters():
        _close_to_largest(p.grad.numpy(), ref[name], 1e-4,
                          scale=_grad_scale(ref, name), name=name)


def test_train_step_matches_jax(asr_pair):
    """One Adam step of the recipe's optimizer (lr 1e-3, warmup 10000, clip
    10) from the same parameters and batch: gradient norm and loss rtol
    1e-5, every updated parameter atol 1e-6."""
    model = _port_model(asr_pair["params"])
    state = create_train_state(model, OptimConfig(**OPTIM))
    state, metrics = make_train_step(_port_loss("--no-specaugment"),
                                     OptimConfig(**OPTIM))(
        state, _torch_batch(asr_pair["batch"]))
    jm = asr_pair["step_metrics"]
    assert state.step == 1
    np.testing.assert_allclose(float(metrics["gnorm"]), jm["gnorm"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["loss"]), jm["loss"], rtol=1e-5)
    ref = flatten_tree(asr_pair["stepped"])
    for name, p in load_jax_params(asr_pair["stepped"]).items():
        np.testing.assert_allclose(model.state_dict()[name].numpy(),
                                   p.numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)
    assert sorted(model.state_dict()) == sorted(ref)


def test_dropout_and_specaugment_are_seeded(asr_pair):
    """With a generator the loss drops and masks (it differs from the
    deterministic loss), and two runs from one seed agree exactly."""
    losses = []
    for gen in (torch.Generator().manual_seed(5),
                torch.Generator().manual_seed(5), None):
        model = _port_model(asr_pair["params"])
        loss, _ = _port_loss()(model, _torch_batch(asr_pair["batch"]),
                               None if gen is None else RngStream(gen))
        losses.append(loss.item())
    assert losses[0] == losses[1] != losses[2]


def test_cli_trains_asr_on_the_cpu(tmp_path):
    """cli/train main for --task asr --model s2t_emformer --loss joint_ctc
    --override ctc_layer=true: two updates on a MuST-C-shaped manifest,
    a validation loss in the log, checkpoint_last written."""
    rows = tsyn.mustc_like_rows(16, seed=2, tmpdir=str(tmp_path), feat_dim=8)
    for r in rows:   # 1-4 s, so the CPU steps stay short
        r["n_frames"] = str(min(int(r["n_frames"]), 400))
    header = "id\taudio\tn_frames\tsrc_text\ttgt_text\tspeaker"
    for split, part in (("train", rows[:12]), ("dev", rows[12:])):
        (tmp_path / f"{split}_st.tsv").write_text("\n".join(
            [header] + ["\t".join(r[c] for c in header.split("\t"))
                        for r in part]) + "\n")
    (tmp_path / "spm_unigram.txt").write_text(
        "".join(f"▁{c * 3} 1\n" for c in "abcdefghij"))
    save = tmp_path / "ckpt"
    small = [f"--override={k}={v}" for k, v in SMALL.items()
             if k not in ("vocab_size", "ctc_layer")]
    state = tcli.main(ASR_ARGS + [
        "--data", str(tmp_path), "--device", "cpu", "--max-updates", "2",
        "--max-tokens", "1600", "--save-dir", str(save), *small])
    assert state.step == 2
    log = (save / "train_log.jsonl").read_text()
    assert '"valid_update": 2' in log and '"loss"' in log
    assert (save / "checkpoint_last").exists()


UNPORTED = (NotImplementedError, "not trained by the JAX package either")


def test_cli_parses_and_validates_eval_metric():
    """--eval-metric wer parses with its decode options; an unknown metric
    is refused by the parser."""
    args = tcli.parse_args(ASR_ARGS + ["--eval-metric", "wer",
                                       "--eval-beam", "3"])
    assert (args.eval_metric, args.eval_beam, args.eval_max_len,
            args.best_metric) == ("wer", 3, 96, None)
    with pytest.raises(SystemExit):
        tcli.parse_args(ASR_ARGS + ["--eval-metric", "ter"])


@pytest.mark.parametrize("argv,error", [
    # --pack is ported for s2t_emformer + joint_ctc, the one path the JAX
    # package packs; elsewhere it raises, as the JAX package asserts
    (["--task", "st", "--model", "mma", "--loss", "mma", "--pack"],
     (ValueError, "--pack trains --model s2t_emformer --loss joint_ctc")),
    # --mtl is ported: it parses (and trains the CTC on the transcripts)
    (["--task", "st"] + ASR_ARGS[2:] + ["--mtl"], None),
    (["--task", "asr", "--model", "s2t_emformer", "--loss", "mma"], UNPORTED),
    # ported: MMA under joint CTC, as the JAX package's build_loss pairs it
    (["--task", "asr", "--model", "mma", "--loss", "joint_ctc"], None),
    (["--task", "mt", "--model", "s2t_emformer", "--loss", "joint_ctc"],
     UNPORTED),
], ids=["pack", "mtl", "mma-loss", "mma-model", "mt-task"])
def test_cli_rejects_unported_options(argv, error):
    if error is None:
        args = tcli.parse_args(argv)
        assert args.mtl or (args.model, args.loss) == ("mma", "joint_ctc")
        return
    with pytest.raises(error[0], match=error[1]):
        tcli.parse_args(argv)
