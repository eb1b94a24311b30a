"""The model options of simulst_tpu_torch beyond the shipped recipes vs the
JAX package, on the CPU: post-LN (normalize_before=False) in the Emformer
and the decoder, segmented_attention=False (the port's segmented attention
against JAX's dense one), the silu and tanh FFNs, the VGG frontend, and the config dataclasses'
field sets with the CLI's --override path.

Weights are the JAX init bridged with compat/jax_bridge.load_jax_params;
inputs are seeded numpy; fp32 with jax_default_matmul_precision float32
(tests/conftest.py).  Tolerances, each stated again at its test: a stack
of layers atol 1e-4 (the order of the sums differs), gradients of a stack
within 1e-4 of their largest entry, one op atol 1e-5; JAX's dense path vs
the port's segmented one rtol 2e-4 / atol 2e-5, the JAX test's own.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each
import jax.numpy as jnp  # noqa: E402

from simulst_tpu.decode import beam as jbeam  # noqa: E402
from simulst_tpu.losses import joint_ctc as jjc  # noqa: E402
from simulst_tpu.models import cif as jcif  # noqa: E402
from simulst_tpu.models import mma as jmma  # noqa: E402
from simulst_tpu.models import s2t_convpos as jconvpos  # noqa: E402
from simulst_tpu.models import s2t_emformer as js2t  # noqa: E402
from simulst_tpu.models import transducer as jtr  # noqa: E402
from simulst_tpu.nn import conv as jconv  # noqa: E402
from simulst_tpu.nn import core as jcore  # noqa: E402
from simulst_tpu.nn import emformer as jemf  # noqa: E402
from simulst_tpu.nn import transformer as jtfm  # noqa: E402
from simulst_tpu.stream import agents as jagents  # noqa: E402
from simulst_tpu_torch.cli import train as tcli  # noqa: E402
from simulst_tpu_torch.compat.jax_bridge import load_jax_params  # noqa: E402
from simulst_tpu_torch.data import synthetic as tsyn  # noqa: E402
from simulst_tpu_torch.decode import beam as tbeam  # noqa: E402
from simulst_tpu_torch.models import cif as tcif  # noqa: E402
from simulst_tpu_torch.models import mma as tmma  # noqa: E402
from simulst_tpu_torch.models import s2t_convpos as tconvpos  # noqa: E402
from simulst_tpu_torch.models import s2t_emformer as ts2t  # noqa: E402
from simulst_tpu_torch.models import transducer as ttr  # noqa: E402
from simulst_tpu_torch.nn import conv as tconv  # noqa: E402
from simulst_tpu_torch.nn import emformer as temf  # noqa: E402
from simulst_tpu_torch.nn import transformer as ttfm  # noqa: E402
from simulst_tpu_torch.ops import ffn as tffn  # noqa: E402
from simulst_tpu_torch.stream import agents as tagents  # noqa: E402
from simulst_tpu_torch.stream import build as tbuild  # noqa: E402

NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
GEOM = dict(input_dim=32, num_heads=2, ffn_dim=64, num_layers=2,
            left_context=8, right_context=2, segment=4, max_memory=2,
            **NO_DROPOUT)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close_to_largest(got, want, rtol, name=""):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-30), (name, err)


def _weighted(out, lengths):
    """The scalar both sides differentiate: sum over valid frames of
    o cos(0.1 o)."""
    lib = torch if isinstance(out, torch.Tensor) else jnp
    mask = (lib.arange(out.shape[1])[None, :]
            < lib.asarray(np.asarray(lengths))[:, None])[:, :, None]
    return (lib.where(mask, out, 0.0) * lib.cos(out * 0.1)).sum()


# ---------------------------------------------------------------------------
# the config dataclasses
# ---------------------------------------------------------------------------

CONFIG_PAIRS = [
    (js2t.S2TEmformerConfig, ts2t.S2TEmformerConfig),
    (jemf.EmformerConfig, temf.EmformerConfig),
    (jtfm.DecoderConfig, ttfm.DecoderConfig),
    (jmma.MMAConfig, tmma.MMAConfig),
    (jcif.CIFConfig, tcif.CIFConfig),
    (jtr.TransducerConfig, ttr.TransducerConfig),
    (jconvpos.S2TConvPosConfig, tconvpos.S2TConvPosConfig),
    (jagents.AgentConfig, tagents.AgentConfig),
    (jbeam.BeamConfig, tbeam.BeamConfig),
]
# the one deliberate exception: JAX's BeamConfig.bos_idx is never read;
# the port's decode_batch takes a `bos` seed in its place
LEFT_OUT = {"BeamConfig": {"bos_idx"}}


@pytest.mark.parametrize("jcls,tcls", CONFIG_PAIRS,
                         ids=[j.__name__ for j, _ in CONFIG_PAIRS])
def test_config_fields_match_jax(jcls, tcls):
    """Every field of the JAX dataclass exists in the port's with the same
    default (so that no --override or checkpoint metadata key is dropped),
    and the port adds none."""
    jf = {f.name: f for f in dataclasses.fields(jcls)}
    tf = {f.name: f for f in dataclasses.fields(tcls)}
    assert set(jf) - set(tf) == LEFT_OUT.get(jcls.__name__, set())
    assert set(tf) <= set(jf)
    for name in tf:
        if jf[name].default is not dataclasses.MISSING:
            assert tf[name].default == jf[name].default, name


# ---------------------------------------------------------------------------
# silu and tanh in the FFN blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("activation", ["silu", "tanh"])
@pytest.mark.parametrize("ln_res", [True, False], ids=["ln_ffn", "ffn"])
def test_ffn_activation_matches_jax_xla(activation, ln_res):
    """ln_ffn_res_plain / ffn_plain and their plain backwards vs the JAX
    package's XLA FFN (nn/emformer._pos_ff with its residual; without LN,
    act(linear) -> linear): the output atol 1e-5, every gradient atol
    1e-5 (D 64, H 128, 37 rows, fp32)."""
    rng = np.random.RandomState(3)
    d, h = 64, 128
    x = rng.randn(37, d).astype(np.float32)
    dy = rng.randn(37, d).astype(np.float32)
    w = dict(g=1 + 0.1 * rng.randn(d), b=0.1 * rng.randn(d),
             w1=rng.randn(d, h) / 8, b1=0.1 * rng.randn(h),
             w2=rng.randn(h, d) / 11, b2=0.1 * rng.randn(d))
    w = {k: v.astype(np.float32) for k, v in w.items()}
    cfg = jemf.EmformerConfig(input_dim=d, ffn_dim=h, activation=activation,
                              **NO_DROPOUT)
    act = jcore.ACTIVATIONS[activation]

    def jfn(x, g, b, w1, b1, w2, b2):
        p = {"ln": {"scale": g, "bias": b}, "fc1": {"weight": w1, "bias": b1},
             "fc2": {"weight": w2, "bias": b2}}
        if ln_res:
            return jemf._pos_ff(p, cfg, x, None, None, True) + x
        return jcore.linear(p["fc2"], act(jcore.linear(p["fc1"], x)))

    args = [x] + [w[k] for k in ("g", "b", "w1", "b1", "w2", "b2")]
    ref, vjp = jax.vjp(jfn, *map(jnp.asarray, args))
    jgrads = vjp(jnp.asarray(dy))
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    xt = torch.from_numpy(x)
    if ln_res:
        out = tffn.ln_ffn_res_plain(xt, t["g"], t["b"], t["w1"], t["b1"],
                                    t["w2"], t["b2"], activation)
        grads = tffn.ln_ffn_res_plain_backward(
            xt, t["g"], t["b"], t["w1"], t["b1"], t["w2"],
            torch.from_numpy(dy), activation)
        want = jgrads
    else:
        out = tffn.ffn_plain(xt, t["w1"], t["b1"], t["w2"], t["b2"],
                             activation)
        grads = tffn.ffn_plain_backward(xt, t["w1"], t["b1"], t["w2"],
                                        torch.from_numpy(dy), activation)
        want = (jgrads[0],) + tuple(jgrads[3:])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    assert len(grads) == len(want) == (7 if ln_res else 5)
    for i, (g, r) in enumerate(zip(grads, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5,
                                   err_msg=f"gradient {i}")
    # the differentiable wrapper takes the same route on a CPU tensor
    xr = xt.clone().requires_grad_()
    y = (tffn.fused_ln_ffn_res(xr, t["g"], t["b"], t["w1"], t["b1"], t["w2"],
                               t["b2"], activation) if ln_res else
         tffn.fused_ffn(xr, t["w1"], t["b1"], t["w2"], t["b2"], activation))
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(xr.grad.numpy(), np.asarray(jgrads[0]),
                               atol=1e-5)


# ---------------------------------------------------------------------------
# post-LN and segmented_attention=False in the Emformer
# ---------------------------------------------------------------------------

EMF_CASES = {   # overrides, U, lengths
    "post-LN grouped": (dict(normalize_before=False), 32, [32, 21]),
    "post-LN ragged": (dict(normalize_before=False), 30, [30, 17]),
    "dense": (dict(segmented_attention=False), 30, [30, 17]),
    "dense post-LN": (dict(segmented_attention=False, normalize_before=False),
                      32, [32, 21]),
    "dense no memory": (dict(segmented_attention=False, max_memory=0), 20,
                        [20, 13]),
}


@pytest.mark.parametrize("case", sorted(EMF_CASES))
def test_emformer_variant_forward_and_gradients_match_jax(case):
    """emformer_forward vs JAX's on every valid frame (atol 1e-4) and every
    parameter's gradient of a weighted sum over the valid frames (within
    1e-4 of its largest entry).  With segmented_attention=False JAX takes
    its dense path and the port its segmented (U 30) or grouped (U 32)
    one."""
    overrides, U, lengths = EMF_CASES[case]
    jcfg = jemf.EmformerConfig(**dict(GEOM, **overrides))
    tcfg = temf.EmformerConfig(**dict(GEOM, **overrides))
    jp = jemf.emformer_init(jax.random.PRNGKey(0), jcfg)
    x = np.random.RandomState(U).randn(2, U + 2, 32).astype(np.float32)
    lens = np.array(lengths, np.int32)

    def jloss(p):
        out, _ = jemf.emformer_forward(p, jcfg, jnp.asarray(x),
                                       jnp.asarray(lens))
        return _weighted(out, lens), out

    (_, ref), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    jg = load_jax_params(_np(jg))
    model = temf.Emformer(tcfg)
    model.load_state_dict(load_jax_params(_np(jp)))
    out = temf.emformer_forward(model, tcfg, torch.from_numpy(x),
                                torch.from_numpy(lens))
    _weighted(out, lens).backward()
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(out[b, :n].detach().numpy(),
                                   np.asarray(ref)[b, :n], atol=1e-4,
                                   rtol=1e-4)
    if not tcfg.normalize_before:   # final_ln stays a parameter, unused
        assert float(jg["final_ln.scale"].abs().max()) == 0.0
    for name, p in model.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        _close_to_largest(got.numpy(), jg[name].numpy(), 1e-4, name)


@pytest.mark.parametrize("U,lengths,memory", [
    (16, [16, 16], 2), (20, [20, 13], 2), (11, [11, 7], 2), (40, [40, 33], 2),
    (20, [20], 0),
])
def test_dense_equals_segmented(U, lengths, memory):
    """JAX's dense path (segmented_attention=False) vs the port's segmented
    (and grouped) path under the same config, the JAX test's cases
    (tests/test_emformer_segmented.py) with memory on and off: rtol 2e-4,
    atol 2e-5 on every valid frame."""
    cfg = dict(GEOM, max_memory=memory, segmented_attention=False)
    jcfg, tcfg = jemf.EmformerConfig(**cfg), temf.EmformerConfig(**cfg)
    jp = jemf.emformer_init(jax.random.PRNGKey(U), jcfg)
    model = temf.Emformer(tcfg)
    model.load_state_dict(load_jax_params(_np(jp)))
    x = np.random.RandomState(1).randn(len(lengths), U + 2,
                                       32).astype(np.float32)
    lens = np.array(lengths, np.int32)
    ref, _ = jemf.emformer_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(lens))
    with torch.no_grad():
        out = temf.emformer_forward(model, tcfg, torch.from_numpy(x),
                                    torch.from_numpy(lens))
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(out[i, :n].numpy(), np.asarray(ref)[i, :n],
                                   rtol=2e-4, atol=2e-5)


def test_dense_path_refuses_packing():
    """The packed forward refuses segmented_attention=False, as JAX
    asserts."""
    cfg = temf.EmformerConfig(**dict(GEOM, segmented_attention=False))
    model = temf.Emformer(cfg)
    with pytest.raises(ValueError, match="segmented_attention=True"):
        temf.emformer_forward_packed(model, cfg, torch.zeros(1, 8, 32),
                                     torch.zeros(1, 4, 32),
                                     torch.zeros(1, 8), torch.zeros(1, 2))


def test_post_ln_emformer_step_matches_jax():
    """emformer_step with normalize_before=False over a chunk sequence
    with a partial flush vs JAX's step (atol 1e-4 per chunk), and vs the
    port's own offline forward (atol 1e-4)."""
    jcfg = jemf.EmformerConfig(**dict(GEOM, normalize_before=False))
    tcfg = temf.EmformerConfig(**dict(GEOM, normalize_before=False))
    jp = jemf.emformer_init(jax.random.PRNGKey(2), jcfg)
    model = temf.Emformer(tcfg)
    model.load_state_dict(load_jax_params(_np(jp)))
    U = 14
    utt = np.random.RandomState(4).randn(1, U, 32).astype(np.float32)
    x_full = np.concatenate([utt, np.zeros((1, 2, 32), np.float32)], 1)
    jstate = jemf.emformer_init_state(jcfg, 1)
    tstate = temf.emformer_init_state(tcfg, 1)
    outs = []
    for start in range(0, U, 4):
        valid = min(4, U - start)
        blk = np.zeros((1, 6, 32), np.float32)
        blk[:, :valid] = utt[:, start:start + valid]
        rc = x_full[:, start + valid:start + valid + 2]
        blk[:, 4:4 + rc.shape[1]] = rc
        uv = np.array([valid], np.int32)
        jo, _, jstate = jemf.emformer_step(jp, jcfg, jstate, jnp.asarray(blk),
                                           jnp.asarray(uv))
        with torch.no_grad():
            to = temf.emformer_step(model, tcfg, tstate, torch.from_numpy(blk),
                                    torch.from_numpy(uv))
        np.testing.assert_allclose(to[:, :valid].numpy(),
                                   np.asarray(jo)[:, :valid], atol=1e-4)
        outs.append(to[:, :valid])
    with torch.no_grad():
        off = temf.emformer_forward(model, tcfg, torch.from_numpy(x_full),
                                    torch.tensor([U]))
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), off.numpy(),
                               atol=1e-4)


def test_post_ln_packed_matches_jax():
    """emformer_forward_packed with normalize_before=False vs JAX's on
    every valid frame (atol 2e-5) and every gradient (atol 3e-4), the
    packing tests' tolerances."""
    from simulst_tpu.train import packing as jpk
    from simulst_tpu_torch.train import packing as tpk
    jcfg = jemf.EmformerConfig(**dict(GEOM, normalize_before=False))
    tcfg = temf.EmformerConfig(**dict(GEOM, normalize_before=False))
    lengths, U = [13, 7, 16, 4], 16
    jp = jemf.emformer_init(jax.random.PRNGKey(6), jcfg)
    x = np.random.RandomState(7).randn(4, U + 2, 32).astype(np.float32)
    x[np.arange(U + 2)[None, :] >= np.array(lengths)[:, None]] = 0.0
    jplan = jpk.pack_plan(lengths, U, 4, 2, 3, None)
    tplan = tpk.pack_plan(lengths, U, 4, 2, 3, None)

    def j_out(p):
        packed, rc = jpk.pack_frames(jnp.asarray(x[:, :U]), jplan)
        o = jemf.emformer_forward_packed(p, jcfg, packed, rc,
                                         jplan.frame_eid, jplan.seg_eid)
        return jpk.unpack_frames(o, jplan, len(lengths), U)

    ref, jg = jax.jit(lambda p: (j_out(p), jax.grad(
        lambda q: _weighted(j_out(q), lengths))(p)))(jp)
    jg = load_jax_params(_np(jg))
    model = temf.Emformer(tcfg)
    model.load_state_dict(load_jax_params(_np(jp)))
    packed, rc = tpk.pack_frames(torch.from_numpy(x[:, :U]), tplan)
    out = tpk.unpack_frames(temf.emformer_forward_packed(
        model, tcfg, packed, rc, torch.from_numpy(tplan.frame_eid),
        torch.from_numpy(tplan.seg_eid)), tplan)
    _weighted(out, lengths).backward()
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(out[i, :n].detach().numpy(),
                                   np.asarray(ref)[i, :n], atol=2e-5,
                                   rtol=2e-5)
    for name, p in model.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(got.numpy(), jg[name].numpy(), atol=3e-4,
                                   rtol=3e-4, err_msg=name)


# ---------------------------------------------------------------------------
# post-LN in the decoder
# ---------------------------------------------------------------------------

DEC = dict(vocab_size=40, embed_dim=32, ffn_dim=64, num_layers=2,
           num_heads=2, encoder_embed_dim=32, max_target_positions=32,
           normalize_before=False, **NO_DROPOUT)


def _enc(rng, b=3, s=11):
    enc = rng.randn(b, s, 32).astype(np.float32)
    return enc, np.arange(s)[None, :] < np.array([11, 7, 3])[:, None]


def test_post_ln_decoder_forward_and_gradients_match_jax():
    """decoder_forward with normalize_before=False: logits atol 1e-4, and
    every parameter's gradient (and the encoder output's) of a weighted
    logit sum within 1e-4 of its largest entry."""
    jcfg, tcfg = jtfm.DecoderConfig(**DEC), ttfm.DecoderConfig(**DEC)
    jp = jtfm.decoder_init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(2)
    enc, valid = _enc(rng)
    prev = rng.randint(3, 40, size=(3, 5))
    prev[:, 0] = 2
    prev[2, 3:] = 1
    wts = rng.randn(3, 5, 40).astype(np.float32)

    def jloss(p, e):
        lg = jtfm.decoder_forward(p, jcfg, jnp.asarray(prev), e,
                                  jnp.asarray(valid))
        return (lg * wts).sum(), lg

    (_, ref), (jg, jge) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(jp, jnp.asarray(enc))
    jg = load_jax_params(_np(jg))
    model = ttfm.Decoder(tcfg, device="cpu")
    model.load_state_dict(load_jax_params(_np(jp)))
    et = torch.from_numpy(enc).requires_grad_()
    lg = ttfm.decoder_forward(model, tcfg, torch.from_numpy(prev), et,
                              torch.from_numpy(valid))
    (lg * torch.from_numpy(wts)).sum().backward()
    np.testing.assert_allclose(lg.detach().numpy(), np.asarray(ref),
                               atol=1e-4, rtol=1e-4)
    _close_to_largest(et.grad.numpy(), jge, 1e-4, "encoder_out")
    for name, p in model.named_parameters():
        if name.endswith("k_proj.bias"):   # exact gradient 0 on both sides
            continue
        _close_to_largest(p.grad.numpy(), jg[name].numpy(), 1e-4, name)


def test_post_ln_decoder_step_matches_jax():
    """decoder_step with normalize_before=False, six tokens: logits atol
    1e-4 at every step, and the KV caches atol 1e-5."""
    jcfg, tcfg = jtfm.DecoderConfig(**DEC), ttfm.DecoderConfig(**DEC)
    jp = jtfm.decoder_init(jax.random.PRNGKey(1), jcfg)
    model = ttfm.Decoder(tcfg, device="cpu")
    model.load_state_dict(load_jax_params(_np(jp)))
    rng = np.random.RandomState(0)
    enc, valid = _enc(rng)
    jstate = jtfm.decoder_init_state(jcfg, 3, 8)
    tstate = ttfm.decoder_init_state(tcfg, 3, 8)
    for tok in rng.randint(0, 40, size=(6, 3)):
        jl, jstate = jtfm.decoder_step(jp, jcfg, jstate, jnp.asarray(tok),
                                       jnp.asarray(enc), jnp.asarray(valid))
        with torch.no_grad():
            tl, tstate = ttfm.decoder_step(model, tcfg, tstate,
                                           torch.from_numpy(tok),
                                           torch.from_numpy(enc),
                                           torch.from_numpy(valid))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
    for jc, tc in zip(jstate.caches, tstate.caches):
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=1e-5)


# ---------------------------------------------------------------------------
# a model with a silu FFN, and the VGG frontend
# ---------------------------------------------------------------------------

SMALL = dict(vocab_size=40, input_feat=8, conv_channels=16, embed_dim=64,
             ffn_dim=128, encoder_layers=2, encoder_heads=2, decoder_layers=2,
             decoder_heads=2, decoder_ffn_dim=128, segment_length=16,
             left_context=32, right_context=8, max_memory=2,
             max_target_positions=64, ctc_layer=True, **NO_DROPOUT)


def _asr_batch():
    """Two utterances of 128 / 90 frames with 7 / 4 target tokens + EOS."""
    rng = np.random.RandomState(9)
    target = np.ones((2, 8), np.int32)
    prev = np.ones((2, 8), np.int32)
    for j, n in enumerate((7, 4)):
        toks = np.append(rng.randint(4, 40, n), 2)
        target[j, :n + 1] = toks
        prev[j, :n + 1] = np.append(2, toks[:-1])
    return {"feats": rng.randn(2, 128, 8).astype(np.float32),
            "feat_lengths": np.array([128, 90], np.int32),
            "target": target, "prev_tokens": prev}


@pytest.mark.parametrize("activation", ["silu", "tanh"])
def test_model_with_activation_matches_jax(activation):
    """s2t_emformer with activation=silu / tanh (encoder and decoder FFNs)
    and a CTC head: the joint-CTC loss rtol 1e-5 and every parameter's
    gradient within 1e-4 of its largest entry (a decoder key bias, exact
    gradient 0, is skipped)."""
    over = dict(SMALL, activation=activation)
    jmodel = js2t.S2TEmformerModel(js2t.S2TEmformerConfig(**over))
    jp = jmodel.init(jax.random.PRNGKey(0))
    batch = _asr_batch()

    def jloss(params):
        logits, extra = jmodel.forward(params, batch["feats"],
                                       batch["feat_lengths"],
                                       batch["prev_tokens"])
        return jjc.joint_ctc_loss(logits, extra, jnp.asarray(batch["target"]),
                                  jjc.JointCTCConfig())[0]

    loss_j, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    jg = load_jax_params(_np(jg))
    model = ts2t.S2TEmformerModel(ts2t.S2TEmformerConfig(**over),
                                  device="cpu")
    model.load_state_dict(load_jax_params(_np(jp)))
    loss_fn = tcli.build_loss(tcli.parse_args(
        ["--task", "asr", "--model", "s2t_emformer", "--loss", "joint_ctc",
         "--no-specaugment"]), None)
    loss, _ = loss_fn(model, {k: torch.from_numpy(v)
                              for k, v in batch.items()}, None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    for name, p in model.named_parameters():
        if name.endswith("k_proj.bias"):
            continue
        _close_to_largest(p.grad.numpy(), jg[name].numpy(), 1e-4, name)


def test_vgg_block_matches_jax_with_lengths_and_causality():
    """vgg_block_apply vs JAX's (atol 1e-5, out lengths equal), its input
    gradient within 1e-5 of the largest entry, and causality: zeroing
    frames from 12 on leaves the first 3 outputs as they were."""
    jp = jconv.vgg_block_init(jax.random.PRNGKey(0), input_dim=16,
                              mid_channels=8, out_channels=12)
    arrays = {k: v for k, v in jp.items() if k != "kernel_sizes"}
    block = tconv.VGGBlock(16, 1, 8, 12, jp["kernel_sizes"])
    block.load_state_dict(load_jax_params(_np(arrays)))
    x = np.random.RandomState(1).randn(2, 21, 16).astype(np.float32)
    lens = np.array([21, 12], np.int32)
    (ref, ref_len), vjp = jax.vjp(
        lambda a: jconv.vgg_block_apply(jp, a, jnp.asarray(lens)),
        jnp.asarray(x))
    dy = np.random.RandomState(2).randn(*ref.shape).astype(np.float32)
    (jdx,) = vjp((jnp.asarray(dy), np.zeros(ref_len.shape,
                                            jax.dtypes.float0)))
    xt = torch.from_numpy(x).requires_grad_()
    out, out_len = tconv.vgg_block_apply(block, xt, torch.from_numpy(lens))
    out.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5)
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(ref_len))
    _close_to_largest(xt.grad.numpy(), jdx, 1e-5)
    x2 = x.copy()
    x2[:, 12:] = 0.0
    with torch.no_grad():
        out2, _ = tconv.vgg_block_apply(block, torch.from_numpy(x2),
                                        torch.from_numpy(lens))
    np.testing.assert_allclose(out2[:, :3].numpy(),
                               out[:, :3].detach().numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# the CLI: --override compute_dtype / remat reach the model and the
# checkpoint, and serving reads them back
# ---------------------------------------------------------------------------

def test_cli_trains_bf16_with_remat_and_serves_it(tmp_path, monkeypatch):
    """cli/train --task st --model cif --device cpu --override
    compute_dtype=bfloat16 --override remat=true: one update whose model
    computes in bf16 (the encoder output's dtype; the parameters stay
    fp32) with every Emformer layer checkpointed; the checkpoint's
    metadata keeps both keys, and stream/build.build_agent loads a model
    whose config has them and whose session state is bf16."""
    rows = tsyn.mustc_like_rows(8, seed=2, tmpdir=str(tmp_path), feat_dim=8)
    for r in rows:
        r["n_frames"] = str(min(int(r["n_frames"]), 300))
    header = "id\taudio\tn_frames\tsrc_text\ttgt_text\tspeaker"
    for split, part in (("train", rows[:6]), ("dev", rows[6:])):
        (tmp_path / f"{split}_st.tsv").write_text("\n".join(
            [header] + ["\t".join(r[c] for c in header.split("\t"))
                        for r in part]) + "\n")
    vocab_path = tmp_path / "spm_unigram.txt"
    vocab_path.write_text("".join(f"\u2581{c * 3} 1\n" for c in "abcdefghij"))
    seen = {"dtypes": set(), "checkpointed": 0}
    real_forward, real_checkpoint = ts2t.encoder_forward, temf.checkpoint

    def spy_forward(*a, **k):
        out = real_forward(*a, **k)
        seen["dtypes"].add(out.encoder_out.dtype)
        return out

    def spy_checkpoint(*a, **k):
        seen["checkpointed"] += 1
        return real_checkpoint(*a, **k)

    monkeypatch.setattr(ts2t, "encoder_forward", spy_forward)
    monkeypatch.setattr(temf, "checkpoint", spy_checkpoint)
    small = [f"--override={k}={v}" for k, v in SMALL.items()
             if k not in ("vocab_size", "ctc_layer")]
    save = tmp_path / "ckpt"
    state = tcli.main([
        "--task", "st", "--model", "cif", "--loss", "cif",
        "--override", "compute_dtype=bfloat16", "--override", "remat=true",
        "--data", str(tmp_path), "--device", "cpu", "--max-updates", "1",
        "--max-tokens", "1200", "--save-dir", str(save), *small])
    assert state.step == 1
    assert seen["dtypes"] == {torch.bfloat16}
    assert seen["checkpointed"] >= 2            # both layers, one update
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    agent = tbuild.build_agent(str(save / "checkpoint_last"),
                               tbuild.load_vocab(str(vocab_path)), "cif",
                               device="cpu")
    assert agent.cfg.compute_dtype == "bfloat16" and agent.cfg.remat
    session = agent.new_session()
    assert session.enc_state.carry.dtype == torch.bfloat16
    assert session.enc_buf.dtype == session.cif_buf.dtype == torch.bfloat16
