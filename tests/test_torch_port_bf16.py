"""bf16 compute (compute_dtype=bfloat16) and per-layer remat in
simulst_tpu_torch vs the JAX package, on the CPU.

Tiny configs (2 + 2 layers, width 64; the transducer 1 + 1, width 16);
the JAX init bridged with compat/jax_bridge.load_jax_params, parameters
fp32 on both sides and cast per op; seeded numpy inputs; JAX with
jax_default_matmul_precision float32 (tests/conftest.py).  Each model's
loss and every parameter gradient are computed three times: JAX fp32,
JAX bf16 and the port in bf16.  Two tolerances hold them, each stated
again at its test:

- the port's bf16 against JAX's bf16: the loss rtol BF16_LOSS_RTOL and
  every gradient within BF16_GRAD_RTOL of its largest fp32 entry (two
  bf16 programs that round in different places, each rounding at 2^-8);
- the port's bf16 distance to JAX's fp32 result at most BF16_RATIO times
  JAX's own bf16-to-fp32 distance: for the loss, and for the gradients
  as the largest over the parameters of each one's distance relative to
  its largest fp32 entry (so that it holds whichever program rounds
  where).

Remat is held to the port without remat bit for bit (dropout 0.1, one
RngStream: the same seeds and masks), and to JAX's remat gradients.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each
import jax.numpy as jnp  # noqa: E402

from simulst_tpu.losses import cif_loss as jcl  # noqa: E402
from simulst_tpu.losses import joint_ctc as jjc  # noqa: E402
from simulst_tpu.losses import mma_loss as jml  # noqa: E402
from simulst_tpu.losses import rnnt_loss as jrl  # noqa: E402
from simulst_tpu.models import cif as jcif  # noqa: E402
from simulst_tpu.models import mma as jmma  # noqa: E402
from simulst_tpu.models import s2t_emformer as js2t  # noqa: E402
from simulst_tpu.models import transducer as jtr  # noqa: E402
from simulst_tpu_torch.compat.jax_bridge import load_jax_params  # noqa: E402
from simulst_tpu_torch.losses import cif_loss as tcl  # noqa: E402
from simulst_tpu_torch.losses import joint_ctc as tjc  # noqa: E402
from simulst_tpu_torch.losses import mma_loss as tml  # noqa: E402
from simulst_tpu_torch.losses import rnnt_loss as trl  # noqa: E402
from simulst_tpu_torch.models import cif as tcif  # noqa: E402
from simulst_tpu_torch.models import mma as tmma  # noqa: E402
from simulst_tpu_torch.models import s2t_emformer as ts2t  # noqa: E402
from simulst_tpu_torch.models import transducer as ttr  # noqa: E402
from simulst_tpu_torch.nn.core import RngStream  # noqa: E402

BF16_LOSS_RTOL = 2e-3
BF16_GRAD_RTOL = 5e-2
BF16_RATIO = 2.0

NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
SMALL = dict(vocab_size=40, input_feat=8, conv_channels=16, embed_dim=64,
             ffn_dim=128, encoder_layers=2, encoder_heads=2, decoder_layers=2,
             decoder_heads=2, decoder_ffn_dim=128, segment_length=16,
             left_context=32, right_context=8, max_memory=2,
             max_target_positions=64, **NO_DROPOUT)
TRANSDUCER = dict(vocab_size=24, input_feat=80, conv_channels=16,
                  embed_dim=16, ffn_dim=32, encoder_layers=1,
                  encoder_heads=2, decoder_layers=1, decoder_heads=2,
                  decoder_ffn_dim=32, segment_length=16, left_context=32,
                  right_context=8, max_memory=2, ctc_layer=False,
                  **NO_DROPOUT)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(frames=(128, 90), feat=8, ntok=(7, 4)):
    """Utterances of the given frames, with ntok target tokens + EOS."""
    rng = np.random.RandomState(9)
    b, L = len(frames), max(ntok) + 1
    target = np.ones((b, L), np.int32)
    prev = np.ones((b, L), np.int32)
    for j, n in enumerate(ntok):
        toks = np.append(rng.randint(4, 20, n), 2)
        target[j, :n + 1] = toks
        prev[j, :n + 1] = np.append(2, toks[:-1])
    return {"feats": rng.randn(b, max(frames), feat).astype(np.float32),
            "feat_lengths": np.array(frames, np.int32),
            "target": target, "prev_tokens": prev}


# model name -> (JAX model and config classes, port's, JAX loss, port loss,
# config overrides, batch)
def _jax_joint_ctc(logits, extra, b):
    return jjc.joint_ctc_loss(logits, extra, b["target"],
                              jjc.JointCTCConfig())[0]


def _port_joint_ctc(logits, extra, b):
    return tjc.joint_ctc_loss(logits, extra, b["target"],
                              tjc.JointCTCConfig())[0]


MMA_LOSS = dict(latency_avg_weight=0.1)
CIF_LOSS = dict(ctc_factor=0.3, quant_factor=1.0, quant_type="align",
                cif_beta=1.0)
RNNT_LOSS = dict(fastemit_lambda=0.01, offline_factor=1.0)

MODELS = {
    "s2t_emformer": (
        (js2t.S2TEmformerModel, js2t.S2TEmformerConfig),
        (ts2t.S2TEmformerModel, ts2t.S2TEmformerConfig),
        _jax_joint_ctc, _port_joint_ctc, dict(SMALL, ctc_layer=True),
        _batch()),
    "mma": (
        (jmma.MMAModel, jmma.MMAConfig), (tmma.MMAModel, tmma.MMAConfig),
        lambda lg, ex, b: jml.mma_loss(lg, ex, b["target"], b["feat_lengths"],
                                       jml.MMALossConfig(**MMA_LOSS))[0],
        lambda lg, ex, b: tml.mma_loss(lg, ex, b["target"], b["feat_lengths"],
                                       tml.MMALossConfig(**MMA_LOSS))[0],
        dict(SMALL, simul_attn_type="infinite_lookback_fixed_pre_decision",
             fixed_pre_decision_ratio=2), _batch((96, 70))),
    "cif": (
        (jcif.CIFModel, jcif.CIFConfig), (tcif.CIFModel, tcif.CIFConfig),
        lambda lg, ex, b: jcl.cif_loss(lg, ex, b["target"], b["feat_lengths"],
                                       jcl.CIFLossConfig(**CIF_LOSS))[0],
        lambda lg, ex, b: tcl.cif_loss(lg, ex, b["target"], b["feat_lengths"],
                                       tcl.CIFLossConfig(**CIF_LOSS))[0],
        dict(SMALL, cif_beta=1.0, ctc_layer=True), _batch((96, 70))),
    "transducer": (
        (jtr.TransducerModel, jtr.TransducerConfig),
        (ttr.TransducerModel, ttr.TransducerConfig),
        lambda lat, ex, b: jrl.rnnt_criterion(
            lat, ex, jrl.RNNTLossConfig(**RNNT_LOSS))[0],
        lambda lat, ex, b: trl.rnnt_criterion(
            lat, ex, trl.RNNTLossConfig(**RNNT_LOSS))[0],
        TRANSDUCER, _batch((48, 40, 29), feat=80, ntok=(4, 2, 0))),
}


def _jax_run(name, dtype, remat=False):
    (jm, jc), _, jloss, _, over, batch = MODELS[name]
    jmodel = jm(jc(**over, compute_dtype=dtype, remat=remat))
    jp = jmodel.init(jax.random.PRNGKey(0))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def fn(params):
        logits, extra = jmodel.forward(params, jb["feats"],
                                       jb["feat_lengths"], jb["prev_tokens"])
        return jloss(logits, extra, jb).astype(jnp.float32)

    loss, grads = jax.jit(jax.value_and_grad(fn))(jp)
    return _np(jp), float(loss), load_jax_params(_np(grads))


def _port_run(name, params, dtype, remat=False, rngs=None):
    _, (tm, tc), _, tloss, over, batch = MODELS[name]
    model = tm(tc(**over, compute_dtype=dtype, remat=remat), device="cpu")
    model.load_state_dict(load_jax_params(params))
    tb = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                              else v) for k, v in batch.items()}
    kw = {} if rngs is None else {"rngs": rngs}
    logits, extra = model(tb["feats"], tb["feat_lengths"], tb["prev_tokens"],
                          **kw)
    loss = tloss(logits, extra, tb)
    loss.backward()
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad)
             for n, p in model.named_parameters()}
    return loss.item(), grads, logits


@pytest.fixture(scope="module")
def jax_runs():
    """Each model's JAX (params, fp32 loss and gradients, bf16 loss and
    gradients), computed once per model."""
    cache = {}

    def get(name):
        if name not in cache:
            params, l32, g32 = _jax_run(name, "float32")
            _, l16, g16 = _jax_run(name, "bfloat16")
            cache[name] = (params, l32, g32, l16, g16)
        return cache[name]
    return get


def _skip_exact_zero(name):
    # a key bias adds one q.b to every score of a row, which the softmax
    # ignores: its exact gradient is 0 and every program holds rounding
    # noise there
    return name.endswith(("k_proj.bias", "k_proj_soft.bias"))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bf16_loss_and_gradients_match_jax(name, jax_runs):
    """The port's bf16 loss and every parameter's gradient vs JAX's bf16
    (loss rtol BF16_LOSS_RTOL 2e-3; gradients within BF16_GRAD_RTOL 5e-2
    of their largest fp32 entry), and vs JAX's fp32 no further than
    BF16_RATIO 2x JAX's own bf16 distance (the loss, and the gradients'
    largest relative distance).  The logits come out in bf16."""
    params, l32, g32, l16, g16 = jax_runs(name)
    loss, grads, logits = _port_run(name, params, "bfloat16")
    assert logits.dtype == torch.bfloat16
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, l16, rtol=BF16_LOSS_RTOL)
    assert abs(loss - l32) <= BF16_RATIO * abs(l16 - l32) + 1e-5 * abs(l32)
    assert sorted(grads) == sorted(g32)
    port_far = jax_far = 0.0
    for pname, g in grads.items():
        if _skip_exact_zero(pname):
            continue
        got, j16, j32 = (np.asarray(a, np.float64) for a in
                         (g.float().numpy(), g16[pname], g32[pname]))
        scale = max(np.abs(j32).max(), 1e-30)
        assert np.abs(got - j16).max() <= BF16_GRAD_RTOL * scale, pname
        port_far = max(port_far, np.abs(got - j32).max() / scale)
        jax_far = max(jax_far, np.abs(j16 - j32).max() / scale)
    assert port_far <= BF16_RATIO * jax_far, (port_far, jax_far)


def test_fp32_configs_are_unchanged(jax_runs):
    """compute_dtype=float32 (the default) still meets the fp32 parity of
    tests/test_torch_port_asr.py: loss rtol 1e-5, gradients within 1e-4 of
    their largest entry."""
    params, l32, g32, _, _ = jax_runs("s2t_emformer")
    loss, grads, logits = _port_run("s2t_emformer", params, "float32")
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(loss, l32, rtol=1e-5)
    for pname, g in grads.items():
        if _skip_exact_zero(pname):
            continue
        scale = max(np.abs(g32[pname]).max(), 1e-30)
        assert np.abs(g.numpy() - g32[pname].numpy()).max() <= 1e-4 * scale


# ---------------------------------------------------------------------------
# streaming == offline in bf16
# ---------------------------------------------------------------------------

def test_bf16_encoder_step_equals_offline(jax_runs):
    """encoder_step over a chunk plan of (seg + rc) * stride then seg *
    stride raw frames and a finish call, in bf16, vs the port's own bf16
    offline encoder_forward: every frame within BF16_STREAM_ATOL 0.05
    (the encoder output is layer-normed, O(1); one bf16 ulp there is
    2^-8), the session's state in bf16; and vs JAX's bf16 offline encoder
    within the same tolerance."""
    params = jax_runs("s2t_emformer")[0]
    over = dict(SMALL, ctc_layer=True, compute_dtype="bfloat16")
    model = ts2t.S2TEmformerModel(ts2t.S2TEmformerConfig(**over),
                                  device="cpu")
    model.load_state_dict(load_jax_params(params))
    cfg = model.cfg
    feats = np.random.RandomState(5).randn(1, 150, 8).astype(np.float32)
    with torch.no_grad():
        off = ts2t.encoder_forward(model.encoder, cfg, torch.from_numpy(feats),
                                   torch.tensor([150]))
        state = ts2t.encoder_init_state(model.encoder, cfg, 1)
        assert state.carry.dtype == torch.bfloat16
        chunks, t = [], 0
        for size in [24] + [16] * 20:
            if t + size > 150:
                break
            chunks.append(feats[:, t:t + size])
            t += size
        outs = []
        for c in chunks:
            out, state = ts2t.encoder_step(model.encoder, cfg, state,
                                           torch.from_numpy(c))
            outs.append(out.encoder_out)
        out, state = ts2t.encoder_step(model.encoder, cfg, state,
                                       torch.from_numpy(feats[:, t:]),
                                       finish=True)
        outs.append(out.encoder_out)
    streamed = torch.cat(outs, dim=1)
    assert streamed.dtype == torch.bfloat16
    assert streamed.shape == off.encoder_out.shape
    np.testing.assert_allclose(streamed.float().numpy(),
                               off.encoder_out.float().numpy(), atol=0.05)
    jcfg = js2t.S2TEmformerConfig(**over)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref = jax.jit(lambda p, f: js2t.encoder_forward(
        p, jcfg, f, jnp.asarray([150])))(jp["encoder"], jnp.asarray(feats))
    np.testing.assert_allclose(
        off.encoder_out.float().numpy(),
        np.asarray(ref.encoder_out.astype(jnp.float32)), atol=0.05)


def test_serving_keeps_each_weight_cast_with_the_same_bits(jax_runs):
    """nn/core.cast with grad off keeps a parameter's bf16 cast until the
    parameter changes: a bf16 decoder step reads the kept casts (one
    object per parameter, made once over two steps), and its logits equal
    bit for bit those of the same step with grad on, which casts every
    weight per op; an in-place update or load_state_dict makes the cast
    again, equal to a fresh one; a parameter made in inference mode is
    cast on each call."""
    from simulst_tpu_torch.nn import core as tcore
    from simulst_tpu_torch.nn import transformer as ttfm
    params = jax_runs("s2t_emformer")[0]
    over = dict(SMALL, ctc_layer=True, compute_dtype="bfloat16")
    model = ts2t.S2TEmformerModel(ts2t.S2TEmformerConfig(**over),
                                  device="cpu")
    model.load_state_dict(load_jax_params(params))
    dcfg = model.cfg.decoder
    rng = np.random.RandomState(3)
    enc = torch.from_numpy(rng.randn(2, 9, 64).astype(np.float32)).bfloat16()
    valid = torch.ones(2, 9, dtype=torch.bool)
    toks = torch.from_numpy(rng.randint(3, 40, size=(2, 2)))

    def two_steps():
        state = ttfm.decoder_init_state(dcfg, 2, 4)
        outs = []
        for t in range(2):
            logits, state = ttfm.decoder_step(model.decoder, dcfg, state,
                                              toks[:, t], enc, valid)
            outs.append(logits)
        return torch.stack(outs)

    made = []
    real_to = torch.nn.Parameter.to

    def counting_to(self, *a, **k):
        made.append(self)
        return real_to(self, *a, **k)

    with torch.no_grad():
        torch.nn.Parameter.to = counting_to
        try:
            kept = two_steps()
        finally:
            torch.nn.Parameter.to = real_to
    assert made and len({id(p) for p in made}) == len(made)
    per_op = two_steps()             # grad on: a cast per use
    assert per_op.dtype == torch.bfloat16
    assert torch.equal(kept, per_op.detach())
    w = model.decoder.layers[0].fc1.weight
    with torch.no_grad():
        first = tcore.cast(w, torch.bfloat16)
        assert tcore.cast(w, torch.bfloat16) is first
        w.mul_(1.5)
        again = tcore.cast(w, torch.bfloat16)
        assert again is not first
        assert torch.equal(again, w.to(torch.bfloat16))
        model.load_state_dict(load_jax_params(params))
        assert torch.equal(tcore.cast(w, torch.bfloat16),
                           w.to(torch.bfloat16))
    with torch.inference_mode():     # no version to watch: cast each call
        lin = tcore.Linear(4, 3)
        a = tcore.cast(lin.weight, torch.bfloat16)
        assert tcore.cast(lin.weight, torch.bfloat16) is not a
        assert torch.equal(a, lin.weight.to(torch.bfloat16))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_step_casts_give_the_bits_of_casts_per_use(name):
    """Three bf16 train steps (dropout 0.1, one RngStream each) with the
    parameters' casts made together per step (train/state's
    nn/core.step_casts) and with a cast per use: every gradient of every
    step and every parameter after the updates equal bit for bit; from the
    second step on the projections' weights are cast together and the
    LayerNorm parameters (used in fp32) are not."""
    import contextlib
    from simulst_tpu_torch.train import state as tstate
    from simulst_tpu_torch.train.optim import OptimConfig
    _, (tm, tc), _, tloss, over, batch = MODELS[name]
    over = dict(over, compute_dtype="bfloat16", dropout=0.1,
                attention_dropout=0.1, activation_dropout=0.1)
    tb = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                              else v) for k, v in batch.items()}

    def loss_fn(model, b, rngs):
        logits, extra = model(b["feats"], b["feat_lengths"],
                              b["prev_tokens"], rngs=rngs)
        return tloss(logits, extra, b), {"sample_size": torch.tensor(1.0)}

    def run(together):
        model = tm(tc(**over), device="cpu",
                   generator=torch.Generator().manual_seed(0))
        st = tstate.create_train_state(model, OptimConfig())
        grads = []
        saved = tstate.step_casts
        if not together:
            tstate.step_casts = lambda m: contextlib.nullcontext()
        try:
            for i in range(3):
                rngs = RngStream(torch.Generator().manual_seed(i))
                m = tstate.accumulate_grads(st, loss_fn, tb, rngs)
                grads.append({n: p.grad.clone() for n, p in
                              model.named_parameters() if p.grad is not None})
                st, _ = tstate.apply_update(st, m, OptimConfig())
        finally:
            tstate.step_casts = saved
        return model, grads

    (a, ga), (b, gb) = run(True), run(False)
    for x, y in zip(ga, gb):
        assert set(x) == set(y)
        for k in x:
            assert torch.equal(x[k], y[k]), k
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    together = {n for n, p in a.named_parameters()
                if getattr(p, "_step_cast", None) == torch.bfloat16}
    assert any(n.endswith("fc1.weight") for n in together)
    assert not any(n.endswith(("ln.scale", "final_ln.bias"))
                   for n in together)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

def test_remat_gradients_equal_without_remat_under_dropout():
    """s2t_emformer at dropout 0.1 (every site) with one RngStream seed:
    remat=true gives the loss and every gradient bit for bit equal to
    remat=false, in fp32 and in bf16 (each layer's seeds are recorded on
    its first run and replayed by the recomputation, which so redraws the
    same masks)."""
    over = dict(SMALL, ctc_layer=True, dropout=0.1, attention_dropout=0.1,
                activation_dropout=0.1)
    batch = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                 else v) for k, v in _batch().items()}
    init = ts2t.S2TEmformerModel(ts2t.S2TEmformerConfig(**over), device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    for dtype in ("float32", "bfloat16"):
        runs = []
        for remat in (False, True):
            model = ts2t.S2TEmformerModel(
                ts2t.S2TEmformerConfig(**over, compute_dtype=dtype,
                                       remat=remat), device="cpu")
            model.load_state_dict(init.state_dict())
            logits, extra = model(
                batch["feats"], batch["feat_lengths"], batch["prev_tokens"],
                rngs=RngStream(torch.Generator().manual_seed(7)))
            loss = _port_joint_ctc(logits, extra, batch)
            loss.backward()
            runs.append((loss.detach(), {n: p.grad.clone() for n, p in
                                         model.named_parameters()}))
        (l0, g0), (l1, g1) = runs
        assert torch.equal(l0, l1), dtype
        for n in g0:
            assert torch.equal(g0[n], g1[n]), (dtype, n)


def test_remat_gradients_match_jax_remat(jax_runs):
    """remat=true at dropout 0 vs JAX's remat=true (jax.checkpoint per
    layer): the loss rtol 1e-5 and every gradient within 1e-4 of its
    largest entry, fp32; and JAX's remat gradients equal its own without
    remat at the same tolerance."""
    _, l32, g32, _, _ = jax_runs("s2t_emformer")
    params, lr, gr = _jax_run("s2t_emformer", "float32", remat=True)
    loss, grads, _ = _port_run("s2t_emformer", params, "float32", remat=True)
    np.testing.assert_allclose(loss, lr, rtol=1e-5)
    np.testing.assert_allclose(lr, l32, rtol=1e-5)
    for pname, g in grads.items():
        if _skip_exact_zero(pname):
            continue
        scale = max(np.abs(gr[pname]).max(), 1e-30)
        assert np.abs(g.numpy() - gr[pname].numpy()).max() <= 1e-4 * scale
        assert np.abs(g32[pname].numpy() - gr[pname].numpy()).max() <= \
            1e-4 * scale


def test_remat_is_a_config_field_of_every_model():
    """remat and compute_dtype pass from the model config to the Emformer
    and the decoder configs."""
    for cls in (ts2t.S2TEmformerConfig, tmma.MMAConfig, tcif.CIFConfig,
                ttr.TransducerConfig):
        cfg = cls(compute_dtype="bfloat16", remat=True)
        assert cfg.emformer.remat and cfg.dtype == torch.bfloat16
        assert cfg.decoder.compute_dtype == "bfloat16"
        assert dataclasses.replace(cfg, remat=False).emformer.remat is False
