"""The Transformer-Transducer of simulst_tpu_torch vs the JAX package, on
the CPU: `downsample_pool`, the teacher-forced lattice of
`TransducerModel.forward`, the RNN-T loss (with FastEmit and ragged
lengths) and the SSNT loss with their gradients, `rnnt_criterion`'s loss
and every parameter gradient, one `cli/train --model transducer --loss
rnnt` update from an ASR checkpoint, `decode_step` online and offline from
a moved emit cursor, and `decode_batch` at beam 1 and 3.

Small models (tests/test_transducer_e2e.py's `_cfg`): width 16, one
encoder and one label-encoder layer, 2 heads, FFN 32, vocab 24, segment
4 / left context 8 / right context 2 frames after subsampling; JAX init
bridged to the port (compat/jax_bridge.load_jax_params); fp32 with
jax_default_matmul_precision float32 (tests/conftest.py).  Tolerances:
`downsample_pool` exactly; the lattice and the decode logits atol 1e-5;
the losses rtol 1e-5 and their gradients within 1e-5 of the largest
entry; the model's parameter gradients within 1e-4 of their largest
entry (a key bias, whose exact gradient is 0, of its weight's); emit
flags, emit positions and decoded tokens exactly.
"""
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each
import jax.numpy as jnp  # noqa: E402

from simulst_tpu.cli import generate as jgen  # noqa: E402
from simulst_tpu.decode.beam import BeamConfig as JBeam  # noqa: E402
from simulst_tpu.losses import rnnt_loss as jrl  # noqa: E402
from simulst_tpu.losses import ssnt_loss as jsl  # noqa: E402
from simulst_tpu.models import transducer as jtr  # noqa: E402
from simulst_tpu.ops import rnnt as jrnnt  # noqa: E402
from simulst_tpu.ops import ssnt as jssnt  # noqa: E402
from simulst_tpu_torch.cli import generate as tgen  # noqa: E402
from simulst_tpu_torch.cli import train as tcli  # noqa: E402
from simulst_tpu_torch.compat.jax_bridge import load_jax_params  # noqa: E402
from simulst_tpu_torch.decode.beam import BeamConfig as TBeam  # noqa: E402
from simulst_tpu_torch.losses import rnnt_loss as trl  # noqa: E402
from simulst_tpu_torch.losses import ssnt_loss as tsl  # noqa: E402
from simulst_tpu_torch.models import s2t_emformer as ts2t  # noqa: E402
from simulst_tpu_torch.models import transducer as ttr  # noqa: E402
from simulst_tpu_torch.ops import rnnt as trnnt  # noqa: E402
from simulst_tpu_torch.ops import ssnt as tssnt  # noqa: E402
from simulst_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from test_torch_port_mma import _write_manifest  # noqa: E402

SMALL = dict(vocab_size=24, input_feat=80, conv_channels=16, embed_dim=16,
             ffn_dim=32, encoder_layers=1, encoder_heads=2, decoder_layers=1,
             decoder_heads=2, decoder_ffn_dim=32, segment_length=16,
             left_context=32, right_context=8, max_memory=2,
             ctc_layer=False, dropout=0.0, attention_dropout=0.0,
             activation_dropout=0.0)


def _close_to_largest(got, want, rtol, scale=None, name=""):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    ref = np.abs(np.asarray(want if scale is None else scale)).max()
    assert err <= rtol * max(ref, 1e-30), (name, err, ref)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair(downsample=1, seed=0, blank_scale=1.0):
    """(JAX model, JAX params, port model) with one init; the blank's
    embedding row scaled by blank_scale (the joiner's output layer is the
    embedding, so a larger row makes more frames predict blank)."""
    cfg = dict(SMALL, downsample=downsample)
    jmodel = jtr.TransducerModel(jtr.TransducerConfig(**cfg))
    jp = jmodel.init(jax.random.PRNGKey(seed))
    emb = jp["decoder"]["embed_tokens"]
    emb["weight"] = emb["weight"].at[0].multiply(blank_scale)
    tmodel = ttr.TransducerModel(ttr.TransducerConfig(**cfg), device="cpu")
    tmodel.load_state_dict(load_jax_params(jax.tree_util.tree_map(np.asarray,
                                                                  jp)))
    return jmodel, jp, tmodel.eval()


def _batch():
    """Three utterances of 48 / 40 / 29 frames with 4 / 2 / 0 target
    tokens + EOS, EOS-fronted and right-padded."""
    rng = np.random.RandomState(9)
    prev = np.ones((3, 5), np.int32)
    for j, n in enumerate((4, 2, 0)):
        prev[j, :n + 1] = np.append(2, rng.randint(4, 24, n))
    return {"feats": rng.randn(3, 48, 80).astype(np.float32),
            "feat_lengths": np.array([48, 40, 29], np.int32),
            "prev_tokens": prev}


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3])
def test_downsample_pool_matches_jax(k):
    """Ragged lengths (11, 7, 1, 9 of 11 frames; a partial last window at
    k 2 and 3): the pooled frames and lengths equal JAX's exactly."""
    rng = np.random.RandomState(k)
    x = rng.randn(4, 11, 5).astype(np.float32)
    lengths = np.array([11, 7, 1, 9], np.int32)
    jx, jl = jtr.downsample_pool(jnp.asarray(x), jnp.asarray(lengths), k)
    tx, tl = ttr.downsample_pool(_t(x), _t(lengths).long(), k)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


@pytest.mark.parametrize("downsample", [1, 2])
def test_forward_lattice_matches_jax(downsample):
    """The (B, S, U+1, V) lattice, the label rewrite [bos, y.., eos] and
    the pooled encoder lengths."""
    jmodel, jp, tmodel = _pair(downsample)
    b = _batch()
    jlat, jextra = jax.jit(jmodel.forward)(
        jp, jnp.asarray(b["feats"]), jnp.asarray(b["feat_lengths"]),
        jnp.asarray(b["prev_tokens"]))
    with torch.no_grad():
        lat, extra = tmodel(_t(b["feats"]), _t(b["feat_lengths"]),
                            _t(b["prev_tokens"]))
    assert lat.shape == jlat.shape
    np.testing.assert_allclose(lat.numpy(), np.asarray(jlat), atol=1e-5,
                               rtol=0)
    for key in ("label_tokens", "label_lengths", "encoder_lengths"):
        np.testing.assert_array_equal(extra[key].numpy(),
                                      np.asarray(jextra[key]))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _loss_inputs(u_extra=1):
    rng = np.random.RandomState(4)
    b, t, u, v = 3, 9, 5, 7
    logits = rng.randn(b, t, u + u_extra, v).astype(np.float32) * 2
    targets = rng.randint(1, v, (b, u)).astype(np.int32)
    return logits, targets


def _jax_rnnt(lp, targets, il, tl, fastemit):
    return jax.jit(jax.value_and_grad(
        lambda x: jrnnt.rnnt_loss(x, jnp.asarray(targets), jnp.asarray(il),
                                  jnp.asarray(tl), 0, fastemit)))(
        jnp.asarray(lp))


@pytest.mark.parametrize("fastemit,ragged", [(0.0, False), (0.01, False),
                                             (0.0, True), (0.01, True)])
def test_rnnt_loss_matches_jax(fastemit, ragged):
    """The summed NLL rtol 1e-5 and d loss / d log_probs within 1e-5 of
    its largest entry; ragged: input lengths 9 / 6 / 1, target lengths
    5 / 2 / 0."""
    logits, targets = _loss_inputs()
    il = np.array([9, 6, 1] if ragged else [9, 9, 9], np.int32)
    tl = np.array([5, 2, 0] if ragged else [5, 5, 5], np.int32)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
    want, jgrad = _jax_rnnt(lp, targets, il, tl, fastemit)
    x = _t(lp).requires_grad_()
    got = trnnt.rnnt_loss(x, _t(targets), _t(il), _t(tl), 0, fastemit)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    _close_to_largest(x.grad.numpy(), jgrad, 1e-5)


def test_rnnt_loss_skips_rows_without_frames():
    """A batch-padding row (input length 0, target EOS alone) adds nothing:
    the loss and gradient of the other rows, JAX's on them alone; JAX adds
    about 1e30 for such a row."""
    logits, targets = _loss_inputs()
    il, tl = np.array([9, 0, 6], np.int32), np.array([5, 1, 2], np.int32)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
    keep = [0, 2]
    want, jgrad = _jax_rnnt(lp[keep], targets[keep], il[keep], tl[keep], 0.01)
    x = _t(lp).requires_grad_()
    got = trnnt.rnnt_loss(x, _t(targets), _t(il), _t(tl), 0, 0.01)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    _close_to_largest(x.grad.numpy()[keep], jgrad, 1e-5)
    assert not x.grad[1].any()
    assert float(_jax_rnnt(lp, targets, il, tl, 0.01)[0]) > 1e29


@pytest.mark.parametrize("ragged", [False, True])
def test_ssnt_loss_matches_jax(ragged):
    """ssnt_loss (and ssnt_loss_mem, its alias) rtol 1e-5; the gradients
    of the token log-probs and of the emit logits within 1e-5 of their
    largest entries."""
    logits, targets = _loss_inputs(u_extra=0)
    emit = np.random.RandomState(5).randn(*logits.shape[:3]).astype(
        np.float32)
    il = np.array([9, 6, 1] if ragged else [9, 9, 9], np.int32)
    tl = np.array([5, 2, 0] if ragged else [5, 5, 5], np.int32)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
    want, (jg_lp, jg_emit) = jax.jit(jax.value_and_grad(
        lambda x, e: jssnt.ssnt_loss(x, e, jnp.asarray(targets),
                                     jnp.asarray(il), jnp.asarray(tl)),
        argnums=(0, 1)))(jnp.asarray(lp), jnp.asarray(emit))
    for fn in (tssnt.ssnt_loss, tssnt.ssnt_loss_mem):
        x, e = _t(lp).requires_grad_(), _t(emit).requires_grad_()
        got = fn(x, e, _t(targets), _t(il), _t(tl))
        got.backward()
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
        _close_to_largest(x.grad.numpy(), jg_lp, 1e-5)
        _close_to_largest(e.grad.numpy(), jg_emit, 1e-5)


def test_ssnt_criterion_matches_jax():
    logits, targets = _loss_inputs(u_extra=0)
    targets[1, 3:] = 1                               # padded
    emit = np.random.RandomState(6).randn(*logits.shape[:3]).astype(
        np.float32)
    il = np.array([9, 7, 4], np.int32)
    want, wm = jsl.ssnt_criterion(jnp.asarray(logits), jnp.asarray(emit),
                                  jnp.asarray(targets), jnp.asarray(il),
                                  jsl.SSNTLossConfig())
    got, gm = tsl.ssnt_criterion(_t(logits), _t(emit), _t(targets), _t(il),
                                 tsl.SSNTLossConfig())
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert int(gm["ntokens"]) == int(wm["ntokens"]) == 12
    assert gm["sample_size"] == gm["ntokens"]


@pytest.mark.parametrize("downsample", [1, 2])
def test_rnnt_criterion_loss_and_gradients_match_jax(downsample):
    """exp/6's criterion (FastEmit 0.01, offline factor 1, label smoothing
    0.1) on the 1 + 1-layer model: the loss, its RNN-T and offline NLL
    terms rtol 1e-5, every parameter's gradient within 1e-4 of its
    largest entry."""
    jmodel, jp, tmodel = _pair(downsample)
    b = _batch()
    kw = dict(fastemit_lambda=0.01, offline_factor=1.0)

    def jloss(p):
        lat, extra = jmodel.forward(p, jnp.asarray(b["feats"]),
                                    jnp.asarray(b["feat_lengths"]),
                                    jnp.asarray(b["prev_tokens"]))
        loss, m = jrl.rnnt_criterion(lat, extra, jrl.RNNTLossConfig(**kw))
        return loss, m

    (want, wm), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    lat, extra = tmodel(_t(b["feats"]), _t(b["feat_lengths"]),
                        _t(b["prev_tokens"]))
    got, gm = trl.rnnt_criterion(lat, extra, trl.RNNTLossConfig(**kw))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for key in ("rnnt_loss", "nll_loss"):
        np.testing.assert_allclose(float(gm[key]), float(wm[key]), rtol=1e-5)
    assert int(gm["ntokens"]) == int(wm["ntokens"]) == 9
    want_g = load_jax_params(jax.tree_util.tree_map(np.asarray, jgrads))
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(grads) == set(want_g)
    for name, g in grads.items():
        scale = want_g[name]
        if name.endswith("k_proj.bias"):
            scale = want_g[name[:-len("bias")] + "weight"]
        _close_to_largest(g.numpy(), want_g[name], 1e-4, scale=scale,
                          name=name)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_trains_transducer_from_an_asr_checkpoint(tmp_path):
    """exp/6_transducer.sh's options (FastEmit 0.01, offline factor 1) on a
    MuST-C-shaped manifest, --device cpu: the encoder from a port ASR
    checkpoint with a CTC head (left behind), one update, a validation
    whose batch-padding rows add nothing, checkpoint_last stamped
    "transducer"; --task asr trains too."""
    _write_manifest(tmp_path)
    small = {k: v for k, v in SMALL.items()
             if k not in ("vocab_size", "ctc_layer", "input_feat")}
    asr = ts2t.S2TEmformerModel(
        ts2t.S2TEmformerConfig(vocab_size=14, ctc_layer=True, input_feat=8,
                               **small),
        device="cpu", generator=torch.Generator().manual_seed(3))
    tckpt.save_checkpoint(str(tmp_path / "asr_last"), asr.state_dict(),
                          {"model": "s2t_emformer"})
    args = ["--model", "transducer", "--loss", "rnnt",
            "--loss-override", "fastemit_lambda=0.01",
            "--loss-override", "offline_factor=1.0",
            "--load-pretrained-encoder-from", str(tmp_path / "asr_last"),
            "--lr", "5e-4", "--warmup-updates", "4000", "--clip-norm", "10",
            "--data", str(tmp_path), "--device", "cpu", "--max-updates", "1",
            "--max-tokens", "1600", "--override", "input_feat=8",
            *[f"--override={k}={v}" for k, v in small.items()]]
    for task in ("st", "asr"):
        save = tmp_path / task
        state = tcli.main(["--task", task, "--save-dir", str(save)] + args)
        assert state.step == 1
        last, meta = tckpt.load_checkpoint(str(save / "checkpoint_last"))
        assert meta["model"] == "transducer"
        assert "encoder.ctc_layer.weight" not in last
        assert "decoder.joiner.target_projection.weight" in last
        assert "decoder.joiner.target_projection.bias" not in last
        moved = max((last[k] - v).abs().max().item()
                    for k, v in asr.state_dict().items()
                    if k.startswith("encoder.") and k in last)
        assert 0 < moved < 1e-2           # loaded, then one small update
        # the validation batch holds padding rows, which add nothing
        valid = json.loads((save / "train_log.jsonl").read_text())
        assert valid["valid_update"] == 1 and 0 < valid["loss"] < 1e3


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("online", [False, True])
def test_decode_step_matches_jax(online):
    """Three examples (visible source 12 / 7 / 0 of 12 frames, emit
    cursors at 3 / 5 / 0) for five label steps, each fed the previous
    step's argmax, the blank's row doubled so that frames predict blank:
    logits atol 1e-5, the emit flags and positions exactly.  The first
    example emits past its cursor; the second sees only blank frames,
    which online is a READ and offline the forced emit at its last
    frame."""
    jmodel, jp, tmodel = _pair(seed=1, blank_scale=2.0)
    cfg = tmodel.cfg
    rng = np.random.RandomState(1)
    src = (rng.randn(3, 12, 16) * 3).astype(np.float32)
    src_len = np.array([12, 7, 0], np.int32)
    jstate = jmodel.init_decode_state(3, 8)._replace(
        prev_emit=jnp.array([3, 5, 0], jnp.int32))
    state = ttr.init_decode_state(cfg, 3, 8, device="cpu")._replace(
        prev_emit=_t([3, 5, 0]).long())
    step = jax.jit(lambda st, tok: jmodel.decode_step(
        jp, st, tok, jnp.asarray(src), jnp.asarray(src_len), online))
    tok = np.zeros(3, np.int32)
    flags = []
    for _ in range(5):
        jlog, jemit, jstate = step(jstate, jnp.asarray(tok))
        with torch.no_grad():
            logits, emitted, state = ttr.decode_step(
                tmodel.decoder, cfg, state, _t(tok).long(), _t(src),
                _t(src_len).long(), online)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlog),
                                   atol=1e-5, rtol=0)
        np.testing.assert_array_equal(emitted.numpy(), np.asarray(jemit))
        np.testing.assert_array_equal(state.prev_emit.numpy(),
                                      np.asarray(jstate.prev_emit))
        flags.append(emitted.tolist())
        tok = np.asarray(jlog).argmax(-1).astype(np.int32)
    flags = np.array(flags)
    assert flags[:, 0].all() and not flags[:, 2].any(), flags
    assert flags[:, 1].all() != online, flags
    assert np.asarray(jstate.prev_emit).tolist() == [4, 5 if online else 6,
                                                     0]


@pytest.mark.parametrize("beam", [1, 3])
def test_decode_batch_transducer_matches_jax(beam):
    """cli/generate's offline decode, greedy and beam 3, max_len 10: the
    best hypotheses and their lengths equal JAX's decode_batch_transducer
    (reached through its decode_batch)."""
    jmodel, jp, tmodel = _pair(seed=2)
    b = _batch()
    batch = {"feats": b["feats"], "feat_lengths": b["feat_lengths"]}
    kw = dict(beam_size=beam, max_len=10)
    jtok, jlen = jgen.decode_batch(jmodel, jp, batch, JBeam(**kw))
    with torch.no_grad():
        ttok, tlen = tgen.decode_batch(tmodel, batch, TBeam(**kw))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    assert len(set(ttok[:, :3].flatten().tolist())) > 2, ttok


def test_ensemble_refuses_the_transducer():
    _, _, tmodel = _pair()
    with pytest.raises(ValueError, match="transducer"):
        tgen.decode_batch_ensemble([tmodel, tmodel],
                                   {"feats": np.zeros((1, 48, 80),
                                                      np.float32),
                                    "feat_lengths": np.array([48])},
                                   TBeam(beam_size=2, max_len=4))
