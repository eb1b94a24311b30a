"""The kernels' widths: the wrappers' width checks, and the port against
the JAX package at widths other than s2t_emformer_s's, on the CPU.

The CUDA kernels take D any multiple of 64 from 64 to 1024 (FFN, LN-FFN,
linear-res, attention), an FFN hidden any multiple of 64, head dims any
multiple of 8 from 8 to 128 (MHA, Emformer attention) and conv-pos
channels per group 1 or a multiple of 4 up to 64; their wrappers raise a
ValueError naming the width outside that, before anything reaches the
card (checked here through the launch paths with CPU tensors).  The
parity cases run the JAX package on its XLA paths (the CPU backend) with
jax_default_matmul_precision float32 (tests/conftest.py), weights bridged
with compat/jax_bridge.load_jax_params, at D 512 / 8 heads / FFN 2048 and
D 64 / 4 heads (head dim 16) / FFN 128, 2 + 1 layers: the logits and CTC
logits (every Emformer and decoder layer's forward) rtol 1e-5 / atol 1e-5
of the largest entry, the joint-CTC loss rtol 1e-5 and every parameter's
gradient within 1e-4 of its largest entry (a key bias's of its weight's),
one Adam step's parameters atol 1e-6; the conv-pos weight gradient's
plain version vs the Pallas kernel in interpret mode within 1e-5 of its
largest entry.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each
import jax.numpy as jnp  # noqa: E402

from simulst_tpu.losses import joint_ctc as jjc  # noqa: E402
from simulst_tpu.models import s2t_emformer as js2t  # noqa: E402
from simulst_tpu.ops.conv_pos_pallas import convpos_wgrad_pallas  # noqa: E402
from simulst_tpu.train.optim import OptimConfig as JOptim  # noqa: E402
from simulst_tpu.train.state import create_train_state as j_create  # noqa: E402
from simulst_tpu.train.state import make_train_step as j_make_step  # noqa: E402
from simulst_tpu_torch.cli import train as tcli  # noqa: E402
from simulst_tpu_torch.compat.jax_bridge import load_jax_params  # noqa: E402
from simulst_tpu_torch.models import s2t_emformer as ts2t  # noqa: E402
from simulst_tpu_torch.ops import conv_pos as tconv  # noqa: E402
from simulst_tpu_torch.ops import emformer_attn as tattn  # noqa: E402
from simulst_tpu_torch.ops import ffn as tffn  # noqa: E402
from simulst_tpu_torch.ops import mha as tmha  # noqa: E402
from simulst_tpu_torch.train.optim import OptimConfig  # noqa: E402
from simulst_tpu_torch.train.state import (create_train_state,  # noqa: E402
                                           make_train_step)

# ---------------------------------------------------------------------------
# the width checks
# ---------------------------------------------------------------------------

DIMS = list(range(64, 1025, 64))
HEAD_DIMS = list(range(8, 129, 8))
CHANNELS = [1] + list(range(4, 65, 4))


@pytest.mark.parametrize("d", DIMS)
def test_ffn_takes_every_width_of_the_matrix(d):
    """D every multiple of 64 from 64 to 1024, the hidden every multiple of
    64 up to 4096."""
    for hidden in (64, 2048, 4096, d * 4):
        tffn.check_widths("fused_ffn", d, hidden)


@pytest.mark.parametrize("d,hidden", [(32, 256), (96, 256), (1088, 4096),
                                      (0, 256), (256, 4096 + 32),
                                      (256, 100), (256, 0)])
def test_ffn_refuses_widths_just_outside(d, hidden):
    with pytest.raises(ValueError, match=f"{d}|{hidden}"):
        tffn.check_widths("fused_ffn", d, hidden)


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_attention_takes_every_head_dim_of_the_matrix(hd):
    """Head dims every multiple of 8 from 8 to 128, for the MHA and the
    Emformer attention (one check); the Emformer backward's block fits
    shared memory at s2t_emformer_s's geometry at every one of them."""
    for heads in (1, 4, 8):
        assert tmha.check_head_dim("fused_mha", hd * heads, heads) == hd
    geom = tattn.AttnGeom(U=256, seg=16, lc=32, rc=8, max_mem=5, G=8,
                          num_heads=4)
    unit, smem = tattn._fitting_unit("attn", geom, hd, backward=True)
    assert smem <= tattn.SMEM_LIMIT
    assert unit.acc_features == (64 if hd <= 64 else 32)


@pytest.mark.parametrize("d,heads", [(16, 4), (48, 4), (136 * 2, 2),
                                     (100, 4), (64, 0)])
def test_attention_refuses_head_dims_just_outside(d, heads):
    with pytest.raises(ValueError, match="head dim"):
        tmha.check_head_dim("fused_mha", d, heads)


@pytest.mark.parametrize("cg", CHANNELS)
def test_convpos_takes_every_channel_count_of_the_matrix(cg):
    assert tconv.check_channels("convpos_wgrad", cg * 16, 16) == cg


@pytest.mark.parametrize("d,groups", [(32, 16), (96, 16), (1088, 16),
                                      (48, 16), (64, 0)])
def test_convpos_refuses_channel_counts_just_outside(d, groups):
    with pytest.raises(ValueError, match="channel"):
        tconv.check_channels("convpos_wgrad", d, groups)


def test_launch_paths_raise_before_the_card():
    """The wrappers' CUDA paths (called here with CPU tensors) raise the
    ValueError naming the width before any launch."""
    x = torch.zeros(4, 96)
    with pytest.raises(ValueError, match="D=96"):
        tffn._launch(False, x, None, None, torch.zeros(96, 128),
                     torch.zeros(128), torch.zeros(128, 96), torch.zeros(96))
    q = torch.zeros(2, 3, 4 * 12)
    with pytest.raises(ValueError, match="head dim"):
        tmha._launch(q, q, q, torch.ones(2, 3, dtype=torch.int32), 4, False,
                     0.0, 0)
    geom = tattn.AttnGeom(U=32, seg=16, lc=16, rc=4, max_mem=2, G=2,
                          num_heads=3)
    q3 = torch.zeros(1, geom.ng, geom.nq, 3 * 12)
    k = torch.zeros(1, geom.tk, 3 * 12)
    with pytest.raises(ValueError, match="head dim"):
        tattn._launch(q3, k, k, torch.full((1,), 32, dtype=torch.int32),
                      geom, 0.0, 0)
    with pytest.raises(ValueError, match="channel"):
        tconv._launch(torch.zeros(2, 20, 96), torch.zeros(2, 5, 96), 16, 16)


# ---------------------------------------------------------------------------
# the port vs the JAX package at other widths
# ---------------------------------------------------------------------------

BASE = dict(vocab_size=40, input_feat=8, conv_channels=16, encoder_layers=2,
            decoder_layers=1, segment_length=16, left_context=32,
            right_context=8, max_memory=2, max_target_positions=64,
            ctc_layer=True, dropout=0.0, attention_dropout=0.0,
            activation_dropout=0.0)
WIDTHS = {"d512": dict(embed_dim=512, encoder_heads=8, decoder_heads=8,
                       ffn_dim=2048, decoder_ffn_dim=2048),
          "d64-hd16": dict(embed_dim=64, encoder_heads=4, decoder_heads=4,
                           ffn_dim=128, decoder_ffn_dim=128)}
T = 128          # feature frames: U = 32 after subsampling, 2 segments
OPTIM = dict(lr=1e-3, warmup_updates=10000, clip_norm=10.0)
ASR_ARGS = ["--task", "asr", "--model", "s2t_emformer", "--loss",
            "joint_ctc", "--override", "ctc_layer=true", "--no-specaugment"]


def _close_to_largest(got, want, rtol, scale=None, name=""):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    ref = np.abs(np.asarray(want if scale is None else scale)).max()
    assert err <= rtol * max(ref, 1e-30), (name, err, ref)


def _batch():
    rng = np.random.RandomState(11)
    feats = rng.randn(2, T, 8).astype(np.float32)
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


@pytest.fixture(scope="module", params=sorted(WIDTHS))
def wide_pair(request):
    cfg = dict(BASE, **WIDTHS[request.param])
    jmodel = js2t.S2TEmformerModel(js2t.S2TEmformerConfig(**cfg))
    jp = jmodel.init(jax.random.PRNGKey(0))
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, extra = jax.jit(lambda p, b: jmodel.forward(
        p, b["feats"], b["feat_lengths"], b["prev_tokens"]))(jp, jb)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        _jax_loss(jmodel), has_aux=True))(jp, jb, None)
    jstate, jm = jax.jit(j_make_step(_jax_loss(jmodel), JOptim(**OPTIM)))(
        j_create(jp, JOptim(**OPTIM)), jb, jax.random.PRNGKey(0))
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731
    return dict(cfg=cfg, params=as_np(jp), batch=batch,
                logits=np.asarray(logits),
                ctc_logits=np.asarray(extra["ctc_logits"]), loss=float(loss),
                grads=as_np(grads), stepped=as_np(jstate.params),
                gnorm=float(jm["gnorm"]))


def _port_model(pair):
    model = ts2t.S2TEmformerModel(ts2t.S2TEmformerConfig(**pair["cfg"]),
                                  device="cpu")
    model.load_state_dict(load_jax_params(pair["params"]))
    return model


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_forward_matches_jax_at_other_widths(wide_pair):
    """The decoder's logits and the CTC head's (every Emformer layer and
    the decoder layer forward): within 1e-5 of the largest entry."""
    model = _port_model(wide_pair)
    b = _torch_batch(wide_pair["batch"])
    with torch.no_grad():
        logits, extra = model(b["feats"], b["feat_lengths"],
                              b["prev_tokens"])
    _close_to_largest(logits.numpy(), wide_pair["logits"], 1e-5)
    _close_to_largest(extra["ctc_logits"].numpy(), wide_pair["ctc_logits"],
                      1e-5)


def test_loss_and_gradients_match_jax_at_other_widths(wide_pair):
    """The joint-CTC loss rtol 1e-5 and every parameter's gradient (the
    Emformer layers', the conv-pos weight norm's, the decoder layer's)
    within 1e-4 of its largest entry."""
    model = _port_model(wide_pair)
    loss_fn = tcli.build_loss(tcli.parse_args(ASR_ARGS), None)
    loss, _ = loss_fn(model, _torch_batch(wide_pair["batch"]), None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), wide_pair["loss"], rtol=1e-5)
    ref = load_jax_params(wide_pair["grads"])
    assert sorted(n for n, _ in model.named_parameters()) == sorted(ref)
    for name, p in model.named_parameters():
        scale = ref[name[:-len("bias")] + "weight"] \
            if name.endswith("k_proj.bias") else ref[name]
        _close_to_largest(p.grad.numpy(), ref[name], 1e-4, scale=scale,
                          name=name)


def test_train_step_matches_jax_at_other_widths(wide_pair):
    """One Adam step (lr 1e-3, warmup 10000, clip 10): the gradient norm
    rtol 1e-5, every updated parameter atol 1e-6."""
    model = _port_model(wide_pair)
    state = create_train_state(model, OptimConfig(**OPTIM))
    state, metrics = make_train_step(
        tcli.build_loss(tcli.parse_args(ASR_ARGS), None),
        OptimConfig(**OPTIM))(state, _torch_batch(wide_pair["batch"]))
    np.testing.assert_allclose(float(metrics["gnorm"]), wide_pair["gnorm"],
                               rtol=1e-5)
    for name, p in load_jax_params(wide_pair["stepped"]).items():
        np.testing.assert_allclose(model.state_dict()[name].numpy(),
                                   p.numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("d,groups", [(512, 16), (64, 16), (64, 64)])
def test_convpos_wgrad_matches_pallas_interpret_at_other_widths(d, groups):
    """The conv-pos weight gradient at 32, 4 and 1 channels a group (D 512
    and 64 in 16 groups, D 64 depthwise), 16 taps: the plain version (what
    the kernel is held to on the card) vs the Pallas kernel in interpret
    mode, within 1e-5 of the largest entry."""
    b, t, k = 2, 12, 16
    rng = np.random.RandomState(d + groups)
    xp = rng.randn(b, t + k - 1, d).astype(np.float32)
    dy = rng.randn(b, t, d).astype(np.float32)
    want = np.asarray(convpos_wgrad_pallas(jnp.asarray(xp), jnp.asarray(dy),
                                           k, groups, interpret=True))
    got = tconv.convpos_wgrad_plain(torch.from_numpy(xp),
                                    torch.from_numpy(dy), k, groups)
    _close_to_largest(got.numpy(), np.transpose(want, (2, 1, 0)), 1e-5)
