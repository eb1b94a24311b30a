"""The sequence-sharded and pipelined Emformer and the full-model
pipelined train loss of simulst_tpu_torch, on the CPU over gloo, against
the port's one-process path and the JAX package's counterparts
(emformer_forward_seq_sharded, emformer_forward_pipelined,
train/pipeline.pipelined_train_loss) on its virtual CPU mesh.

Each world (2 and 4 ranks) is spawned once for this file and runs every
case (simulst_tpu_torch/multichip.py).  Configs: the JAX tests' Emformer
(width 32, 2 heads, FFN 48, segment 4, left / right context 6 / 2, 2
memory slots) with 4 layers, and their 4 + 2-layer width-16 s2t_emformer
with conv-pos 8 in 4 groups; no dropout; JAX's init bridged to the port.
Tolerances, each stated again at its test: outputs and every parameter's
gradient atol 2e-5, rtol 1e-4 against JAX (the JAX package's own tests'),
the input's gradient within 1e-4 of its largest entry, and everything
within 1e-4 of the largest entry against the port's one process; the
pipelined loss and metrics rtol 2e-5, its gradients rtol 5e-4 atol 2e-5
against JAX (tests/test_full_pipeline_train.py's).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from simulst_tpu.losses.joint_ctc import JointCTCConfig as JLCfg  # noqa: E402
from simulst_tpu.models import s2t_emformer as js2t  # noqa: E402
from simulst_tpu.nn import emformer as jemf  # noqa: E402
from simulst_tpu.train.pipeline import \
    pipelined_train_loss as j_pipelined_loss  # noqa: E402
from simulst_tpu_torch import comm  # noqa: E402
from simulst_tpu_torch import multichip as mc  # noqa: E402
from simulst_tpu_torch.compat.jax_bridge import load_jax_params  # noqa: E402
from simulst_tpu_torch.losses.joint_ctc import JointCTCConfig  # noqa: E402
from simulst_tpu_torch.models import s2t_emformer as ts2t  # noqa: E402
from simulst_tpu_torch.nn import emformer as temf  # noqa: E402
from simulst_tpu_torch.train.pipeline import pipelined_train_loss  # noqa: E402

EMF = dict(input_dim=32, num_heads=2, ffn_dim=48, num_layers=4, dropout=0.0,
           attention_dropout=0.0, activation_dropout=0.0, activation="gelu",
           left_context=6, right_context=2, segment=4, max_memory=2,
           tanh_on_mem=True)
S2T = dict(vocab_size=24, input_feat=12, conv_channels=16, embed_dim=16,
           ffn_dim=32, encoder_layers=4, encoder_heads=2, decoder_layers=2,
           decoder_heads=2, decoder_ffn_dim=32, segment_length=16,
           left_context=32, right_context=8, max_memory=2, ctc_layer=True,
           dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
           conv_pos=8, conv_pos_groups=4)
JAX_TOL = dict(atol=2e-5, rtol=1e-4)
U_SEQ = 32              # 8 segments: 4 per rank at 2 ranks, 2 at 4
U_PIPE = 16
# (world, n_data) of the seq-sharded cases; (world, n_data, n_micro) of
# the pipelined ones; (world, n_stage, n_micro, n_data) of the train loss
SEQ = [(2, 1), (4, 1), (4, 2)]
PIPE = [(2, 1, 2), (4, 1, 4), (4, 2, 2)]
TRAIN = [(2, 2, 2, 1), (4, 4, 4, 1), (4, 2, 2, 2), (4, 2, 4, 2)]


def _as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _train_batch(cfg, B=4, T=72, L=6):
    """tests/test_full_pipeline_train.py's batch: two ragged rows and one
    short target."""
    rng = np.random.RandomState(0)
    feats = rng.randn(B, T, cfg.input_feat).astype(np.float32)
    lengths = np.full((B,), T, np.int32)
    lengths[1] = T - 9
    feats[1, T - 9:] = 0.0
    lengths[B - 1] = T - 17
    feats[B - 1, T - 17:] = 0.0
    prev = rng.randint(4, cfg.vocab_size, (B, L)).astype(np.int32)
    prev[:, 0] = cfg.eos_idx
    target = np.roll(prev, -1, axis=1)
    target[:, -1] = cfg.eos_idx
    prev[2, L - 2:] = cfg.padding_idx
    target[2, L - 3:] = [cfg.eos_idx, cfg.padding_idx, cfg.padding_idx]
    return {"feats": feats, "lengths": lengths.astype(np.int64),
            "prev": prev.astype(np.int64), "target": target.astype(np.int64)}


def _mesh(n, axes, shape=None):
    devs = np.array(jax.devices()[:n])
    return Mesh(devs.reshape(shape) if shape else devs, axes)


def _jax_grad_out(fn, params, x):
    """(out, param grads, x grad) of sum(fn(p, x) * w) through jax.grad."""
    def loss(p, x):
        out, w = fn(p, x)
        return (out * w).sum(), out
    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, x)
    grads = load_jax_params(_as_np(gp))
    grads["x"] = np.asarray(gx)
    return np.asarray(out), {k: np.asarray(v) for k, v in grads.items()}


@pytest.fixture(scope="module")
def setup():
    jcfg = jemf.EmformerConfig(**EMF)
    jp = jemf.emformer_init(jax.random.PRNGKey(0), jcfg)
    rs = np.random.RandomState(1)
    seq_x = rs.randn(2, U_SEQ + EMF["right_context"], 32).astype(np.float32)
    seq_len = np.array([U_SEQ, U_SEQ - 7], np.int64)
    seq_x[1, U_SEQ - 7:U_SEQ] = 0.0
    seq_w = rs.randn(2, U_SEQ, 32).astype(np.float32)
    pipe_x = rs.randn(4, U_PIPE + EMF["right_context"], 32).astype(
        np.float32)
    pipe_len = np.array([U_PIPE, U_PIPE - 3, U_PIPE, U_PIPE - 5], np.int64)
    pipe_w = rs.randn(4, U_PIPE, 32).astype(np.float32)
    jax_seq = {}
    for world, n_data in SEQ:
        mesh = (_mesh(world, ("seq",)) if n_data == 1 else
                _mesh(world, ("data", "seq"), (n_data, world // n_data)))
        jax_seq[(world, n_data)] = _jax_grad_out(
            lambda p, x, mesh=mesh, n_data=n_data: (
                jemf.emformer_forward_seq_sharded(
                    p, jcfg, x, jnp.asarray(seq_len), mesh,
                    data_axis="data" if n_data > 1 else None),
                jnp.asarray(seq_w)), jp, jnp.asarray(seq_x))
    jax_pipe = {}
    for world, n_data, n_micro in PIPE:
        mesh = (_mesh(world, ("pipe",)) if n_data == 1 else
                _mesh(world, ("pipe", "data"), (world // n_data, n_data)))
        jax_pipe[(world, n_data)] = _jax_grad_out(
            lambda p, x, mesh=mesh, n_data=n_data, n_micro=n_micro: (
                jemf.emformer_forward_pipelined(
                    p, jcfg, x, jnp.asarray(pipe_len), mesh,
                    n_micro=n_micro,
                    data_axis="data" if n_data > 1 else None),
                jnp.asarray(pipe_w)), jp, jnp.asarray(pipe_x))
    jmodel = js2t.S2TEmformerModel(js2t.S2TEmformerConfig(**S2T))
    jsp = jmodel.init(jax.random.PRNGKey(0))
    tcfg = ts2t.S2TEmformerConfig(**S2T)
    jax_train, batches = {}, {}
    for world, n_stage, n_micro, n_data in TRAIN:
        batch = batches[(n_micro, n_data)] = _train_batch(
            tcfg, B=max(4, n_micro * n_data))
        jb = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64
                             else v) for k, v in batch.items()}
        mesh = (_mesh(world, ("pipe",)) if n_data == 1 else
                _mesh(world, ("pipe", "data"), (n_stage, n_data)))
        data_axis = "data" if n_data > 1 else None
        fn = (lambda p, mesh=mesh, data_axis=data_axis, n_micro=n_micro,
              jb=jb: j_pipelined_loss(p, jmodel.cfg, JLCfg(), jb, mesh,
                               data_axis=data_axis, n_micro=n_micro))
        if (n_stage, n_micro, n_data) == (2, 2, 2):
            (loss, met), g = jax.jit(jax.value_and_grad(fn, has_aux=True))(
                jsp)
            grads = load_jax_params(_as_np(g))
        else:
            loss, met = jax.jit(fn)(jsp)
            grads = None
        jax_train[(world, n_stage, n_micro, n_data)] = (
            float(loss), {k: float(v) for k, v in met.items()}, grads)
    return dict(ecfg=temf.EmformerConfig(**EMF),
                eparams=load_jax_params(_as_np(jp)), seq=(seq_x, seq_len,
                                                          seq_w),
                pipe=(pipe_x, pipe_len, pipe_w), jax_seq=jax_seq,
                jax_pipe=jax_pipe, s2t_cfg=tcfg,
                s2t_params=load_jax_params(_as_np(jsp)), batches=batches,
                jax_train=jax_train)


def _cases(setup, world):
    cases = []
    x, lens, w = setup["seq"]
    for wd, n_data in SEQ:
        if wd == world:
            cases.append((f"seq{n_data}", "seq_sharded", dict(
                ecfg=setup["ecfg"], params=setup["eparams"], x=x,
                lengths=lens, weight=w, n_data=n_data)))
    x, lens, w = setup["pipe"]
    for wd, n_data, n_micro in PIPE:
        if wd == world:
            cases.append((f"pipe{n_data}", "pipelined", dict(
                ecfg=setup["ecfg"], params=setup["eparams"], x=x,
                lengths=lens, weight=w, n_data=n_data, n_micro=n_micro)))
    for wd, n_stage, n_micro, n_data in TRAIN:
        if wd == world:
            cases.append((f"train{n_stage}{n_micro}{n_data}",
                          "pipeline_train", dict(
                              cfg=setup["s2t_cfg"],
                              params=setup["s2t_params"],
                              batch=setup["batches"][(n_micro, n_data)],
                              n_data=n_data,
                              n_micro=n_micro)))
    return cases


@pytest.fixture(scope="module")
def worlds(setup):
    return {w: comm.spawn(mc.run_cases, w, (_cases(setup, w),),
                              timeout=300)
            for w in (2, 4)}


def _hold(res, jax_out, jax_grads, got_out=None):
    out = res["out"] if got_out is None else got_out
    np.testing.assert_allclose(out, jax_out, **JAX_TOL)
    assert mc.rel_err(out, res["ref_out"]) <= 1e-4
    assert sorted(res["grads"]) == sorted(jax_grads)
    for name, g in jax_grads.items():
        if name == "x":     # a sum over every layer's paths: its largest
            assert mc.rel_err(res["grads"][name], g) <= 1e-4
        else:
            np.testing.assert_allclose(res["grads"][name], g, err_msg=name,
                                       **JAX_TOL)
    assert mc.grads_err(res["grads"], res["ref_grads"]) <= 1e-4


@pytest.mark.parametrize("world,n_data", SEQ)
def test_seq_sharded_forward_and_gradients(worlds, setup, world, n_data):
    """Segments over the seq ranks (with n_data 2, dp x sp): the output and
    the gradients of every parameter and of x equal JAX's
    emformer_forward_seq_sharded on its mesh (atol 2e-5, rtol 1e-4) and
    the port's one-process emformer_forward (1e-4 of the largest)."""
    res = worlds[world][0][f"seq{n_data}"]
    _hold(res, *setup["jax_seq"][(world, n_data)])


@pytest.mark.parametrize("world,n_data,n_micro", PIPE)
def test_pipelined_forward_and_gradients(worlds, setup, world, n_data,
                                         n_micro):
    """Layers in world / n_data stages, n_micro microbatches (with n_data 2,
    dp x pp), each rank holding only its stage's layers: output and
    gradients as JAX's emformer_forward_pipelined and the one process."""
    res = worlds[world][0][f"pipe{n_data}"]
    _hold(res, *setup["jax_pipe"][(world, n_data)])
    for r in worlds[world][1:]:
        np.testing.assert_array_equal(r[f"pipe{n_data}"]["out"], res["out"])


@pytest.mark.parametrize("world,n_stage,n_micro,n_data", TRAIN)
def test_pipelined_train_loss(worlds, setup, world, n_stage, n_micro,
                              n_data):
    """pipelined_train_loss (the frontend on stage 0, the decoder and the
    joint CTC loss on the last): the loss and metrics as JAX's (rtol 2e-5)
    and the dense loss's, every gradient within 1e-4 of the largest entry
    of the dense path's (and JAX's pipelined at (2, 2, 2): rtol 5e-4, atol
    2e-5), and one make_train_step update as the dense one's (the same
    loss and norm rtol 1e-5; parameters within twice the learning rate)."""
    res = worlds[world][0][f"train{n_stage}{n_micro}{n_data}"]
    jloss, jmet, jgrads = setup["jax_train"][(world, n_stage, n_micro,
                                              n_data)]
    np.testing.assert_allclose(res["loss"], jloss, rtol=2e-5)
    np.testing.assert_allclose(res["loss"], res["ref_loss"], rtol=2e-5)
    for k in ("nll_loss", "ctc_loss", "ntokens", "sample_size",
              "nsentences"):
        np.testing.assert_allclose(res["metrics"][k], jmet[k], rtol=2e-5,
                                   atol=1e-5, err_msg=k)
    assert mc.grads_err(res["grads"], res["ref_grads"]) <= 1e-4
    if jgrads is not None:
        for name, g in jgrads.items():
            np.testing.assert_allclose(res["grads"][name], g.numpy(),
                                       rtol=5e-4, atol=2e-5, err_msg=name)
    hist = [dict(res["update"])]
    ref = [dict(res["ref_update"])]
    mc.check_updates(dict(history=hist, ref_history=ref,
                          params=res["params"],
                          ref_params=res["ref_params"]),
                     [0.0], [], "pipelined update")


def test_pipelined_train_loss_requires_zero_infinity():
    """As JAX asserts: the loss refuses JointCTCConfig(zero_infinity=False)
    before any collective."""
    cfg = ts2t.S2TEmformerConfig(**S2T)
    model = ts2t.S2TEmformerModel(cfg, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in _train_batch(cfg).items()}
    with pytest.raises(ValueError, match="zero_infinity"):
        pipelined_train_loss(model, cfg, JointCTCConfig(zero_infinity=False),
                             batch, comm.make_mesh())
