"""The six (task, model, loss) triples that the JAX package's cli/train
trains besides the s2t_emformer, transducer, convpos and MT ones: --task
asr --model cif --loss cif, --task asr --model mma --loss mma and --task
asr|st --model mma|cif --loss joint_ctc (the JAX build_loss pairs any
model with any loss).  On the CPU.

The two new loss pairings against the JAX package: MMA and CIF under the
joint-CTC criterion, 16 wide (2 heads of 8, FFN 32), 2 + 2 layers, vocab
40, the CTC head, dropout 0, no SpecAugment, JAX init bridged to the port
(compat/jax_bridge.load_jax_params), two seeded utterances of 128 / 90
frames; fp32 with jax_default_matmul_precision float32
(tests/conftest.py).  Tolerances: the loss and its CTC term rtol 1e-5;
every parameter's gradient within 1e-4 of its largest entry (a key bias,
whose exact gradient is 0 or nearly so, of its weight's); one Adam step
(lr 1e-3, warmup 10000, clip 10) its parameters atol 1e-5.  Then each of
the six triples through cli/train main: two updates on a MuST-C-shaped
manifest, 16 wide, finite losses, checkpoint_last written.
"""
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each
import jax.numpy as jnp  # noqa: E402

from simulst_tpu.losses import joint_ctc as jjc  # noqa: E402
from simulst_tpu.models import cif as jcif  # noqa: E402
from simulst_tpu.models import mma as jmma  # noqa: E402
from simulst_tpu.train.optim import OptimConfig as JOptim  # noqa: E402
from simulst_tpu.train.state import create_train_state as j_create  # noqa: E402
from simulst_tpu.train.state import make_train_step as j_make_step  # noqa: E402
from simulst_tpu_torch.cli import train as tcli  # noqa: E402
from simulst_tpu_torch.compat.jax_bridge import load_jax_params  # noqa: E402
from simulst_tpu_torch.data import synthetic as tsyn  # noqa: E402
from simulst_tpu_torch.models import cif as tcif  # noqa: E402
from simulst_tpu_torch.models import mma as tmma  # noqa: E402
from simulst_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from simulst_tpu_torch.train.optim import OptimConfig  # noqa: E402
from simulst_tpu_torch.train.state import (create_train_state,  # noqa: E402
                                           make_train_step)

SMALL = dict(vocab_size=40, input_feat=8, conv_channels=16, embed_dim=16,
             ffn_dim=32, encoder_layers=2, encoder_heads=2, decoder_layers=2,
             decoder_heads=2, decoder_ffn_dim=32, segment_length=16,
             left_context=32, right_context=8, max_memory=2,
             max_target_positions=64, ctc_layer=True)
NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
# exp/2_mma.sh's attention
MMA_KW = dict(simul_attn_type="infinite_lookback_fixed_pre_decision",
              fixed_pre_decision_ratio=2, mass_preservation=True)
MODELS = {"mma": (jmma.MMAModel, jmma.MMAConfig, tmma.MMAModel,
                  tmma.MMAConfig, MMA_KW),
          "cif": (jcif.CIFModel, jcif.CIFConfig, tcif.CIFModel,
                  tcif.CIFConfig, {})}
T = 128
OPTIM = dict(lr=1e-3, warmup_updates=10000, clip_norm=10.0)
# the six triples, each with the overrides its criterion reads
TRIPLES = {
    "asr-cif-cif": ["--task", "asr", "--model", "cif", "--loss", "cif"],
    "asr-mma-mma": ["--task", "asr", "--model", "mma", "--loss", "mma"],
    "asr-mma-joint_ctc": ["--task", "asr", "--model", "mma", "--loss",
                          "joint_ctc", "--override", "ctc_layer=true"],
    "st-mma-joint_ctc": ["--task", "st", "--model", "mma", "--loss",
                         "joint_ctc", "--override", "ctc_layer=true"],
    "asr-cif-joint_ctc": ["--task", "asr", "--model", "cif", "--loss",
                          "joint_ctc"],
    "st-cif-joint_ctc": ["--task", "st", "--model", "cif", "--loss",
                         "joint_ctc"]}


def _close_to_largest(got, want, rtol, scale=None, name=""):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    ref = np.abs(np.asarray(want if scale is None else scale)).max()
    assert err <= rtol * max(ref, 1e-30), (name, err, ref)


def _batch():
    """Two utterances of 128 / 90 frames with 7 / 4 target tokens + EOS."""
    rng = np.random.RandomState(9)
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


@pytest.fixture(scope="module", params=sorted(MODELS))
def joint_pair(request):
    """The JAX side of one model under joint CTC: the loss, its metrics,
    the gradients and one Adam step, from the JAX init."""
    jm_cls, jcfg_cls, _, _, kw = MODELS[request.param]
    jmodel = jm_cls(jcfg_cls(**SMALL, **NO_DROPOUT, **kw))
    jp = jmodel.init(jax.random.PRNGKey(0))
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        _jax_loss(jmodel), has_aux=True))(jp, jb, None)
    jstate, jmetrics = jax.jit(j_make_step(_jax_loss(jmodel),
                                           JOptim(**OPTIM)))(
        j_create(jp, JOptim(**OPTIM)), jb, jax.random.PRNGKey(0))
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731
    return dict(kind=request.param, params=as_np(jp), batch=batch,
                loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=as_np(grads), stepped=as_np(jstate.params),
                step_metrics={k: float(v) for k, v in jmetrics.items()})


def _port(pair):
    """(the port's model with the JAX init, cli/train's joint-CTC loss)."""
    _, _, tm_cls, tcfg_cls, kw = MODELS[pair["kind"]]
    model = tm_cls(tcfg_cls(**SMALL, **NO_DROPOUT, **kw), device="cpu")
    model.load_state_dict(load_jax_params(pair["params"]))
    args = tcli.parse_args(["--task", "st", "--model", pair["kind"],
                            "--loss", "joint_ctc", "--no-specaugment"])
    return model, tcli.build_loss(args, model)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grad_scale(grads, name):
    """A key bias's error is held against its weight's largest gradient:
    the softmax ignores it, so both sides hold rounding noise there."""
    if name.endswith(("k_proj.bias", "k_proj_soft.bias")):
        name = name[:-len("bias")] + "weight"
    return grads[name]


def test_joint_ctc_loss_and_gradients_match_jax(joint_pair):
    """MMA / CIF under cli/train's joint-CTC loss at dropout 0 without
    SpecAugment: the loss and its CTC term rtol 1e-5, every parameter's
    gradient within 1e-4 of its largest entry."""
    model, loss_fn = _port(joint_pair)
    loss, metrics = loss_fn(model, _torch_batch(joint_pair["batch"]), None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), joint_pair["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ctc_loss"]),
                               joint_pair["metrics"]["ctc_loss"], rtol=1e-5)
    ref = load_jax_params(joint_pair["grads"])
    assert sorted(n for n, _ in model.named_parameters()) == sorted(ref)
    for name, p in model.named_parameters():
        _close_to_largest(p.grad.numpy(), ref[name], 1e-4,
                          scale=_grad_scale(ref, name), name=name)


def test_train_step_matches_jax(joint_pair):
    """One Adam step (lr 1e-3, warmup 10000, clip 10) from the same
    parameters and batch: loss and gradient norm rtol 1e-5, every updated
    parameter atol 1e-5."""
    model, loss_fn = _port(joint_pair)
    state = create_train_state(model, OptimConfig(**OPTIM))
    state, metrics = make_train_step(loss_fn, OptimConfig(**OPTIM))(
        state, _torch_batch(joint_pair["batch"]))
    jm = joint_pair["step_metrics"]
    assert state.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), jm["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(metrics["gnorm"]), jm["gnorm"],
                               rtol=1e-5)
    for name, p in load_jax_params(joint_pair["stepped"]).items():
        np.testing.assert_allclose(model.state_dict()[name].numpy(),
                                   p.numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)


def _write_manifest(tmp_path):
    rows = tsyn.mustc_like_rows(12, seed=4, tmpdir=str(tmp_path), feat_dim=8)
    for r in rows:   # 1-2 s, so the CPU steps stay short
        r["n_frames"] = str(min(int(r["n_frames"]), 200))
    header = "id\taudio\tn_frames\tsrc_text\ttgt_text\tspeaker"
    for split, part in (("train", rows[:8]), ("dev", rows[8:])):
        (tmp_path / f"{split}_st.tsv").write_text("\n".join(
            [header] + ["\t".join(r[c] for c in header.split("\t"))
                        for r in part]) + "\n")
    (tmp_path / "spm_unigram.txt").write_text(
        "".join(f"▁{c * 3} 1\n" for c in "abcdefghij"))


@pytest.mark.parametrize("triple", sorted(TRIPLES))
def test_cli_trains_the_triple(tmp_path, triple):
    """cli/train main on the CPU: two updates of a 16-wide, 2 + 2-layer
    model on a MuST-C-shaped manifest (the asr task's targets are the
    transcripts), every logged loss finite, checkpoint_last written with
    the model's name."""
    _write_manifest(tmp_path)
    small = {k: v for k, v in SMALL.items()
             if k not in ("vocab_size", "ctc_layer")}
    if "mma" in triple:
        small.update(MMA_KW)
    save = tmp_path / "ckpt"
    state = tcli.main(TRIPLES[triple] + [
        "--data", str(tmp_path), "--device", "cpu", "--max-updates", "2",
        "--max-tokens", "800", "--save-dir", str(save),
        *[f"--override={k}={v}" for k, v in small.items()]])
    assert state.step == 2
    log = [json.loads(line) for line in
           (save / "train_log.jsonl").read_text().splitlines()]
    losses = [rec[k] for rec in log for k in ("loss", "valid_loss")
              if k in rec]
    assert losses and all(np.isfinite(v) for v in losses), log
    _, meta = tckpt.load_checkpoint(str(save / "checkpoint_last"))
    assert meta["model"] == triple.split("-")[1]
