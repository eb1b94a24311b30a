"""The MT-teacher training slice of simulst_tpu_torch (mt_transformer,
label-smoothed CE, Adam with inverse-sqrt warmup and the global-norm clip)
vs the JAX package, on the CPU.

Small config: 2 + 2 layers, width 32, 2 heads, FFN 64, vocab 40; JAX init
bridged to the port; seeded numpy token batches; fp32 with
jax_default_matmul_precision float32 (tests/conftest.py); no dropout, so
both sides compute the same function.  The shared embedding is two
leaves in the JAX tree (encoder.embed_tokens and decoder.embed_tokens, one
array at init) with a gradient each, and two parameters in the port, so
the trees compare leaf by leaf.  Tolerances: loss rtol
1e-5; gradients atol 1e-5; parameters after one Adam update atol 2e-5 (the
update is about lr = 1e-3 per element, the gradient error is amplified
only where |g| is near Adam's eps).
"""
import dataclasses
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each
import jax.numpy as jnp  # noqa: E402

from simulst_tpu.losses.label_smoothed_ce import ce_loss as j_ce_loss  # noqa: E402
from simulst_tpu.models.mt_transformer import MTConfig as JConfig  # noqa: E402
from simulst_tpu.models.mt_transformer import \
    MTTransformerModel as JModel  # noqa: E402
from simulst_tpu.train.optim import OptimConfig as JOptim  # noqa: E402
from simulst_tpu.train.state import create_train_state as j_create  # noqa: E402
from simulst_tpu.train.state import make_train_step as j_make_step  # noqa: E402
from simulst_tpu_torch.cli import train as tcli  # noqa: E402
from simulst_tpu_torch.compat.jax_bridge import (flatten_tree,  # noqa: E402
                                                 load_jax_params)
from simulst_tpu_torch.models.mt_transformer import MTConfig, MTTransformerModel  # noqa: E402
from simulst_tpu_torch.nn.core import RngStream  # noqa: E402
from simulst_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from simulst_tpu_torch.train.optim import OptimConfig  # noqa: E402
from simulst_tpu_torch.train.state import (create_train_state,  # noqa: E402
                                           make_train_step)

SMALL = dict(vocab_size=40, embed_dim=32, ffn_dim=64, encoder_layers=2,
             decoder_layers=2, num_heads=2)
NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
OPTIM = dict(lr=1e-3, warmup_updates=1, clip_norm=0.05)
EMB, DEC_EMB = "encoder.embed_tokens.weight", "decoder.embed_tokens.weight"


def _batch(seed, b=3, s=9, t=7):
    """Right-padded pairs with EOS, prev_tokens with EOS moved to front."""
    rng = np.random.RandomState(seed)
    src = np.ones((b, s), np.int64)
    tgt = np.ones((b, t), np.int64)
    prev = np.ones((b, t), np.int64)
    for j in range(b):
        ls, lt = rng.randint(3, s + 1), rng.randint(2, t + 1)
        src[j, :ls] = np.append(rng.randint(4, 40, ls - 1), 2)
        tgt[j, :lt] = np.append(rng.randint(4, 40, lt - 1), 2)
        prev[j, :lt] = np.append(2, tgt[j, :lt - 1])
    return {"src_tokens": src, "target": tgt, "prev_tokens": prev}


def _jax_loss(jmodel):
    """The JAX CLI's CE loss (simulst_tpu/cli/train.py build_loss), without
    dropout."""
    def fn(params, batch, rng):
        logits, _ = jmodel.forward(params, batch["src_tokens"],
                                   batch["prev_tokens"])
        loss, nll = j_ce_loss(logits, batch["target"], 0.1, 1)
        ntokens = (batch["target"] != 1).sum()
        return loss, {"loss": loss, "nll_loss": nll, "ntokens": ntokens,
                      "nsentences": batch["target"].shape[0],
                      "sample_size": ntokens}
    return fn


@pytest.fixture(scope="module")
def pair():
    jmodel = JModel(JConfig(**SMALL, **NO_DROPOUT))
    return jmodel, jmodel.init(jax.random.PRNGKey(0))


def _port_model(jp):
    model = MTTransformerModel(MTConfig(**SMALL), device="cpu")
    model.load_state_dict(load_jax_params(jax.tree_util.tree_map(np.asarray,
                                                                 jp)))
    return model


def _port_loss():
    args = tcli.parse_args(["--task", "mt", "--model", "mt_transformer",
                            "--loss", "ce"])
    return tcli.build_loss(args, None)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_params_match(model, jtree, atol):
    ref = flatten_tree(jax.tree_util.tree_map(np.asarray, jtree))
    assert sorted(model.state_dict()) == sorted(ref)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref[name], atol=atol, rtol=0,
                                   err_msg=name)


def test_loss_and_gradients_match_jax(pair):
    jmodel, jp = pair
    batch = _batch(0)
    loss_j, grads_j = jax.value_and_grad(
        lambda p: _jax_loss(jmodel)(
            p, {k: jnp.asarray(v) for k, v in batch.items()}, None)[0])(jp)
    model = _port_model(jp)
    loss_t, metrics = _port_loss()(model, _torch_batch(batch), None)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    assert int(metrics["sample_size"]) == int((batch["target"] != 1).sum())
    ref = flatten_tree(jax.tree_util.tree_map(np.asarray, grads_j))
    assert sorted(n for n, _ in model.named_parameters()) == sorted(ref)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name], atol=1e-5,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("update_freq,freeze", [(1, None), (2, None),
                                                (1, {"encoder": 1})])
def test_train_step_matches_jax(pair, update_freq, freeze):
    jmodel, jp = pair
    batches = [_batch(10 + i) for i in range(update_freq)]
    batch = (batches[0] if update_freq == 1 else
             {k: np.stack([b[k] for b in batches]) for k in batches[0]})
    jstep = j_make_step(_jax_loss(jmodel), JOptim(**OPTIM), update_freq,
                        freeze)
    jstate, jmetrics = jstep(j_create(jp, JOptim(**OPTIM)),
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             jax.random.PRNGKey(0))   # unused: no dropout
    model = _port_model(jp)
    state = create_train_state(model, OptimConfig(**OPTIM))
    step = make_train_step(_port_loss(), OptimConfig(**OPTIM), update_freq,
                           freeze)
    state, metrics = step(state, _torch_batch(batch))
    assert state.step == int(jstate.step) == 1
    np.testing.assert_allclose(float(metrics["gnorm"]),
                               float(jmetrics["gnorm"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=1e-5)
    _assert_params_match(model, jstate.params, atol=2e-5)
    # the two embedding leaves start equal and part after one update, on
    # both sides; the bridge loads the parted pair as it is
    stepped = jax.tree_util.tree_map(np.asarray, jstate.params)
    emb_j = (stepped["encoder"]["embed_tokens"]["weight"],
             stepped["decoder"]["embed_tokens"]["weight"])
    assert not np.array_equal(*emb_j)
    assert not torch.equal(model.encoder.embed_tokens.weight,
                           model.decoder.embed_tokens.weight)
    reloaded = load_jax_params(stepped)
    for name, want in zip((EMB, DEC_EMB), emb_j):
        np.testing.assert_array_equal(reloaded[name].numpy(), want)
    if freeze:
        torch.testing.assert_close(model.encoder.layers[0].fc1.weight,
                                   _port_model(jp).encoder.layers[0].fc1.weight)


def test_non_finite_gradient_skips_the_update(pair):
    _, jp = pair
    model = _port_model(jp)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = create_train_state(model, OptimConfig(**OPTIM))
    good = _port_loss()

    def nan_loss(m, batch, rngs):
        loss, metrics = good(m, batch, rngs)
        return loss * float("nan"), metrics

    state, metrics = make_train_step(nan_loss, OptimConfig(**OPTIM))(
        state, _torch_batch(_batch(1)))
    assert state.step == 0 and state.opt.count == 0
    assert float(metrics["skipped"]) == 1.0
    assert not np.isfinite(float(metrics["gnorm"]))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], atol=0, rtol=0)
    assert all(float(m.abs().max()) == 0 for m in state.opt.mu + state.opt.nu)
    assert all(p.grad is None for p in model.parameters())


def test_dropout_training_step_is_seeded(pair):
    """With a generator the step drops (the loss differs from the
    no-dropout loss) and two runs from one seed agree exactly."""
    _, jp = pair
    losses = []
    for gen in (torch.Generator().manual_seed(5),
                torch.Generator().manual_seed(5), None):
        model = _port_model(jp)
        model.cfg = dataclasses.replace(model.cfg, dropout=0.3)
        loss, _ = _port_loss()(model, _torch_batch(_batch(2)),
                               None if gen is None else RngStream(gen))
        losses.append(loss.item())
    assert losses[0] == losses[1] != losses[2]


def test_checkpoint_roundtrip_and_average(pair, tmp_path):
    _, jp = pair
    model = _port_model(jp)
    sd = model.state_dict()
    tckpt.save_checkpoint(str(tmp_path / "checkpoint.best_loss_2.5000"), sd,
                          {"model": "mt_transformer"})
    doubled = {k: v * 2 for k, v in sd.items()}
    tckpt.save_checkpoint(str(tmp_path / "checkpoint.best_loss_1.2500"),
                          doubled)
    best = tckpt.find_best_checkpoints(str(tmp_path), n=2)
    assert [os.path.basename(p) for p in best] == [
        "checkpoint.best_loss_1.2500", "checkpoint.best_loss_2.5000"]
    loaded, meta = tckpt.load_checkpoint(best[1])
    assert meta == {"model": "mt_transformer"}
    fresh = MTTransformerModel(MTConfig(**SMALL), device="cpu")
    assert fresh.decoder.embed_tokens is not fresh.encoder.embed_tokens
    assert torch.equal(fresh.decoder.embed_tokens.weight,
                       fresh.encoder.embed_tokens.weight)   # shared at init
    fresh.load_state_dict(loaded)
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, sd[k], atol=0, rtol=0)
    avg = tckpt.average_params([tckpt.load_checkpoint(p)[0] for p in best])
    for k, v in avg.items():
        torch.testing.assert_close(v, sd[k] * 1.5)
    enc_only = tckpt.load_pretrained_component(
        sd, {k[len("encoder."):]: v for k, v in doubled.items()
             if k.startswith("encoder.")}, "encoder")
    assert torch.equal(enc_only["encoder.layer_norm.scale"],
                       doubled["encoder.layer_norm.scale"])
    assert torch.equal(enc_only["decoder.layer_norm.scale"],
                       sd["decoder.layer_norm.scale"])


def test_cli_trains_and_validates_on_the_cpu(tmp_path):
    """cli/train main end to end on a tiny synthetic manifest: two updates,
    a validation, checkpoint_last that loads back."""
    words = [f"w{i}" for i in range(30)]
    (tmp_path / "spm_unigram.txt").write_text(
        "".join(f"▁{w} 1\n" for w in words))
    rng = np.random.RandomState(0)
    for split, n in (("train", 24), ("dev", 8)):
        rows = ["id\tsrc_text\ttgt_text"] + [
            f"{split}{i}\t{' '.join(rng.choice(words, rng.randint(2, 9)))}\t"
            f"{' '.join(rng.choice(words, rng.randint(2, 9)))}"
            for i in range(n)]
        (tmp_path / f"{split}_st.tsv").write_text("\n".join(rows) + "\n")
    save = tmp_path / "ckpt"
    small = [f"--override={k}={v}" for k, v in SMALL.items()
             if k != "vocab_size"]
    state = tcli.main([
        "--data", str(tmp_path), "--task", "mt", "--model", "mt_transformer",
        "--loss", "ce", "--device", "cpu", "--max-updates", "2",
        "--max-tokens", "64", "--save-dir", str(save),
        "--update-freq", "2", *small])
    assert state.step == 2
    log = (save / "train_log.jsonl").read_text().splitlines()
    assert any('"valid_update": 2' in line for line in log)
    params, meta = tckpt.load_checkpoint(str(save / "checkpoint_last"))
    assert meta["step"] == 2 and meta["config"]["embed_dim"] == 32
    assert any(p.name.startswith("checkpoint.best_loss_")
               for p in save.iterdir())


@pytest.mark.parametrize("flags", [["--task", "st"], ["--model", "mma"],
                                   ["--loss", "joint_ctc"]])
def test_cli_rejects_unported_paths(flags):
    argv = ["--task", "mt", "--model", "mt_transformer", "--loss", "ce"]
    argv[argv.index(flags[0]) + 1] = flags[1]
    with pytest.raises(NotImplementedError,
                       match="not trained by the JAX package either"):
        tcli.parse_args(argv)
