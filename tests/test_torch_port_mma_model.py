"""The MMA model of simulst_tpu_torch vs the JAX package, on the CPU: the
loss of exp/2_mma.sh's criterion and every parameter gradient, for each of
the four monotonic attention variants with and without fixed
pre-decision, and once without mass preservation.

Small model: 2 + 2 layers, width 32, 2 heads, FFN 64, vocab 40, segment 4
/ left context 8 / right context 2 frames after subsampling, fixed
pre-decision ratio 2, MoChA chunk 3, the energy bias on; JAX init bridged
to the port (compat/jax_bridge.load_jax_params); two seeded utterances of
96 / 70 frames; fp32 with jax_default_matmul_precision float32
(tests/conftest.py); dropout 0 and no p_choose noise.  Tolerances: the
loss and its metrics rtol 1e-5; every parameter's gradient within 1e-4 of
its largest entry (a key bias, whose exact gradient is 0 or nearly so, of
its weight's).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each
import jax.numpy as jnp  # noqa: E402

from simulst_tpu.losses import mma_loss as jml  # noqa: E402
from simulst_tpu.models import mma as jmma  # noqa: E402
from simulst_tpu_torch.compat.jax_bridge import load_jax_params  # noqa: E402
from simulst_tpu_torch.losses import mma_loss as tml  # noqa: E402
from simulst_tpu_torch.models import mma as tmma  # noqa: E402

SMALL = dict(vocab_size=40, input_feat=8, conv_channels=16, embed_dim=32,
             ffn_dim=64, encoder_layers=2, encoder_heads=2, decoder_layers=2,
             decoder_heads=2, decoder_ffn_dim=64, segment_length=16,
             left_context=32, right_context=8, max_memory=2,
             max_target_positions=64, fixed_pre_decision_ratio=2,
             dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
# variant, "+no_mass_preservation" where mass preservation is off
VARIANTS = [f"{base}{pool}" for pool in ("", "_fixed_pre_decision")
            for base in ("hard_aligned", "infinite_lookback", "waitk",
                         "chunkwise")] + [
    "hard_aligned_fixed_pre_decision+no_mass_preservation"]


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _close_to_largest(got, want, rtol, scale=None, name=""):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    ref = np.abs(np.asarray(want if scale is None else scale)).max()
    assert err <= rtol * max(ref, 1e-30), (name, err, ref)


def _t(a):
    return torch.from_numpy(np.array(a))


def _batch():
    """Two utterances of 96 / 70 frames with 7 / 4 target tokens + EOS."""
    rng = np.random.RandomState(9)
    target = np.ones((2, 8), np.int32)
    prev = np.ones((2, 8), np.int32)
    for j, n in enumerate((7, 4)):
        toks = np.append(rng.randint(4, 40, n), 2)
        target[j, :n + 1] = toks
        prev[j, :n + 1] = np.append(2, toks[:-1])
    return {"feats": _rand(rng, 2, 96, 8),
            "feat_lengths": np.array([96, 70], np.int32),
            "target": target, "prev_tokens": prev}


def _cfg_kw(variant):
    variant, _, flag = variant.partition("+")
    return dict(SMALL, simul_attn_type=variant, energy_bias=True,
                mass_preservation=flag != "no_mass_preservation",
                mocha_chunk_size=3 if variant.startswith("chunkwise")
                else None)


LOSS_CFG = dict(latency_avg_weight=0.1, latency_var_weight=0.1)


@pytest.mark.parametrize("variant", VARIANTS)
def test_mma_loss_and_gradients_match_jax(variant):
    """mma_loss(model(...)) at dropout 0 without noise (DAL weight 0.1,
    variance weight 0.1): loss and metrics rtol 1e-5, every parameter's
    gradient within 1e-4 of its largest entry (a key bias of its
    weight's: the softmax, and nearly the soft attention, ignore it)."""
    jmodel = jmma.MMAModel(jmma.MMAConfig(**_cfg_kw(variant)))
    jp = jmodel.init(jax.random.PRNGKey(0))
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(params):
        logits, extra = jmodel.forward(params, jb["feats"],
                                       jb["feat_lengths"], jb["prev_tokens"])
        return jml.mma_loss(logits, extra, jb["target"], jb["feat_lengths"],
                            jml.MMALossConfig(**LOSS_CFG))

    (loss_j, metrics_j), grads_j = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jp)
    model = tmma.MMAModel(tmma.MMAConfig(**_cfg_kw(variant)), device="cpu")
    model.load_state_dict(load_jax_params(jax.tree_util.tree_map(np.asarray,
                                                                 jp)))
    tb = {k: _t(v) for k, v in batch.items()}
    logits, extra = model(tb["feats"], tb["feat_lengths"], tb["prev_tokens"])
    loss, metrics = tml.mma_loss(logits, extra, tb["target"],
                                 tb["feat_lengths"],
                                 tml.MMALossConfig(**LOSS_CFG))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    for key in ("nll_loss", "latency", "delays_var", "latency_loss",
                "sample_size"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(metrics_j[key]), rtol=1e-5,
                                   err_msg=key)
    ref = load_jax_params(jax.tree_util.tree_map(np.asarray, grads_j))
    assert sorted(n for n, _ in model.named_parameters()) == sorted(ref)
    for name, p in model.named_parameters():
        scale = ref[name[:-len("bias")] + "weight"] \
            if name.endswith(("k_proj.bias", "k_proj_soft.bias")) else None
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        _close_to_largest(got.numpy(), ref[name], 1e-4, scale=scale,
                          name=name)
