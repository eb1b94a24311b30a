"""s2t_transformer_convpos and the fairseq loader of simulst_tpu_torch vs
the JAX package, on the CPU.

s2t_transformer_convpos at 2 + 2 layers, width 64, 2 heads, FFN 128,
vocab 40, the non-causal conv-pos at 16 taps (even: SamePad drops a
column) and 15 (odd) in 16 groups; JAX init bridged to the port
(compat/jax_bridge.load_jax_params); seeded numpy inputs; fp32 with
jax_default_matmul_precision float32 (tests/conftest.py).  The loss (the
joint-CTC criterion, CE alone: the model has no CTC head) rtol 1e-5, the
logits atol 1e-5, every parameter's gradient within 1e-4 of its largest
entry (a key bias, whose exact gradient is 0, of its weight's), the
greedy decode's tokens equal to a step-wise argmax over the JAX model's
teacher-forced logits along it.

The fairseq loader (compat/fairseq_converter) on state dicts fabricated
with numpy, as tests/test_converter.py fabricates them, for s2t_emformer,
MMA (with soft projections and energy bias, and without soft projections,
tied to the monotonic ones), CIF (legacy decoder.ctc_layer, the ConvTBC
alpha conv) and the transducer: bit for bit the JAX converter's tree
through jax_bridge.load_jax_params, every parameter the model has.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each
import jax.numpy as jnp  # noqa: E402

from simulst_tpu.compat import fairseq_converter as jfc  # noqa: E402
from simulst_tpu.losses import joint_ctc as jjc  # noqa: E402
from simulst_tpu.models import get_model  # noqa: E402
from simulst_tpu_torch.cli import train as tcli  # noqa: E402
from simulst_tpu_torch.cli.generate import decode_batch  # noqa: E402
from simulst_tpu_torch.compat import fairseq_converter as tfc  # noqa: E402
from simulst_tpu_torch.compat.jax_bridge import load_jax_params  # noqa: E402
from simulst_tpu_torch.decode.beam import BeamConfig  # noqa: E402

SMALL = dict(vocab_size=40, input_feat=8, conv_channels=16, embed_dim=64,
             ffn_dim=128, encoder_layers=2, encoder_heads=2, decoder_layers=2,
             decoder_heads=2, decoder_ffn_dim=128, max_target_positions=64,
             conv_pos_groups=16, dropout=0.0, attention_dropout=0.0,
             activation_dropout=0.0)
T = 64           # feature frames: 16 after subsampling
CONVPOS_ARGS = ["--task", "asr", "--model", "s2t_transformer_convpos",
                "--loss", "joint_ctc", "--no-specaugment"]


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _batch():
    """Two utterances of 64 / 41 frames with 7 / 4 target tokens + EOS."""
    rng = np.random.RandomState(9)
    target = np.ones((2, 8), np.int32)
    prev = np.ones((2, 8), np.int32)
    for j, n in enumerate((7, 4)):
        toks = np.append(rng.randint(4, 40, n), 2)
        target[j, :n + 1] = toks
        prev[j, :n + 1] = np.append(2, toks[:-1])
    return {"feats": _rand(rng, 2, T, 8),
            "feat_lengths": np.array([T, 41], np.int32),
            "target": target, "prev_tokens": prev}


def _port_model(jparams, conv_pos):
    args = tcli.parse_args(CONVPOS_ARGS + ["--override", f"conv_pos={conv_pos}"]
                           + [f"--override={k}={v}" for k, v in SMALL.items()
                              if k != "vocab_size"])
    model = tcli.build_model(args, SMALL["vocab_size"], device="cpu")
    model.load_state_dict(load_jax_params(jparams))
    return model, tcli.build_loss(args, model)


def _grad_scale(grads, name):
    if name.endswith("k_proj.bias"):
        name = name[:-len("bias")] + "weight"
    return grads[name]


@pytest.mark.parametrize("conv_pos", [16, 15])
def test_convpos_logits_loss_and_every_gradient_match_jax(conv_pos):
    cls = get_model("s2t_transformer_convpos")
    jmodel = cls(cls.Config(**SMALL, conv_pos=conv_pos))
    jp = jmodel.init(jax.random.PRNGKey(3))
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(params):
        logits, extra = jmodel.forward(params, jb["feats"],
                                       jb["feat_lengths"], jb["prev_tokens"])
        loss, metrics = jjc.joint_ctc_loss(logits, extra, jb["target"],
                                           jjc.JointCTCConfig())
        return loss, (logits, metrics)

    (jl, (jlogits, jm)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jp)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731
    model, loss_fn = _port_model(as_np(jp), conv_pos)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits, _ = model(tb["feats"], tb["feat_lengths"], tb["prev_tokens"])
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=0)
    loss, metrics = loss_fn(model, tb, None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    assert "ctc_loss" not in metrics and "ctc_loss" not in jm
    ref = load_jax_params(as_np(jgrads))
    assert sorted(n for n, _ in model.named_parameters()) == sorted(ref)
    for name, p in model.named_parameters():
        scale = float(np.abs(_grad_scale(ref, name).numpy()).max())
        err = float(np.abs(p.grad.numpy() - ref[name].numpy()).max())
        assert err <= 1e-4 * scale, (name, err, scale)

    # greedy decode (cli/generate): each token the argmax of JAX's
    # teacher-forced logits along the hypothesis, EOS blocked at the first
    # step (min_len 1); a top-two gap above 1e-4 at each step
    with torch.no_grad():
        tokens, lengths = decode_batch(model.eval(), tb,
                                       BeamConfig(beam_size=1, max_len=6))
    for j in range(2):
        hyp = tokens[j, :int(lengths[j])].tolist()
        lg, _ = jmodel.forward(jp, jb["feats"][j:j + 1],
                               jb["feat_lengths"][j:j + 1],
                               jnp.asarray([[2] + hyp[:-1]]))
        lg = np.asarray(lg)[0].copy()
        lg[0, 2] = -np.inf
        top2 = np.sort(lg, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0] > 1e-4).all(), j
        assert lg.argmax(-1).tolist() == hyp, j


# ---------------------------------------------------------------------------
# the fairseq loader
# ---------------------------------------------------------------------------

CONV_SMALL = dict(vocab_size=20, input_feat=8, conv_channels=16, embed_dim=16,
                  ffn_dim=32, encoder_layers=2, encoder_heads=2,
                  decoder_layers=2, decoder_heads=2, decoder_ffn_dim=32,
                  segment_length=16, left_context=32, right_context=8,
                  max_memory=2, ctc_layer=True)


def _fake_encoder(cfg, rng):
    d, sd = cfg.embed_dim, {}
    chans = [(cfg.input_feat, cfg.conv_channels),
             (cfg.conv_channels // 2, d * 2)]
    for i, (cin, cout) in enumerate(chans):
        k = cfg.conv_kernel_sizes[i]
        sd[f"encoder.subsample.conv_layers.{i}.weight"] = _rand(rng, cout,
                                                                cin, k)
        sd[f"encoder.subsample.conv_layers.{i}.bias"] = _rand(rng, cout)
    k = (cfg.conv_pos + 1) // 2
    sd["encoder.embed_positions.conv.weight_g"] = _rand(rng, 1, 1, k)
    sd["encoder.embed_positions.conv.weight_v"] = _rand(
        rng, d, d // cfg.conv_pos_groups, k)
    sd["encoder.embed_positions.conv.bias"] = _rand(rng, d)
    for i in range(cfg.encoder_layers):
        p = f"encoder.emformer_blocks.emformer_layers.{i}"
        for name, shape in (("attention.emb_to_key_value", (2 * d, d)),
                            ("attention.emb_to_query", (d, d)),
                            ("attention.out_proj", (d, d)),
                            ("pos_ff.1", (cfg.ffn_dim, d)),
                            ("pos_ff.4", (d, cfg.ffn_dim))):
            sd[f"{p}.{name}.weight"] = _rand(rng, *shape)
            sd[f"{p}.{name}.bias"] = _rand(rng, shape[0])
        for name in ("pos_ff.0", "layer_norm_input"):
            sd[f"{p}.{name}.weight"] = _rand(rng, d)
            sd[f"{p}.{name}.bias"] = _rand(rng, d)
    sd["encoder.emformer_blocks.final_layer_norm.weight"] = _rand(rng, d)
    sd["encoder.emformer_blocks.final_layer_norm.bias"] = _rand(rng, d)
    sd["encoder.ctc_layer.weight"] = _rand(rng, cfg.vocab_size, d)
    return sd


def _fake_decoder(cfg, rng, cross):
    d, sd = cfg.embed_dim, {}
    sd["decoder.embed_tokens.weight"] = _rand(rng, cfg.vocab_size, d)
    projs = {"standard": ("q_proj", "k_proj", "v_proj", "out_proj"),
             "mma": ("q_proj", "k_proj", "v_proj", "out_proj", "q_proj_soft",
                     "k_proj_soft"),
             "fake": ("q_proj", "k_proj", "out_proj"), "none": ()}[cross]
    for i in range(cfg.decoder_layers):
        p = f"decoder.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{p}.self_attn.{proj}.weight"] = _rand(rng, d, d)
            sd[f"{p}.self_attn.{proj}.bias"] = _rand(rng, d)
        for proj in projs:
            sd[f"{p}.encoder_attn.{proj}.weight"] = _rand(rng, d, d)
            if not (cross == "fake" and proj == "q_proj"):
                sd[f"{p}.encoder_attn.{proj}.bias"] = _rand(rng, d)
        if cross == "mma":
            sd[f"{p}.encoder_attn.energy_bias"] = _rand(rng, 1)
        names = ["self_attn_layer_norm", "final_layer_norm"]
        if cross != "none":
            names.append("encoder_attn_layer_norm")
        for name in names:
            sd[f"{p}.{name}.weight"] = _rand(rng, d)
            sd[f"{p}.{name}.bias"] = _rand(rng, d)
        sd[f"{p}.fc1.weight"] = _rand(rng, cfg.decoder_ffn_dim, d)
        sd[f"{p}.fc1.bias"] = _rand(rng, cfg.decoder_ffn_dim)
        sd[f"{p}.fc2.weight"] = _rand(rng, d, cfg.decoder_ffn_dim)
        sd[f"{p}.fc2.bias"] = _rand(rng, d)
    sd["decoder.layer_norm.weight"] = _rand(rng, d)
    sd["decoder.layer_norm.bias"] = _rand(rng, d)
    return sd


def _fake_state_dict(name, cfg, rng, drop_soft=False):
    cross = {"s2t_emformer": "standard", "mma": "mma", "cif": "fake",
             "transducer": "none"}[name]
    sd = {**_fake_encoder(cfg, rng), **_fake_decoder(cfg, rng, cross)}
    d = cfg.embed_dim
    if name == "cif":       # legacy CTC key and the alpha_proj
        sd["decoder.ctc_layer.weight"] = sd.pop("encoder.ctc_layer.weight")
        a = "encoder.cif_layer.alpha_proj"
        sd[f"{a}.0.weight"] = _rand(rng, cfg.cif_conv_kernel, d, d)
        sd[f"{a}.0.bias"] = _rand(rng, d)
        sd[f"{a}.1.weight"] = _rand(rng, d)
        sd[f"{a}.1.bias"] = _rand(rng, d)
        sd[f"{a}.4.weight"] = _rand(rng, 1, d)
        sd[f"{a}.4.bias"] = _rand(rng, 1)
    if name == "transducer":
        j = "decoder.joiner"
        sd[f"{j}.source_projection.weight"] = _rand(rng, d, d)
        sd[f"{j}.source_projection.bias"] = _rand(rng, d)
        sd[f"{j}.target_projection.weight"] = _rand(rng, d, d)
    if drop_soft:
        sd = {k: v for k, v in sd.items() if "_soft" not in k}
    return sd


FAIRSEQ_CASES = {
    "s2t_emformer": ("s2t_emformer", {}, False),
    "mma": ("mma", dict(simul_attn_type="infinite_lookback_fixed_pre_decision",
                        energy_bias=True), False),
    "mma-tied": ("mma", dict(simul_attn_type="infinite_lookback"), True),
    "cif": ("cif", {}, False),
    "transducer": ("transducer", dict(ctc_layer=False), False),
}


@pytest.mark.parametrize("case", sorted(FAIRSEQ_CASES))
def test_fairseq_loader_equals_jax_converter_and_bridge(case, tmp_path):
    name, extra, drop_soft = FAIRSEQ_CASES[case]
    jcls = get_model(name)
    jcfg = jcls.Config(**{**CONV_SMALL, **extra})
    jp = jcls(jcfg).init(jax.random.PRNGKey(0))
    sd = _fake_state_dict(name, jcfg, np.random.RandomState(len(case)),
                          drop_soft)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731
    init = load_jax_params(as_np(jp))
    want = load_jax_params(as_np(jfc.CONVERTERS[name](jp, dict(sd))))

    args = tcli.parse_args(["--task", "st", "--model", name, "--loss",
                            {"s2t_emformer": "joint_ctc", "mma": "mma",
                             "cif": "cif", "transducer": "rnnt"}[name]]
                           + [f"--override={k}={v}" for k, v in
                              {**CONV_SMALL, **extra}.items()
                              if k != "vocab_size"])
    model = tcli.build_model(args, CONV_SMALL["vocab_size"], device="cpu")
    model.load_state_dict(init)
    path = tmp_path / "checkpoint.pt"
    torch.save({"cfg": None, "model": {k: torch.from_numpy(v)
                                       for k, v in sd.items()}}, str(path))
    tfc.convert(name, model, str(path))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    changed = 0
    for key in want:
        assert torch.equal(got[key], want[key]), key
        changed += not torch.equal(init[key], want[key])
    assert changed >= len(want) - 1, (changed, len(want))
    if drop_soft:
        w = got["decoder.layers.0.encoder_attn.q_proj_soft.weight"]
        assert torch.equal(w, got["decoder.layers.0.encoder_attn.q_proj.weight"])
