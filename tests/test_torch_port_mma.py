"""The MMA training slice of simulst_tpu_torch vs the JAX package, on the
CPU: the expected-alignment recursion (the plain versions of the CUDA
kernels and the autograd Function), every function of ops/monotonic, the
latency metrics and the loss's latency gate, the component load and the
training CLI with a pretrained encoder.  The model's loss and gradients
per variant are in tests/test_torch_port_mma_model.py, the decoder step
and the streaming step in tests/test_torch_port_mma_stream.py.

Small model (CLI): 2 + 2 layers, width 32, 2 heads, FFN 64, segment 4 /
left context 8 / right context 2 frames after subsampling, fixed
pre-decision ratio 2.  Seeded numpy inputs; fp32 with
jax_default_matmul_precision float32 (tests/conftest.py).  Where the JAX
function reaches a Pallas kernel it runs in interpret mode, as the JAX
package's own tests run it.  Tolerances, each stated again at its test:
the recursion's alphas rtol 1e-5 (atol 1e-7 for entries that round to 0)
and its gradients within 1e-5 of each one's largest entry (d_denom spans
many orders of magnitude: denom is clamped at 1e-6); the monotonic
functions and the latency metrics rtol 1e-5, their gradients within 1e-5
of the largest entry.  XLA's CPU backend flushes denormal floats to zero,
and the recursion's prefix p * cumprod(1 - p) passes through the denormal
range where the cumprod underflows (S 256), so torch flushes them too
while this module runs.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each
import jax.numpy as jnp  # noqa: E402

from simulst_tpu.losses import latency as jlat  # noqa: E402
from simulst_tpu.losses import mma_loss as jml  # noqa: E402
from simulst_tpu.ops import monotonic as jmono  # noqa: E402
from simulst_tpu.ops import monotonic_pallas as jmp  # noqa: E402
from simulst_tpu_torch.cli import average_checkpoints as tavg  # noqa: E402
from simulst_tpu_torch.cli import train as tcli  # noqa: E402
from simulst_tpu_torch.data import synthetic as tsyn  # noqa: E402
from simulst_tpu_torch.losses import latency as tlat  # noqa: E402
from simulst_tpu_torch.losses import mma_loss as tml  # noqa: E402
from simulst_tpu_torch.models import mma as tmma  # noqa: E402
from simulst_tpu_torch.models import s2t_emformer as ts2t  # noqa: E402
from simulst_tpu_torch.ops import monotonic as tmono  # noqa: E402
from simulst_tpu_torch.ops import monotonic_align as talign  # noqa: E402
from simulst_tpu_torch.train import checkpoint as tckpt  # noqa: E402

SMALL = dict(vocab_size=40, input_feat=8, conv_channels=16, embed_dim=32,
             ffn_dim=64, encoder_layers=2, encoder_heads=2, decoder_layers=2,
             decoder_heads=2, decoder_ffn_dim=64, segment_length=16,
             left_context=32, right_context=8, max_memory=2,
             max_target_positions=64, fixed_pre_decision_ratio=2)
NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
MMA_ARGS = ["--task", "st", "--model", "mma", "--loss", "mma"]


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _close_to_largest(got, want, rtol, scale=None, name=""):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    ref = np.abs(np.asarray(want if scale is None else scale)).max()
    assert err <= rtol * max(ref, 1e-30), (name, err, ref)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True, scope="module")
def _flush_denormals_as_xla_does():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


# ---------------------------------------------------------------------------
# the recursion
# ---------------------------------------------------------------------------

def _panels(n, u, s, seed=0, waitk=False):
    """prefix, denom as expected_alignment_from_p_choose makes them from p
    in [0.05, 0.95] (or wait-k's one-hot rows), and an upstream gradient."""
    rng = np.random.RandomState(seed)
    if waitk:
        p = np.asarray(jmono.waitk_p_choose(u, s, n, 3))
    else:
        p = rng.uniform(0.05, 0.95, (n, u, s)).astype(np.float32)
    cp = np.asarray(jmono.exclusive_cumprod(jnp.asarray(1 - p), axis=2))
    return ((p * cp).astype(np.float32),
            np.clip(cp, 1e-6, 1.0).astype(np.float32), _rand(rng, n, u, s))


def _check_alignment(prefix, denom, g, fwd, bwd):
    """The plain versions vs the JAX functions fwd / bwd: alphas rtol 1e-5
    (atol 1e-7), d_prefix and d_denom within 1e-5 of their largest entry;
    both backwards take the JAX alphas."""
    want = np.asarray(fwd(jnp.asarray(prefix), jnp.asarray(denom)))
    got = talign.alignment_fwd_plain(_t(prefix), _t(denom)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    j_grads = bwd(*map(jnp.asarray, (prefix, denom, want, g)))
    t_grads = talign.alignment_bwd_plain(_t(prefix), _t(denom), _t(want),
                                         _t(g))
    for name, tg, jg in zip(("d_prefix", "d_denom"), t_grads, j_grads):
        _close_to_largest(tg.numpy(), jg, 1e-5, name=name)


@pytest.mark.parametrize("n,u,s,waitk", [
    (4, 6, 32, False), (3, 5, 29, False), (2, 4, 256, False),
    (3, 1, 29, False), (3, 1, 32, False), (4, 6, 32, True),
    (3, 4, 1, False), (3, 4, 33, False), (2, 3, 257, False)],
    ids=["S32", "S29", "S256", "U1-S29", "U1-S32", "waitk-S32", "S1", "S33",
         "S257"])
def test_alignment_plain_matches_jax_scan(n, u, s, waitk):
    """alignment_{fwd,bwd}_plain vs alignment_{fwd,bwd}_scan (bit-exact to
    the TPU kernel): alphas rtol 1e-5, gradients 1e-5 of the largest.  S 1,
    33 and 257 are the edges of the CUDA kernels' 32-position groups and
    256-position tiles, where the card holds them to these plain
    versions."""
    _check_alignment(*_panels(n, u, s, seed=s + u, waitk=waitk),
                     jmp.alignment_fwd_scan, jmp.alignment_bwd_scan)


@pytest.mark.parametrize("n,u", [(4, 6), (2, 1)])
def test_alignment_plain_matches_pallas_interpret(n, u):
    """vs alignment_{fwd,bwd}_pallas in interpret mode at S 128, as
    tests/test_monotonic_pallas.py runs them; same tolerances."""
    _check_alignment(
        *_panels(n, u, 128, seed=u),
        lambda p, d: jmp.alignment_fwd_pallas(p, d, interpret=True),
        lambda p, d, a, g: jmp.alignment_bwd_pallas(p, d, a, g,
                                                    interpret=True))


def test_alignment_recursion_gradients_match_jax():
    """The autograd Function's gradients vs jax.grad through
    _alignment_recursion's custom VJP: within 1e-5 of the largest entry."""
    prefix, denom, g = _panels(3, 5, 29, seed=11)
    grads_j = jax.grad(lambda p, d: (jmono._alignment_recursion(p, d)
                                     * jnp.asarray(g)).sum(), argnums=(0, 1))(
        jnp.asarray(prefix), jnp.asarray(denom))
    pt, dt = _t(prefix).requires_grad_(), _t(denom).requires_grad_()
    (tmono._alignment_recursion(pt, dt) * _t(g)).sum().backward()
    _close_to_largest(pt.grad.numpy(), grads_j[0], 1e-5, name="d_prefix")
    _close_to_largest(dt.grad.numpy(), grads_j[1], 1e-5, name="d_denom")


# ---------------------------------------------------------------------------
# ops/monotonic
# ---------------------------------------------------------------------------

def _vjp_check(jfn, tfn, arrays, rtol=1e-5):
    """Values rtol 1e-5 (atol 1e-7); the vjp of a seeded cotangent within
    1e-5 of each gradient's largest entry."""
    ref, vjp = jax.vjp(jfn, *map(jnp.asarray, arrays))
    ts = [_t(a).requires_grad_() for a in arrays]
    out = tfn(*ts)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=rtol, atol=1e-7)
    dy = _rand(np.random.RandomState(1), *out.shape)
    out.backward(_t(dy))
    for i, (t, want) in enumerate(zip(ts, vjp(jnp.asarray(dy)))):
        got = t.grad if t.grad is not None else torch.zeros_like(t)
        _close_to_largest(got.numpy(), want, 1e-5, name=str(i))


def _kpm(b, s, lengths):
    return np.arange(s)[None, :] >= np.asarray(lengths)[:, None]


def test_exclusive_cumprod_and_moving_sum_match_jax():
    rng = np.random.RandomState(2)
    x = rng.uniform(0.05, 0.95, (3, 4, 11)).astype(np.float32)
    for dim in (1, 2):
        _vjp_check(lambda a: jmono.exclusive_cumprod(a, dim, 1e-6),
                   lambda a: tmono.exclusive_cumprod(a, dim, 1e-6), [x])
    for start, end in ((1, 3), (3, 1), (2, 2)):
        _vjp_check(lambda a: jmono.moving_sum(a, start, end),
                   lambda a: tmono.moving_sum(a, start, end), [x])


@pytest.mark.parametrize("masked", [False, True])
def test_expected_alignment_from_p_choose_matches_jax(masked):
    """Value and gradient in p_choose (through the recursion's backward),
    with and without a key padding mask."""
    rng = np.random.RandomState(3)
    p = rng.uniform(0.05, 0.95, (4, 5, 23)).astype(np.float32)
    kpm = _kpm(4, 23, [23, 17, 9, 23]) if masked else None
    _vjp_check(
        lambda a: jmono.expected_alignment_from_p_choose(
            a, None if kpm is None else jnp.asarray(kpm)),
        lambda a: tmono.expected_alignment_from_p_choose(
            a, None if kpm is None else _t(kpm)), [p])


@pytest.mark.parametrize("masked", [False, True])
def test_mass_preservation_matches_jax(masked):
    """Gradients too: on wait-k's one-hot rows the clip of the row sum sits
    exactly at 1, where both sides split the gradient in halves."""
    rng = np.random.RandomState(4)
    alpha = rng.uniform(0.0, 0.2, (4, 3, 13)).astype(np.float32)
    alpha[1] = np.asarray(jmono.waitk_p_choose(3, 13, 1, 2))[0]
    kpm = _kpm(4, 13, [13, 13, 6, 10]) if masked else None
    _vjp_check(
        lambda a: jmono.mass_preservation(
            a, None if kpm is None else jnp.asarray(kpm)),
        lambda a: tmono.mass_preservation(
            a, None if kpm is None else _t(kpm)), [alpha])


@pytest.mark.parametrize("chunk_size", [None, 3])
def test_expected_soft_attention_matches_jax(chunk_size):
    """MILk (chunk None) and MoChA (chunk 3) beta, gradients in alpha and
    the soft energy, with padding and with beta clipped at 1."""
    rng = np.random.RandomState(5)
    alpha = rng.uniform(0.0, 0.5, (4, 3, 13)).astype(np.float32)
    alpha[0, 0] = 0.0
    alpha[0, 0, 0] = 5.0                  # beta above 1: clipped
    energy = _rand(rng, 4, 3, 13)
    kpm = _kpm(4, 13, [13, 8, 13, 3])
    _vjp_check(
        lambda a, e: jmono.expected_soft_attention(
            a, e, jnp.asarray(kpm), chunk_size=chunk_size, eps=1e-6),
        lambda a, e: tmono.expected_soft_attention(
            a, e, _t(kpm), chunk_size=chunk_size, eps=1e-6), [alpha, energy])


@pytest.mark.parametrize("online", [False, True])
def test_waitk_p_choose_matches_jax(online):
    kpm = _kpm(3, 9, [9, 4, 6])
    for mask in (None, kpm):
        want = jmono.waitk_p_choose(7, 9, 3, 3, None if mask is None
                                    else jnp.asarray(mask), online=online)
        got = tmono.waitk_p_choose(7, 9, 3, 3, None if mask is None
                                   else _t(mask), online=online)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_learnable_p_choose_noise_comes_from_the_generator():
    """Without a generator it is JAX's rng=None sigmoid (rtol 1e-6); with
    one, the noise is N(mean, std) (moments within 2%) and the same seed
    draws the same noise."""
    energy = _rand(np.random.RandomState(6), 64, 256)
    np.testing.assert_allclose(
        tmono.learnable_p_choose(_t(energy)).numpy(),
        np.asarray(jmono.learnable_p_choose(jnp.asarray(energy))), rtol=1e-6)
    zeros = torch.zeros(200, 500)
    draws = [tmono.learnable_p_choose(zeros, 0.5, 1.5,
                                      torch.Generator().manual_seed(7))
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    noise = torch.logit(draws[0].double())
    assert abs(noise.mean().item() - 0.5) < 0.02
    assert abs(noise.std().item() - 1.5) < 0.03


# ---------------------------------------------------------------------------
# latency
# ---------------------------------------------------------------------------

def _delays():
    """Expected (continuous) delays with padding, and wait-k's integer
    delays, which tie in DAL's running max."""
    rng = np.random.RandomState(8)
    cont = np.cumsum(rng.uniform(0.0, 4.0, (4, 7)), axis=1).astype(np.float32)
    integer = np.minimum(np.arange(7)[None, :] + 3, 9).repeat(4, 0).astype(
        np.float32)
    tpm = _kpm(4, 7, [7, 5, 2, 6])
    return cont, integer, tpm, np.array([20, 9, 31, 12]), (~tpm).sum(1)


@pytest.mark.parametrize("metric", sorted(tlat.LATENCY_METRICS))
def test_latency_metrics_match_jax(metric):
    """AL, AP and DAL (rtol 1e-5) on continuous and integer delays, with
    and without the padding mask; DAL's and AP's gradients in continuous
    delays within 1e-5 of the largest entry (AL's tau is piecewise
    constant)."""
    cont, integer, tpm, src, tgt = _delays()
    jfn, tfn = jlat.LATENCY_METRICS[metric], tlat.LATENCY_METRICS[metric]
    for delays in (cont, integer):
        for mask in (None, tpm):
            want = jfn(jnp.asarray(delays), jnp.asarray(src),
                       jnp.asarray(tgt), None if mask is None
                       else jnp.asarray(mask))
            got = tfn(_t(delays), _t(src), _t(tgt),
                      None if mask is None else _t(mask))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5)
    if metric != "average_lagging":
        _vjp_check(lambda d: jfn(d, jnp.asarray(src), jnp.asarray(tgt),
                                 jnp.asarray(tpm)),
                   lambda d: tfn(d, _t(src), _t(tgt), _t(tpm)), [cont])


# ---------------------------------------------------------------------------
# the model and the loss
# ---------------------------------------------------------------------------

def test_latency_update_after_keeps_the_latency_term_off():
    """latency_update_after > 0 with the default num_updates = 0 (how the
    CLI calls it): the latency term is 0, on both sides."""
    cfg = dict(latency_avg_weight=1.0, latency_update_after=10)
    alpha = np.random.RandomState(10).dirichlet(np.ones(6), (2, 2, 4)).astype(
        np.float32)
    target = np.array([[5, 6, 2, 1], [7, 2, 1, 1]])
    logits = _rand(np.random.RandomState(11), 2, 4, 9)
    src, enc = np.array([40, 30]), np.array([6, 5])
    _, mj = jml.mma_loss(jnp.asarray(logits), {
        "attn_list": [{"alpha": jnp.asarray(alpha)}],
        "encoder_lengths": jnp.asarray(enc)}, jnp.asarray(target),
        jnp.asarray(src), jml.MMALossConfig(**cfg))
    _, mt = tml.mma_loss(_t(logits), {"attn_list": [{"alpha": _t(alpha)}],
                                      "encoder_lengths": _t(enc)},
                         _t(target), _t(src), tml.MMALossConfig(**cfg))
    assert float(mt["latency_loss"]) == float(mj["latency_loss"]) == 0.0
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# checkpoints and the CLI
# ---------------------------------------------------------------------------

def test_component_load_takes_exactly_the_model_keys():
    """An ASR encoder with a CTC head loads into an MMA encoder without
    one; a checkpoint that lacks a key of the model raises."""
    asr = ts2t.S2TEmformerModel(ts2t.S2TEmformerConfig(
        **{k: v for k, v in SMALL.items()
           if k != "fixed_pre_decision_ratio"}, ctc_layer=True),
        generator=torch.Generator().manual_seed(1), device="cpu")
    mma = tmma.MMAModel(tmma.MMAConfig(**SMALL), device="cpu")
    enc = {k[len("encoder."):]: v for k, v in asr.state_dict().items()
           if k.startswith("encoder.")}
    assert "ctc_layer.weight" in enc
    sd = tckpt.load_pretrained_component(mma.state_dict(), enc, "encoder")
    assert sorted(sd) == sorted(mma.state_dict())
    mma.load_state_dict(sd)
    for k, v in mma.encoder.state_dict().items():
        assert torch.equal(v, enc[k]), k
    del enc["emformer.layers.0.pos_ff.fc1.weight"]
    with pytest.raises(KeyError, match="fc1.weight"):
        tckpt.load_pretrained_component(mma.state_dict(), enc, "encoder")


def _write_manifest(tmp_path):
    rows = tsyn.mustc_like_rows(16, seed=4, tmpdir=str(tmp_path), feat_dim=8)
    for r in rows:   # 1-4 s, so the CPU steps stay short
        r["n_frames"] = str(min(int(r["n_frames"]), 400))
    header = "id\taudio\tn_frames\tsrc_text\ttgt_text\tspeaker"
    for split, part in (("train", rows[:12]), ("dev", rows[12:])):
        (tmp_path / f"{split}_st.tsv").write_text("\n".join(
            [header] + ["\t".join(r[c] for c in header.split("\t"))
                        for r in part]) + "\n")
    (tmp_path / "spm_unigram.txt").write_text(
        "".join(f"▁{c * 3} 1\n" for c in "abcdefghij"))


def test_cli_trains_mma_from_an_asr_encoder_and_averages(tmp_path):
    """exp/2_mma.sh's options on a MuST-C-shaped manifest on the CPU: the
    encoder from a port ASR checkpoint that has a CTC head, two updates, a
    validation, checkpoint_last; then cli/average_checkpoints over the
    best checkpoints equals their mean."""
    _write_manifest(tmp_path)
    small = {k: v for k, v in SMALL.items() if k != "vocab_size"}
    asr_cfg = ts2t.S2TEmformerConfig(
        vocab_size=14, ctc_layer=True,
        **{k: v for k, v in small.items() if k != "fixed_pre_decision_ratio"})
    asr = ts2t.S2TEmformerModel(asr_cfg, device="cpu",
                                generator=torch.Generator().manual_seed(3))
    tckpt.save_checkpoint(str(tmp_path / "asr_last"), asr.state_dict(),
                          {"model": "s2t_emformer"})
    save = tmp_path / "mma"
    state = tcli.main(MMA_ARGS + [
        "--data", str(tmp_path), "--device", "cpu", "--max-updates", "2",
        "--max-tokens", "1600", "--save-dir", str(save),
        "--override", "simul_attn_type=infinite_lookback_fixed_pre_decision",
        "--override", "mass_preservation=true",
        "--loss-override", "latency_avg_weight=0.1",
        "--loss-override", "latency_avg_type=differentiable_average_lagging",
        "--load-pretrained-encoder-from", str(tmp_path / "asr_last"),
        "--lr", "5e-4", "--warmup-updates", "4000", "--clip-norm", "10",
        *[f"--override={k}={v}" for k, v in small.items()]])
    assert state.step == 2
    log = (save / "train_log.jsonl").read_text()
    assert '"valid_update": 2' in log and '"loss"' in log
    last, meta = tckpt.load_checkpoint(str(save / "checkpoint_last"))
    assert meta["model"] == "mma" and "encoder.ctc_layer.weight" not in last
    moved = max((last[k] - v).abs().max().item()
                for k, v in asr.state_dict().items()
                if k.startswith("encoder.") and k in last)
    assert 0 < moved < 1e-2           # loaded, then two small updates

    sd = {k: v.clone() for k, v in last.items()}
    tckpt.save_checkpoint(str(save / "checkpoint.best_loss_0.5000"),
                          {k: v * 3 for k, v in sd.items()}, meta)
    best = tckpt.find_best_checkpoints(str(save), n=2)
    assert len(best) == 2
    out = tmp_path / "avg"
    assert tavg.main(["--dir", str(save), "--n", "2", "--output",
                      str(out)]) == best
    avg, _ = tckpt.load_checkpoint(str(out))
    want = tckpt.average_params([tckpt.load_checkpoint(p)[0] for p in best])
    for k, v in want.items():
        torch.testing.assert_close(avg[k], v, atol=0, rtol=0)
    fresh = tmma.MMAModel(tmma.MMAConfig(**{**SMALL, "vocab_size": 14}),
                          device="cpu")
    fresh.load_state_dict(tckpt.conform_state(fresh.state_dict(), avg))


def test_cli_load_params_takes_a_resume_checkpoint(tmp_path):
    """--load-params from checkpoint_resume (params + optimizer + step):
    every parameter taken, bit for bit."""
    src = tmma.MMAModel(tmma.MMAConfig(**{**SMALL, "vocab_size": 14}),
                        generator=torch.Generator().manual_seed(5),
                        device="cpu")
    tckpt.save_checkpoint(str(tmp_path / "checkpoint_resume"), {
        "params": src.state_dict(), "opt_state": {}, "step": 3})
    args = tcli.parse_args(MMA_ARGS + [
        "--load-params", str(tmp_path / "checkpoint_resume"),
        *[f"--override={k}={v}" for k, v in SMALL.items()
          if k != "vocab_size"]])
    model = tcli.build_model(args, 14, device="cpu")
    for k, v in src.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
