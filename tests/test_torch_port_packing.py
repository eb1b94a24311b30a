"""Sequence-packed training (cli/train --pack) of simulst_tpu_torch vs the
JAX package, on the CPU.

Tiny configs in the style of tests/test_packing.py (width 16, 2 heads,
segment 4 / left context 8 / right context 2, 2 memory slots; the
s2t_emformer cases width 16 with segment 16 / left context 32 / right
context 8 before subsampling); JAX init bridged to the port
(compat/jax_bridge.load_jax_params); seeded numpy inputs; fp32 with
jax_default_matmul_precision float32 (tests/conftest.py).  Where the JAX
function reaches the Pallas kernel it runs in interpret mode with its
kernel_mask, as tests/test_packing.py runs it.  Tolerances, each stated
again at its test: the planner's arrays equal; gathers exact; the packed
Emformer forward atol 2e-5 and its parameter gradients atol 3e-4 (the
bounds tests/test_packing.py holds the JAX packed path to); the gated
attention's plain forward and backward atol 1e-5; the packed encoder and
CTC logits atol 2e-5; the packed loss rtol 1e-5.
"""
import argparse

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each
import jax.numpy as jnp  # noqa: E402

from simulst_tpu.cli.train import build_loss as j_build_loss  # noqa: E402
from simulst_tpu.models import s2t_emformer as js2t  # noqa: E402
from simulst_tpu.nn import conv as jconv  # noqa: E402
from simulst_tpu.nn import emformer as jemf  # noqa: E402
from simulst_tpu.ops.emformer_attn_pallas import AttnGeom as JGeom  # noqa: E402
from simulst_tpu.ops.emformer_attn_pallas import \
    emformer_grouped_attention as j_attn  # noqa: E402
from simulst_tpu.train import packing as jpk  # noqa: E402
from simulst_tpu_torch.cli import train as tcli  # noqa: E402
from simulst_tpu_torch.compat.jax_bridge import load_jax_params  # noqa: E402
from simulst_tpu_torch.data import synthetic as tsyn  # noqa: E402
from simulst_tpu_torch.models import s2t_emformer as ts2t  # noqa: E402
from simulst_tpu_torch.nn import emformer as temf  # noqa: E402
from simulst_tpu_torch.ops import emformer_attn as tattn  # noqa: E402
from simulst_tpu_torch.train import packing as tpk  # noqa: E402

GEOM = dict(input_dim=16, num_heads=2, ffn_dim=32, num_layers=2, segment=4,
            left_context=8, right_context=2, max_memory=2)
NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
S2T = dict(vocab_size=23, input_feat=80, conv_channels=16, embed_dim=16,
           ffn_dim=32, encoder_layers=2, encoder_heads=2, decoder_layers=1,
           decoder_heads=2, decoder_ffn_dim=32, segment_length=16,
           left_context=32, right_context=8, max_memory=2, ctc_layer=True)
ASR_ARGS = ["--task", "asr", "--model", "s2t_emformer", "--loss",
            "joint_ctc", "--override", "ctc_layer=true"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(**kw):
    geom = dict(GEOM, **kw)
    return (jemf.EmformerConfig(**geom, **NO_DROPOUT),
            temf.EmformerConfig(**geom, **NO_DROPOUT))


# ---------------------------------------------------------------------------
# the planner and the gathers
# ---------------------------------------------------------------------------

PLANS = {   # lengths, U, seg, rc, n_rows, row_segs
    "same-length rows": ([13, 7, 16, 4], 16, 4, 2, 3, None),
    "sized by FFD": ([64, 34, 23, 12, 5, 61], 64, 4, 2, None, None),
    "rc > seg": ([16, 13, 7, 4], 16, 4, 6, 3, None),
    "rows longer than U": ([30, 27, 23, 16], 32, 4, 2, None, 16),
    "long rows, rc > seg": ([30, 27, 23, 16, 9], 32, 4, 9, 3, 12),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_planner_matches_jax(case):
    """pack_plan's five arrays equal JAX's (dtype int32);
    choose_row_segments, usable_row_segments and plan_capacity equal."""
    lengths, U, seg, rc, n_rows, row_segs = PLANS[case]
    want = jpk.pack_plan(lengths, U, seg, rc, n_rows, row_segs)
    got = tpk.pack_plan(lengths, U, seg, rc, n_rows, row_segs)
    for field in jpk.PackPlan._fields:
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
        assert getattr(got, field).dtype == np.int32
    assert tpk.plan_capacity(lengths, seg) == jpk.plan_capacity(lengths, seg)
    jcfg, tcfg = _configs(segment=seg, right_context=rc)
    n0 = U // seg
    cands = tpk.usable_row_segments(tcfg, n0, 4 * n0)
    assert cands == jpk.usable_row_segments(jcfg, n0, 4 * n0) and cands
    assert tpk.choose_row_segments(lengths, seg, cands) == \
        jpk.choose_row_segments(lengths, seg, cands)


def test_pack_plan_overflow_raises_on_both_sides():
    with pytest.raises(ValueError):
        jpk.pack_plan([16, 16, 16], 16, 4, 2, n_rows=2)
    with pytest.raises(ValueError, match="more than 2 rows"):
        tpk.pack_plan([16, 16, 16], 16, 4, 2, n_rows=2)


@pytest.mark.parametrize("case", ["rc > seg", "rows longer than U"])
def test_pack_and_unpack_frames_match_jax(case):
    """pack_frames' packed rows and rc blocks and unpack_frames equal JAX's
    exactly (gathers), and unpacking gives back the zero-padded input."""
    lengths, U, seg, rc, n_rows, row_segs = PLANS[case]
    x = np.random.RandomState(1).randn(len(lengths), U, 3).astype(np.float32)
    x[np.arange(U)[None, :] >= np.array(lengths)[:, None]] = 0.0
    jplan = jpk.pack_plan(lengths, U, seg, rc, n_rows, row_segs)
    tplan = tpk.pack_plan(lengths, U, seg, rc, n_rows, row_segs)
    jp, jrc = jpk.pack_frames(jnp.asarray(x), jplan)
    tp, trc = tpk.pack_frames(torch.from_numpy(x), tplan)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(trc.numpy(), np.asarray(jrc))
    back = tpk.unpack_frames(tp, tplan)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jpk.unpack_frames(jp, jplan, *x.shape[:2])))
    np.testing.assert_array_equal(back.numpy(), x)


# ---------------------------------------------------------------------------
# the packed Emformer
# ---------------------------------------------------------------------------

EMFORMER_CASES = {   # config overrides, lengths, U, n_rows, row_segs
    "grouped G 8": (dict(segment_group=8), [64, 34, 23, 12], 64, 3, None),
    "segmented": (dict(segment_group=1), [16, 13, 7, 4], 16, 3, None),
    "rc > seg": (dict(right_context=6), [16, 13, 7, 4], 16, 3, None),
    "rows longer than U": (dict(segment_group=8), [30, 27, 23, 16], 32,
                           None, 16),
}


def _loss_weights(out, lengths):
    """The scalar both sides differentiate: sum over valid frames of
    o cos(0.1 o) (tests/test_packing.py's)."""
    lib = torch if isinstance(out, torch.Tensor) else jnp
    mask = (lib.arange(out.shape[1])[None, :]
            < lib.asarray(np.asarray(lengths))[:, None])[:, :, None]
    return (lib.where(mask, out, 0.0) * lib.cos(out * 0.1)).sum()


@pytest.mark.parametrize("case", sorted(EMFORMER_CASES))
def test_emformer_forward_packed_matches_jax_and_dense(case):
    """emformer_forward_packed vs JAX's on every valid frame (atol 2e-5)
    and every parameter's gradient of a loss over the valid frames (atol
    3e-4); and vs the port's own padded emformer_forward, forward and
    gradients, at the same tolerances."""
    overrides, lengths, U, n_rows, row_segs = EMFORMER_CASES[case]
    jcfg, tcfg = _configs(**overrides)
    jp = jemf.emformer_init(jax.random.PRNGKey(6), jcfg)
    rng = np.random.RandomState(7)
    x = rng.randn(len(lengths), U + tcfg.right_context,
                  tcfg.input_dim).astype(np.float32)
    x[np.arange(U + tcfg.right_context)[None, :]
      >= np.array(lengths)[:, None]] = 0.0
    jplan = jpk.pack_plan(lengths, U, tcfg.segment, tcfg.right_context,
                          n_rows, row_segs)
    tplan = tpk.pack_plan(lengths, U, tcfg.segment, tcfg.right_context,
                          n_rows, row_segs)
    if case == "grouped G 8" or case == "rows longer than U":
        n_p = tplan.seg_eid.shape[1]
        assert temf._choose_group(n_p, n_p * tcfg.segment, tcfg) > 1

    def j_out(p):
        packed, rc = jpk.pack_frames(jnp.asarray(x[:, :U]), jplan)
        o = jemf.emformer_forward_packed(p, jcfg, packed, rc,
                                         jplan.frame_eid, jplan.seg_eid)
        return jpk.unpack_frames(o, jplan, len(lengths), U)

    ref_out, jgrads = jax.jit(lambda p: (j_out(p), jax.grad(
        lambda q: _loss_weights(j_out(q), lengths))(p)))(jp)
    ref_out = np.asarray(ref_out)
    jgrads = load_jax_params(_np(jgrads))

    model = temf.Emformer(tcfg)
    model.load_state_dict(load_jax_params(_np(jp)))
    xt = torch.from_numpy(x)
    packed, rc = tpk.pack_frames(xt[:, :U], tplan)
    out = tpk.unpack_frames(temf.emformer_forward_packed(
        model, tcfg, packed, rc, torch.from_numpy(tplan.frame_eid),
        torch.from_numpy(tplan.seg_eid)), tplan)
    _loss_weights(out, lengths).backward()
    packed_grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad()
    dense = temf.emformer_forward(model, tcfg, xt, torch.tensor(lengths))
    _loss_weights(dense, lengths).backward()
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(out[i, :n].detach().numpy(),
                                   ref_out[i, :n], atol=2e-5, rtol=2e-5,
                                   err_msg=f"vs JAX, example {i}")
        np.testing.assert_allclose(out[i, :n].detach().numpy(),
                                   dense[i, :n].detach().numpy(), atol=2e-5,
                                   rtol=2e-5, err_msg=f"vs dense, example {i}")
    assert sorted(packed_grads) == sorted(jgrads)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(packed_grads[name].numpy(),
                                   jgrads[name].numpy(), atol=3e-4,
                                   rtol=3e-4, err_msg=f"vs JAX {name}")
        np.testing.assert_allclose(packed_grads[name].numpy(),
                                   p.grad.numpy(), atol=3e-4, rtol=3e-4,
                                   err_msg=f"vs dense {name}")


def test_gated_attention_plain_matches_pallas_interpret(monkeypatch):
    """grouped_attention_plain and its backward with the gate vs jax.vjp of
    the Pallas kernel in interpret mode with the kernel_mask that JAX's
    make_packed_eids builds, at rate 0, on packed rows where a group
    straddles an example boundary and dead segments close the rows (3 rows
    of 16 segments, G 8, 2 heads of 32): atol 1e-5.  A gate of the wrong
    dtype, shape or device raises."""
    jcfg, tcfg = _configs(input_dim=64, segment_group=8)
    lengths, U = [64, 34, 23, 12, 9], 64
    plan = tpk.pack_plan(lengths, U, 4, 2, n_rows=3)
    R, Up = plan.frame_gather.shape
    assert (plan.seg_eid == -1).any()
    g = dict(U=Up, seg=4, lc=8, rc=2, max_mem=2, G=8, num_heads=2)
    jgeom, tgeom = JGeom(**g), tattn.AttnGeom(**g)
    monkeypatch.setattr(jemf, "attn_pallas_supported", lambda geom, d: True)
    jeids = jemf.make_packed_eids(jcfg, Up, plan.frame_eid, plan.seg_eid, 64)
    teids = temf.make_packed_eids(tcfg, torch.from_numpy(plan.frame_eid),
                                  torch.from_numpy(plan.seg_eid))
    np.testing.assert_array_equal(teids.kid.numpy(), np.asarray(jeids.kid))
    gate = teids
    rng = np.random.RandomState(5)
    arrays = [rng.randn(R, *shape).astype(np.float32) for shape in
              ((tgeom.ng, tgeom.nq, 64), (tgeom.tk, 64), (tgeom.tk, 64))]
    dout = rng.randn(R, tgeom.ng, tgeom.nq, 64).astype(np.float32)
    full = np.full((R,), Up, np.int32)
    ref, vjp = jax.vjp(
        lambda q, k, v: j_attn(q, k, v, jnp.asarray(full),
                               jnp.array([0], jnp.int32), jeids.kernel_mask,
                               jgeom, 0.0, True), *map(jnp.asarray, arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = tattn.emformer_grouped_attention(*ts, torch.from_numpy(full), tgeom,
                                           gate=gate)
    out.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)
    for name, t, want in zip("qkv", ts, vjp(jnp.asarray(dout))):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5, err_msg=f"d{name}")
    # the gate changes the result: without it rows see other examples
    ungated = tattn.grouped_attention_plain(*[t.detach() for t in ts],
                                            torch.from_numpy(full), tgeom)
    assert not torch.allclose(ungated, out.detach(), atol=1e-3)
    for bad in (tattn.EidGate(teids.kid.long(), teids.seg_eid),
                tattn.EidGate(teids.kid, teids.seg_eid[:, 1:]),
                tattn.EidGate(teids.kid, teids.seg_eid.to("meta"))):
        with pytest.raises(ValueError, match="gate"):
            tattn.emformer_grouped_attention_forward(
                *[t.detach() for t in ts], torch.from_numpy(full), tgeom,
                gate=bad)


# ---------------------------------------------------------------------------
# the model, the loss and the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def s2t_pair():
    jmodel = js2t.S2TEmformerModel(js2t.S2TEmformerConfig(**S2T,
                                                          **NO_DROPOUT))
    jp = jmodel.init(jax.random.PRNGKey(0))
    model = ts2t.S2TEmformerModel(ts2t.S2TEmformerConfig(**S2T), device="cpu")
    model.load_state_dict(load_jax_params(_np(jp)))
    return jmodel, jp, model


def test_encoder_forward_packed_matches_jax(s2t_pair):
    """encoder_forward_packed vs JAX's on lengths [256, 173, 129, 64] in 3
    rows: encoder output and CTC logits on valid frames atol 2e-5,
    lengths equal."""
    _, jp, model = s2t_pair
    cfg = model.cfg
    feats = np.random.RandomState(5).randn(4, 256, 80).astype(np.float32)
    feat_lengths = np.array([256, 173, 129, 64], np.int32)
    _, l4 = jconv.subsampler_apply(jp["encoder"]["subsample"],
                                   jnp.asarray(feats),
                                   jnp.asarray(feat_lengths))
    plan = tpk.pack_plan(np.asarray(l4), 256 // cfg.stride,
                         cfg.emformer.segment, cfg.emformer.right_context,
                         n_rows=3)
    ref = js2t.encoder_forward_packed(
        jp["encoder"], js2t.S2TEmformerConfig(**S2T, **NO_DROPOUT),
        jnp.asarray(feats), jnp.asarray(feat_lengths), jpk.PackPlan(*plan))
    with torch.no_grad():
        got = ts2t.encoder_forward_packed(
            model.encoder, ts2t.S2TEmformerConfig(**S2T, **NO_DROPOUT),
            torch.from_numpy(feats), torch.from_numpy(feat_lengths), plan)
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    for i, n in enumerate(np.asarray(ref.lengths)):
        for key in ("encoder_out", "ctc_logits"):
            np.testing.assert_allclose(
                getattr(got, key)[i, :n].numpy(),
                np.asarray(getattr(ref, key))[i, :n], atol=2e-5, rtol=2e-5,
                err_msg=f"{key} {i}")


def _jax_attach(jp, cfg, batch):
    """What the JAX CLI's attach_pack_plan closure computes for a bucket's
    first batch (simulst_tpu/cli/train.py), with the JAX planner."""
    l4 = np.asarray(jconv.subsampler_out_lengths(
        jp["encoder"]["subsample"], jnp.asarray(batch["feat_lengths"])))
    ecfg = cfg.emformer
    U4 = batch["feats"].shape[1] // cfg.stride
    n0 = U4 // ecfg.segment
    n_p = jpk.choose_row_segments(l4, ecfg.segment, jpk.usable_row_segments(
        ecfg, n0, 4 * n0))
    plan = jpk.pack_plan(l4, U4, ecfg.segment, ecfg.right_context,
                         row_segs=n_p)
    r = plan.frame_gather.shape[0]
    if r % 4:
        plan = jpk.pack_plan(l4, U4, ecfg.segment, ecfg.right_context,
                             n_rows=r + 4 - r % 4, row_segs=n_p)
    return plan


def test_packed_loss_matches_jax_and_dense(s2t_pair):
    """cli/train's joint-CTC loss on a batch carrying attach_pack_plan's
    plan: the plan equals what JAX's CLI attaches (rows a multiple of 4),
    and the packed loss equals JAX's packed loss and the port's dense loss,
    rtol 1e-5 (dropout 0, no SpecAugment)."""
    jmodel, jp, model = s2t_pair
    rng = np.random.RandomState(7)
    batch = {"feats": rng.randn(6, 256, 80).astype(np.float32),
             "feat_lengths": np.array([256, 170, 131, 64, 250, 97], np.int32),
             "prev_tokens": rng.randint(3, 23, (6, 6)).astype(np.int32),
             "target": rng.randint(3, 23, (6, 6)).astype(np.int32)}
    jplan = _jax_attach(jp, jmodel.cfg, batch)
    n_p_by_bucket = {}
    packed = tcli.attach_pack_plan(dict(batch), model, n_p_by_bucket)
    assert n_p_by_bucket == {64: jplan.seg_eid.shape[1]}
    assert packed["pack_frame_gather"].shape[0] % 4 == 0
    for f in jpk.PackPlan._fields:
        np.testing.assert_array_equal(packed[f"pack_{f}"], getattr(jplan, f),
                                      err_msg=f)

    jfn = j_build_loss(argparse.Namespace(loss="joint_ctc", loss_overrides={},
                                          specaugment=False), jmodel)
    jbatch = {k: jnp.asarray(v) for k, v in packed.items()}
    j_loss = float(jax.jit(lambda p, b: jfn(p, b, None)[0])(jp, jbatch))
    fn = tcli.build_loss(tcli.parse_args(ASR_ARGS + ["--pack",
                                                     "--no-specaugment"]),
                         model)
    with torch.no_grad():
        loss_p = fn(model, {k: torch.as_tensor(v) for k, v in packed.items()},
                    None)[0].item()
        loss_d = fn(model, {k: torch.as_tensor(v) for k, v in batch.items()},
                    None)[0].item()
    np.testing.assert_allclose(loss_p, j_loss, rtol=1e-5)
    np.testing.assert_allclose(loss_p, loss_d, rtol=1e-5)


@pytest.mark.parametrize("argv,takes", [
    (ASR_ARGS + ["--pack"], True),
    (["--task", "st", "--model", "s2t_emformer", "--loss", "joint_ctc",
      "--pack"], True),
    (["--task", "st", "--model", "mma", "--loss", "mma", "--pack"], False),
    (["--task", "st", "--model", "cif", "--loss", "cif", "--pack"], False),
    (["--task", "mt", "--model", "mt_transformer", "--loss", "ce", "--pack"],
     False),
], ids=["asr", "st", "mma", "cif", "mt"])
def test_parse_args_takes_pack_for_joint_ctc_only(argv, takes):
    if takes:
        assert tcli.parse_args(argv).pack
    else:
        with pytest.raises(ValueError, match="--pack"):
            tcli.parse_args(argv)


def test_cli_trains_packed_on_the_cpu(tmp_path, monkeypatch):
    """cli/train main with --pack: two updates through packed batches (the
    Trainer carries the int32 plan onto the model's device), validation
    unpacked, checkpoint_last written."""
    rows = tsyn.mustc_like_rows(16, seed=2, tmpdir=str(tmp_path), feat_dim=8)
    for r in rows:   # 1-4 s, so the CPU steps stay short
        r["n_frames"] = str(min(int(r["n_frames"]), 400))
    header = "id\taudio\tn_frames\tsrc_text\ttgt_text\tspeaker"
    for split, part in (("train", rows[:12]), ("dev", rows[12:])):
        (tmp_path / f"{split}_st.tsv").write_text("\n".join(
            [header] + ["\t".join(r[c] for c in header.split("\t"))
                        for r in part]) + "\n")
    (tmp_path / "spm_unigram.txt").write_text(
        "".join(f"▁{c * 3} 1\n" for c in "abcdefghij"))
    calls = []
    plans = []

    def spy_forward(p, cfg, feats, feat_lengths, plan, rngs=None):
        calls.append(feats.shape)
        plans.append({f: getattr(plan, f).dtype for f in plan._fields})
        return packed_forward(p, cfg, feats, feat_lengths, plan, rngs)

    packed_forward = ts2t.encoder_forward_packed
    monkeypatch.setattr(ts2t, "encoder_forward_packed", spy_forward)
    small = ["--override=input_feat=8", "--override=conv_channels=16",
             "--override=embed_dim=64", "--override=ffn_dim=128",
             "--override=encoder_layers=2", "--override=encoder_heads=2",
             "--override=decoder_layers=1", "--override=decoder_heads=2",
             "--override=decoder_ffn_dim=128",
             "--override=max_target_positions=64"]
    save = tmp_path / "ckpt"
    state = tcli.main(ASR_ARGS + [
        "--pack", "--data", str(tmp_path), "--device", "cpu",
        "--max-updates", "2", "--max-tokens", "1600", "--save-dir",
        str(save), *small])
    assert state.step == 2 and len(calls) == 2
    assert all(d == torch.int32 for p in plans for d in p.values())
    log = (save / "train_log.jsonl").read_text()
    assert '"valid_update": 2' in log
    assert (save / "checkpoint_last").exists()
