"""Data parallelism, tensor parallelism, sharded serving and sharded
evaluation of simulst_tpu_torch, on the CPU over gloo, against the port's
one-process path and the JAX package.

Each world (2 and 4 ranks) is spawned once for this file
(comm.spawn; the rank code is simulst_tpu_torch/multichip.py, which
imports neither JAX nor the JAX package) and runs every case; the JAX side
runs here on the virtual CPU devices of tests/conftest.py.  Small config:
2 + 2 layers, width 64, vocab 40, 8 input features, 128 frames (32 after
subsampling), 8 rows, no dropout, JAX's init bridged to the port.
Tolerances, each stated again at its test: the data-parallel and the
(data x model) accumulation's loss rtol 1e-6 and every whole gradient
within 1e-5 of its largest entry against the one process (a decoder key
bias, whose exact gradient is 0, within 1e-5 of its weight's), and
against JAX's one-device gradient the loss rtol 1e-5 and the gradients
within 1e-4 of the largest entry; the ranks' parameters equal
after three updates (update_freq 2, the second update skipped for a NaN
in one rank's rows); each update's loss and gradient norm rtol 1e-5
against the one process and JAX, and the parameters within twice the
updates' summed learning rate of both, a sanity bound only (Adam moves
every entry by at most the learning rate, whatever its gradient, so it
does not test the gradient); the validation over two nodes scores the
one process's rows, its WER equal and its loss rtol 1e-6; sharded
serving tokens equal.  The CLIs under torchrun and the kernel build's
lock: tests/test_torch_port_parallel_cli.py.
"""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from simulst_tpu.data import dataset as jds  # noqa: E402
from simulst_tpu.data.vocab import Vocabulary as JVocab  # noqa: E402
from simulst_tpu.decode import scoring as jscoring  # noqa: E402
from simulst_tpu.losses import joint_ctc as jjc  # noqa: E402
from simulst_tpu.models import cif as jcif  # noqa: E402
from simulst_tpu.models import mma as jmma  # noqa: E402
from simulst_tpu.models import s2t_emformer as js2t  # noqa: E402
from simulst_tpu.stream import fused as jfused  # noqa: E402
from simulst_tpu.train.optim import OptimConfig as JOptim  # noqa: E402
from simulst_tpu.train.sharding import param_shardings  # noqa: E402
from simulst_tpu.train.state import TrainState as JState  # noqa: E402
from simulst_tpu.train.state import create_train_state as j_create  # noqa: E402
from simulst_tpu.train.state import make_train_step as j_make_step  # noqa: E402
from simulst_tpu_torch import comm  # noqa: E402
from simulst_tpu_torch import multichip as mc  # noqa: E402
from simulst_tpu_torch.compat.jax_bridge import load_jax_params  # noqa: E402
from simulst_tpu_torch.data import dataset as tds  # noqa: E402
from simulst_tpu_torch.data.vocab import EOS  # noqa: E402
from simulst_tpu_torch.data.vocab import Vocabulary as TVocab  # noqa: E402
from simulst_tpu_torch.models import cif as tcif  # noqa: E402
from simulst_tpu_torch.models import mma as tmma  # noqa: E402
from simulst_tpu_torch.models import s2t_emformer as ts2t  # noqa: E402

SMALL = dict(vocab_size=40, input_feat=8, conv_channels=16, embed_dim=64,
             ffn_dim=128, encoder_layers=2, encoder_heads=2, decoder_layers=2,
             decoder_heads=2, decoder_ffn_dim=128, segment_length=16,
             left_context=32, right_context=8, max_memory=2,
             max_target_positions=64, ctc_layer=True)
NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
STREAM = dict(vocab_size=24, input_feat=8, conv_channels=16, embed_dim=16,
              ffn_dim=32, encoder_layers=1, encoder_heads=2, decoder_layers=1,
              decoder_heads=2, decoder_ffn_dim=32, segment_length=16,
              left_context=32, right_context=8, max_memory=2, **NO_DROPOUT)
ROWS = 8
UPDATES = 3
MAX_TOKENS = 32
STREAM_SESSIONS = 8
NODE_ROWS = 12


def _as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_loss(jmodel):
    def fn(params, batch, rng):
        logits, extra = jmodel.forward(params, batch["feats"],
                                       batch["feat_lengths"],
                                       batch["prev_tokens"])
        return jjc.joint_ctc_loss(logits, extra, batch["target"],
                                  jjc.JointCTCConfig())
    return fn


def _stream_params(kind):
    """(JAX model, JAX params, port config) of the JAX package's sharded
    streaming test models, EOS's row shrunk and the final LN's scale at
    random so that greedy decoding writes tokens."""
    if kind == "cif":
        jmodel, tcfg = jcif.CIFModel(jcif.CIFConfig(**STREAM)), \
            tcif.CIFConfig(**STREAM)
    else:
        jmodel = jmma.MMAModel(jmma.MMAConfig(**STREAM, ctc_layer=False))
        tcfg = tmma.MMAConfig(**STREAM, ctc_layer=False)
    jp = jmodel.init(jax.random.PRNGKey(0))
    dec = jp["decoder"]
    dec["embed_tokens"]["weight"] = dec["embed_tokens"]["weight"].at[
        EOS].multiply(0.1)
    dec["layer_norm"]["scale"] = jnp.asarray(np.random.RandomState(3).randn(
        16).astype(np.float32) * 3.0)
    return jmodel, jp, tcfg


def _jax_stream_tokens(kind, jmodel, jp, chunks):
    if kind == "cif":
        step = jfused.make_cif_fused_step(jp, jmodel.cfg)
        state = jfused.cif_fused_init(jp, jmodel.cfg, MAX_TOKENS,
                                      batch=STREAM_SESSIONS)
    else:
        step = jfused.make_mma_fused_step(jp, jmodel.cfg)
        state = jfused.mma_fused_init(jp, jmodel.cfg, max_src=64,
                                      max_tokens=MAX_TOKENS,
                                      batch=STREAM_SESSIONS)
    for i, ch in enumerate(chunks):
        state, _ = step(state, jnp.asarray(ch), finish=i == len(chunks) - 1)
    return np.asarray(state.tokens), np.asarray(state.n_tokens)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX init, the batch, the manifests, and the JAX references."""
    root = tmp_path_factory.mktemp("parallel")
    jmodel = js2t.S2TEmformerModel(js2t.S2TEmformerConfig(**SMALL,
                                                          **NO_DROPOUT))
    jp = jmodel.init(jax.random.PRNGKey(0))
    params = load_jax_params(_as_np(jp))
    tcfg = ts2t.S2TEmformerConfig(**SMALL, **NO_DROPOUT)
    batch = mc.dryrun_batch(tcfg, ROWS)
    # the JAX one-device steps over the same update batches as each world
    jstep = jax.jit(j_make_step(_jax_loss(jmodel), JOptim(**mc.OPTIM),
                                update_freq=2))
    full = {k: torch.as_tensor(v) for k, v in batch.items()}
    jax_dp = {}
    for world in (2, 4):
        state, hist = j_create(jp, JOptim(**mc.OPTIM)), []
        for u in range(UPDATES):
            b = mc.update_batch(full, 2, u, 1, world - 1, world)
            state, m = jstep(state, {k: jnp.asarray(v.numpy())
                                     for k, v in b.items()},
                             jax.random.PRNGKey(0))
            hist.append({k: float(m[k]) for k in ("loss", "gnorm",
                                                  "skipped")})
        jax_dp[world] = (hist, load_jax_params(_as_np(state.params)))
    # JAX's (data 2, model 2) step with param_shardings, two updates
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    ps = param_shardings(jp, mesh)
    rep, dat = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    st = j_create(jp, JOptim(**mc.OPTIM))
    st = JState(params=jax.device_put(st.params, ps),
                opt_state=jax.device_put(st.opt_state, rep),
                step=jax.device_put(st.step, rep))
    tp_step = jax.jit(j_make_step(_jax_loss(jmodel), JOptim(**mc.OPTIM)),
                      in_shardings=(JState(params=ps, opt_state=rep,
                                           step=rep), dat, rep),
                      out_shardings=(JState(params=ps, opt_state=rep,
                                            step=rep), rep))
    tp_hist = []
    with mesh:
        for u in range(2):
            b = mc.update_batch(full, 1, u, None, 0, 2)
            st, m = tp_step(st, jax.device_put(
                {k: jnp.asarray(v.numpy()) for k, v in b.items()}, dat),
                jax.random.PRNGKey(0))
            tp_hist.append({k: float(m[k]) for k in ("loss", "gnorm",
                                                     "skipped")})
    jax_tp = (tp_hist, load_jax_params(_as_np(jax.device_get(st.params))))
    # JAX's summed loss and gradients of the whole batch on one device
    # (under param_shardings on the (2, 2) mesh its conv-pos weight-norm
    # gradients, which a Pallas call computes, come out up to twice these)
    jfn = _jax_loss(jmodel)
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jfn(p, b, None)[0]))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    jax_grads = (float(jloss), load_jax_params(_as_np(jg)))
    # streaming models, chunks and JAX's tokens
    stream = {}
    chunks = mc.streaming_chunks(tcif.CIFConfig(**STREAM), STREAM_SESSIONS,
                                 n_mid=5)
    for kind in ("cif", "mma"):
        jm, jsp, scfg = _stream_params(kind)
        stream[kind] = dict(cfg=scfg, params=load_jax_params(_as_np(jsp)),
                            jax=_jax_stream_tokens(kind, jm, jsp, chunks))
    # the evaluation manifest and the ASR model that decodes it (80 feats)
    eval_cfg = mc.tiny_config(vocab_size=64)
    jeval = js2t.S2TEmformerModel(js2t.S2TEmformerConfig(
        **{k: getattr(eval_cfg, k) for k in (
            "vocab_size", "input_feat", "conv_channels", "embed_dim",
            "ffn_dim", "encoder_layers", "encoder_heads", "decoder_layers",
            "decoder_heads", "decoder_ffn_dim", "segment_length",
            "left_context", "right_context", "max_memory", "ctc_layer")},
        **NO_DROPOUT))
    eval_params = load_jax_params(_as_np(jeval.init(jax.random.PRNGKey(1))))
    os.makedirs(root / "eval")
    rows, symbols = mc.synthetic_manifest(str(root / "eval"), 16,
                                          lambda i: 48 + 16 * (i % 3))
    # two nodes' validation: 6 utterances a node, one batch of 8 rows each
    os.makedirs(root / "nodes")
    node_rows, _ = mc.synthetic_manifest(str(root / "nodes"), NODE_ROWS,
                                         lambda i: 48 + 16 * (i % 3), seed=2)
    return dict(params=params, cfg=tcfg, batch=batch, jax_dp=jax_dp,
                jax_tp=jax_tp, jax_grads=jax_grads, stream=stream,
                chunks=chunks, eval_cfg=eval_cfg, eval_params=eval_params,
                eval_rows=rows, node_rows=node_rows, symbols=symbols)


def _cases(setup, world):
    cases = [("dp", "train_steps", dict(
        cfg=setup["cfg"], params=setup["params"], batch=setup["batch"],
        update_freq=2, updates=UPDATES, nan_update=1, nan_rank=world - 1))]
    if world == 4:
        cases.append(("tp", "train_steps", dict(
            cfg=setup["cfg"], params=setup["params"], batch=setup["batch"],
            n_data=2, n_model=2, updates=2)))
    for kind in ("cif", "mma"):
        s = setup["stream"][kind]
        cases.append((kind, "sharded_streaming", dict(
            kind=kind, cfg=s["cfg"], params=s["params"],
            chunks=setup["chunks"], max_tokens=MAX_TOKENS)))
    cases.append(("eval", "sharded_eval", dict(
        cfg=setup["eval_cfg"], params=setup["eval_params"],
        rows=setup["eval_rows"], symbols=setup["symbols"])))
    cases.append(("nodes", "node_valid", dict(
        cfg=setup["eval_cfg"], params=setup["eval_params"],
        rows=setup["node_rows"], symbols=setup["symbols"], nodes=2)))
    return cases


@pytest.fixture(scope="module")
def worlds(setup):
    """{world size: every rank's results}, each world spawned once."""
    return {w: comm.spawn(mc.run_cases, w, (_cases(setup, w),),
                              timeout=300)
            for w in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
def test_data_parallel_step_equals_one_process(worlds, world):
    """One accumulation over each rank's rows, summed: the loss rtol 1e-6
    and every gradient within 1e-5 of its largest entry against the one
    process on the whole batch."""
    res = worlds[world][0]["dp"]
    np.testing.assert_allclose(res["loss"], res["ref_loss"], rtol=1e-6)
    assert sorted(res["grads"]) == sorted(res["ref_grads"])
    assert mc.grads_err(res["grads"], res["ref_grads"]) <= 1e-5


@pytest.mark.parametrize("world", [2, 4])
def test_data_parallel_ranks_skip_together_and_stay_equal(worlds, world):
    """Three updates of update_freq 2, the second with NaN features in the
    last rank's rows: every rank skips it, the ranks' parameters are equal
    after the third, and each update's loss and norm (rtol 1e-5) and the
    parameters (within twice the summed learning rate) match the one
    process's."""
    ranks = [r["dp"] for r in worlds[world]]
    for r in ranks[1:]:
        for name, v in ranks[0]["params"].items():
            assert np.array_equal(r["params"][name], v), name
    mc.check_updates(ranks[0], [0.0, 1.0, 0.0], [], f"dp {world}")


def _hold_to_jax(res, jhist, jparams):
    tol = 2 * mc.lr_sum(res["history"])
    assert [h["skipped"] for h in res["history"]] == \
        [h["skipped"] for h in jhist]
    for h, j in zip(res["history"], jhist):
        if not h["skipped"]:
            np.testing.assert_allclose(h["loss"], j["loss"], rtol=1e-5)
            np.testing.assert_allclose(h["gnorm"], j["gnorm"], rtol=1e-5)
    assert sorted(res["params"]) == sorted(jparams)
    for name, v in jparams.items():
        np.testing.assert_allclose(res["params"][name], v.numpy(), rtol=0,
                                   atol=tol, err_msg=name)


@pytest.mark.parametrize("world", [2, 4])
def test_data_parallel_updates_match_jax(worlds, setup, world):
    """The same three updates against JAX's one-device make_train_step
    (update_freq 2, the NaN rows skipped there too)."""
    _hold_to_jax(worlds[world][0]["dp"], *setup["jax_dp"][world])


def test_tensor_parallel_step_matches_jax_param_shardings(worlds, setup):
    """(data 2 x model 2): fc1 / fc2 / emb_to_key_value sharded over
    `model`.  One accumulation over the batch: the loss rtol 1e-6 and
    every whole gradient (the slices' all-gathered) within 1e-5 of its
    largest entry against the one process.  Then two updates: every
    rank's whole parameters are equal, and the updates match the one
    process and JAX's step with param_shardings on a (2, 2) mesh."""
    ranks = [r["tp"] for r in worlds[4]]
    res = ranks[0]
    np.testing.assert_allclose(res["loss"], res["ref_loss"], rtol=1e-6)
    assert sorted(res["grads"]) == sorted(res["ref_grads"])
    assert mc.grads_err(res["grads"], res["ref_grads"]) <= 1e-5
    for r in ranks[1:]:
        for name, v in ranks[0]["params"].items():
            assert np.array_equal(r["params"][name], v), name
    lines = []
    mc.check_updates(ranks[0], [0.0, 0.0], lines, "tp")
    _hold_to_jax(ranks[0], *setup["jax_tp"])


@pytest.mark.parametrize("case, world", [("dp", 2), ("dp", 4), ("tp", 4)])
def test_accumulated_gradients_match_jax(worlds, setup, case, world):
    """The data-parallel and the (data 2 x model 2) accumulation's summed
    loss (rtol 1e-5) and whole gradients (within 1e-4 of each one's
    largest entry, the port's whole-model tolerance against JAX,
    tests/test_torch_port_asr.py) against JAX's gradient of the batch on
    one device.  Not against its param_shardings gradient on the (2, 2)
    mesh: there the conv-pos weight-norm gradients (g, v), which a Pallas
    call computes, come out up to twice JAX's own one-device ones."""
    res = worlds[world][0][case]
    jloss, jgrads = setup["jax_grads"]
    np.testing.assert_allclose(res["loss"], jloss, rtol=1e-5)
    assert sorted(res["grads"]) == sorted(jgrads)
    errs = mc.grads_errs(res["grads"], {k: v.numpy() for k, v in
                                        jgrads.items()})
    assert max(errs.values()) <= 1e-4, mc.worst(errs, 8)


@pytest.mark.parametrize("world", [2, 4])
def test_validation_over_two_nodes_equals_one_process(worlds, world):
    """cli/train's validation with the ranks laid out as two nodes, each
    reading its manifest shard (6 utterances: one batch of 8 rows, 2 of
    them padding) and splitting its rows over its ranks: the rows scored
    (their reference and hypothesis texts) exactly the one process's,
    the WER equal and the loss rtol 1e-6."""
    res = worlds[world][0]["nodes"]
    assert len(res["ref_texts"]) == 2 * NODE_ROWS
    assert res["texts"] == res["ref_texts"]
    assert res["valid"]["wer"] == res["ref_valid"]["wer"]
    np.testing.assert_allclose(res["valid"]["loss"],
                               res["ref_valid"]["loss"], rtol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["cif", "mma"])
def test_sharded_serving_tokens_equal_one_process_and_jax(worlds, setup,
                                                          world, kind):
    """The fused chunk step over 8 sessions split over the data ranks:
    tokens and counts exactly the one-process batch's and JAX's."""
    res = worlds[world][0][kind]
    jt, jn = setup["stream"][kind]["jax"]
    np.testing.assert_array_equal(res["n_tokens"], res["ref_n_tokens"])
    np.testing.assert_array_equal(res["tokens"], res["ref_tokens"])
    np.testing.assert_array_equal(res["n_tokens"], jn)
    np.testing.assert_array_equal(res["tokens"], jt)
    assert res["n_tokens"].sum() > 0
    for r in worlds[world][1:]:
        np.testing.assert_array_equal(r[kind]["tokens"], res["tokens"])


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_bleu_and_wer_sum_to_the_corpus_score(worlds, world):
    """cli/generate's greedy decode of manifest shards: the statistics
    summed over the ranks equal the unsharded pass's, and their BLEU / WER
    equal sacrebleu's corpus BLEU and the JAX package's WER on the
    decoded texts."""
    from simulst_tpu_torch.decode.scoring import scores_from_stats
    res = worlds[world][0]["eval"]
    np.testing.assert_array_equal(res["stats"], res["ref_stats"])
    assert res["stats"][-1] == 16
    scores = scores_from_stats(torch.as_tensor(res["stats"]))
    np.testing.assert_allclose(scores["bleu"], jscoring.corpus_bleu(
        res["refs"], res["hyps"]), rtol=1e-12)
    np.testing.assert_allclose(scores["wer"], jscoring.wer(
        res["refs"], res["hyps"]), rtol=1e-12)


@pytest.mark.parametrize("num_shards", [2, 3])
def test_make_batches_shards_equal_jax(setup, num_shards):
    """make_batches(num_shards, shard_id) yields JAX's batches, id for id
    and array for array."""
    rows, symbols = setup["eval_rows"], setup["symbols"]
    tcfg = tds.BatcherConfig(max_tokens=300, shuffle=False, cmvn="none")
    jcfg = jds.BatcherConfig(max_tokens=300, shuffle=False, cmvn="none")
    tds_ = tds.SpeechDataset(rows, TVocab(symbols), tcfg, "tgt_text")
    jds_ = jds.SpeechDataset(rows, JVocab(symbols), jcfg, "tgt_text")
    seen = []
    for sid in range(num_shards):
        got = list(tds.make_batches(tds_, num_shards=num_shards,
                                    shard_id=sid))
        want = list(jds.make_batches(jds_, num_shards=num_shards,
                                     shard_id=sid))
        assert [b["ids"] for b in got] == [b["ids"] for b in want]
        for g, w in zip(got, want):
            for k in ("feats", "feat_lengths", "target", "prev_tokens"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        seen += [i for b in got for i in b["ids"]]
    assert sorted(seen) == sorted(r["id"] for r in rows)
