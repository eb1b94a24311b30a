"""The MMA serving step of simulst_tpu_torch vs the JAX package, on the
CPU: `mma_decoder_step` with `adopt_on_read` token for token at B = 2,
one example READing while the other WRITEs (the per-example rollback of
the in-place KV caches), and the fused chunk step against the step-wise
loop it replaces.

Small model: 2 decoder layers (1 encoder layer for the fused step), width
16, 2 heads, FFN 32, vocab 24, fixed pre-decision ratio 2, wait-k lagging
2, unscaled token embeddings; JAX init bridged to the port
(compat/jax_bridge.load_jax_params), the final layer norm's scale drawn at
random (N(0, 9)) so that greedy tokens do not just repeat the previous one
through the shared embedding, and EOS's row shrunk so that EOS does not
win every step; fp32 with
jax_default_matmul_precision float32 (tests/conftest.py); no dropout, no
noise.  Tolerances: actions, tokens, cache counts and head positions
exactly; logits atol 1e-4, rtol 1e-4.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each
import jax.numpy as jnp  # noqa: E402

from simulst_tpu.models import mma as jmma  # noqa: E402
from simulst_tpu.stream import fused as jfused  # noqa: E402
from simulst_tpu_torch.compat.jax_bridge import load_jax_params  # noqa: E402
from simulst_tpu_torch.models import mma as tmma  # noqa: E402
from simulst_tpu_torch.models import s2t_emformer as ts2t  # noqa: E402
from simulst_tpu_torch.stream import fused as tfused  # noqa: E402

CFG = dict(vocab_size=24, input_feat=8, conv_channels=16, embed_dim=16,
           ffn_dim=32, encoder_layers=1, encoder_heads=2, decoder_layers=2,
           decoder_heads=2, decoder_ffn_dim=32, segment_length=16,
           left_context=32, right_context=8, max_memory=2,
           max_target_positions=64, dropout=0.0, attention_dropout=0.0,
           activation_dropout=0.0, waitk_lagging=2,
           fixed_pre_decision_ratio=2, no_scale_embedding=True)
EOS = 2
# variant, "+no_mass_preservation" where mass preservation is off
VARIANTS = ["waitk_fixed_pre_decision", "infinite_lookback_fixed_pre_decision",
            "hard_aligned", "chunkwise_fixed_pre_decision",
            "waitk+no_mass_preservation"]


def _pair(variant):
    """(JAX config, JAX params, port config, port model) with one init."""
    variant, _, flag = variant.partition("+")
    kw = dict(CFG, simul_attn_type=variant,
              mass_preservation=flag != "no_mass_preservation")
    jcfg = jmma.MMAConfig(**kw)
    jp = jmma.MMAModel(jcfg).init(jax.random.PRNGKey(0))
    emb = jp["decoder"]["embed_tokens"]["weight"]
    jp["decoder"]["embed_tokens"]["weight"] = emb.at[EOS].multiply(0.1)
    jp["decoder"]["layer_norm"]["scale"] = jnp.asarray(
        np.random.RandomState(3).randn(16).astype(np.float32) * 3.0)
    model = tmma.MMAModel(tmma.MMAConfig(**kw), device="cpu")
    model.load_state_dict(load_jax_params(jax.tree_util.tree_map(np.asarray,
                                                                 jp)))
    return jcfg, jp, model.cfg, model.eval()


def test_where_b_and_append_rows_match_jax():
    rng = np.random.RandomState(0)
    buf, new = rng.randn(3, 7, 4).astype(np.float32), \
        rng.randn(3, 3, 4).astype(np.float32)
    buf_len, n_new = np.array([0, 5, 6]), np.array([3, 2, 3])
    want = jfused._append_rows(*map(jnp.asarray, (buf, buf_len, new, n_new)))
    got = tfused._append_rows(*map(torch.from_numpy, (buf, buf_len, new,
                                                      n_new)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    mask = np.array([True, False, True])
    np.testing.assert_array_equal(
        tfused._where_b(torch.from_numpy(mask), torch.from_numpy(new),
                        torch.from_numpy(new[::-1].copy())).numpy(),
        np.asarray(jfused._where_b(jnp.asarray(mask), jnp.asarray(new),
                                   jnp.asarray(new[::-1].copy()))))


@pytest.mark.parametrize("variant", VARIANTS)
def test_decoder_step_rollback_matches_jax(variant):
    """Two examples over a growing 24-frame encoder buffer (example 1 with
    less source than example 0), then a final offline round: each attempt
    runs mma_decoder_step on both; an example WRITEs its token or, on READ
    or a premature EOS, keeps its old state but for the monotonic part
    (adopt_on_read), selected per example.  Actions, tokens, cache counts
    and head positions equal JAX's exactly, logits atol 1e-4."""
    jcfg, jp, tcfg, model = _pair(variant)
    jstep = jax.jit(jmma.mma_decoder_step, static_argnums=(1, 6))
    rng = np.random.RandomState(1)
    key_buf = rng.randn(2, 24, 16).astype(np.float32)
    schedule = [(6, 2), (10, 4), (14, 8), (18, 16), (24, 24)]
    jstate = jmma.mma_decoder_init_state(jcfg, 2, 16)
    tstate = tmma.mma_decoder_init_state(tcfg, 2, 16)
    tokens, finished = [[], []], [False, False]
    mixed = 0          # attempts where one example READs and the other WRITEs
    for rnd, lens in enumerate(schedule):
        online = rnd < len(schedule) - 1
        stopped = [False, False]
        for _ in range(8):
            active = np.array([not finished[i] and not stopped[i]
                               and len(tokens[i]) < 15 for i in range(2)])
            if not active.any():
                break
            prev = np.array([t[-1] if t else EOS for t in tokens])
            jl, ja, jnew = jstep(jp["decoder"], jcfg, jstate,
                                 jnp.asarray(prev), jnp.asarray(key_buf),
                                 jnp.asarray(lens), online)
            with torch.no_grad():
                tl, ta, tnew = tmma.mma_decoder_step(
                    model.decoder, tcfg, tstate, torch.from_numpy(prev),
                    torch.from_numpy(key_buf), torch.tensor(lens), online)
            np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                       rtol=1e-4)
            tok = np.asarray(jl).argmax(-1)
            np.testing.assert_array_equal(tl.numpy().argmax(-1), tok)
            premature = (tok == EOS) & online
            write = active & (np.asarray(ja) == 1) & ~premature
            mixed += int(write.any() and (active & ~write).any())
            jstate = jfused._where_b(jnp.asarray(write), jnew, jfused._where_b(
                jnp.asarray(active), jmma.adopt_on_read(jstate, jnew),
                jstate))
            tw, ta_ = torch.from_numpy(write), torch.from_numpy(active)
            tstate = tfused._where_b(tw, tnew, tfused._where_b(
                ta_, tmma.adopt_on_read(tstate, tnew), tstate))
            for i in range(2):
                if write[i]:
                    tokens[i].append(int(tok[i]))
                    finished[i] = finished[i] or tok[i] == EOS
                stopped[i] = stopped[i] or (active[i] and not write[i]) \
                    or (write[i] and tok[i] == EOS)
        for jc, tc in zip(jstate.caches, tstate.caches):
            np.testing.assert_array_equal(tc.length.numpy(),
                                          np.asarray(jc.length))
        for jm, tm in zip(jstate.monotonic, tstate.monotonic):
            np.testing.assert_array_equal(tm.head_step.numpy(),
                                          np.asarray(jm.head_step))
        np.testing.assert_array_equal(tstate.step.numpy(),
                                      np.asarray(jstate.step))
    assert mixed > 0 and min(map(len, tokens)) > 1, (mixed, tokens)


def _stepwise(model, cfg, chunks, max_src=64, max_tokens=32):
    """The host-driven step-by-step session of one utterance (the loop of
    tests/test_fused_stream.py's mma_reference_loop)."""
    enc_state = ts2t.encoder_init_state(model.encoder, cfg, 1)
    dec = tmma.mma_decoder_init_state(cfg, 1, max_tokens)
    enc_buf = torch.zeros(1, max_src, cfg.embed_dim)
    src_len, tokens, finished = 0, [], False
    for i, ch in enumerate(chunks):
        finish = i == len(chunks) - 1
        out, enc_state = ts2t.encoder_step(model.encoder, cfg, enc_state, ch,
                                           finish)
        n = out.encoder_out.shape[1]
        enc_buf[:, src_len:src_len + n] = out.encoder_out
        src_len += n
        while not finished and len(tokens) < max_tokens - 1:
            prev = torch.tensor([tokens[-1] if tokens else EOS])
            logits, action, new = tmma.mma_decoder_step(
                model.decoder, cfg, dec, prev, enc_buf,
                torch.tensor([src_len]), not finish)
            tok = int(logits[0].argmax())
            if int(action[0]) == 0 or (tok == EOS and not finish):
                dec = tmma.adopt_on_read(dec, new)
                break
            dec = new
            tokens.append(tok)
            finished = tok == EOS
    return tokens


@pytest.mark.parametrize("variant", VARIANTS)
def test_fused_step_equals_stepwise(variant):
    """make_mma_fused_step on two utterances in lock-step (one chunk plan:
    24 frames, then 16 at a time, 120 in all) emits, per example, exactly
    the tokens of the step-wise loop on that utterance alone."""
    _, _, cfg, model = _pair(variant)
    feats = torch.from_numpy(np.random.RandomState(2).randn(
        2, 120, 8).astype(np.float32))
    plan = [(0, 24)] + [(t, t + 16) for t in range(24, 120, 16)]
    with torch.no_grad():
        want = [_stepwise(model, cfg, [feats[i:i + 1, a:b] for a, b in plan])
                for i in range(2)]
        step = tfused.make_mma_fused_step(model, cfg)
        state = tfused.mma_fused_init(model, cfg, max_src=64, max_tokens=32,
                                      batch=2)
        mid_stream = 0
        for k, (a, b) in enumerate(plan):
            state, n_new = step(state, feats[:, a:b],
                                finish=k == len(plan) - 1)
            mid_stream += int(n_new.sum()) if k < len(plan) - 1 else 0
    got = [state.tokens[i, :int(state.n_tokens[i])].tolist()
           for i in range(2)]
    assert got == want, (got, want)
    assert mid_stream > 0 and len(set(sum(want, []))) > 2, (mid_stream, want)
