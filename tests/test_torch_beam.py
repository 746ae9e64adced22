"""PyTorch port: beam search, decoding graphs and lattices against the JAX
reference.

- ``TokenTrie`` tables, ``make_bias_vector``, the OpenFST importer: equal to
  the reference's, exactly;
- ``topk_first``: the first-index order of ``jax.lax.top_k``, on inputs
  full of ties;
- ``beam_decode`` at the ``tiny`` preset in f32, with and without a bias
  and a (weighted) graph, and on the reference's scripted lattices: the
  backtrace arrays are identical and pool scores agree within 1e-5
  absolute / 1e-6 relative (f32 summation order);
- ``backtrace``, ``timed_nbest`` and ``lattice_from_trace`` on the same
  trace: identical results;
- ``beam_loop_reference`` (the beam kernel's plain version) in bf16 against
  ``beam_loop_pallas(..., interpret=True)``: the same rounding points, so the
  same decisions (see :func:`test_bf16_reference_matches_pallas`).
"""

import itertools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from amira_rust_asr_server_tpu.models import Transducer as JaxTransducer
from amira_rust_asr_server_tpu.ops import beam as jb
from amira_rust_asr_server_tpu.ops import fst_io as jfst
from amira_rust_asr_server_tpu.ops import lattice as jlat
from amira_rust_asr_server_tpu.ops.pallas.beam_loop import beam_loop_pallas
from amira_rust_asr_server_tpu.vocab import Vocabulary as JaxVocabulary
from amira_rust_asr_server_tpu_torch.convert import from_jax_params
from amira_rust_asr_server_tpu_torch.models import Transducer
from amira_rust_asr_server_tpu_torch.ops import beam as tb
from amira_rust_asr_server_tpu_torch.ops import fst_io as tfst
from amira_rust_asr_server_tpu_torch.ops import lattice as tlat
from amira_rust_asr_server_tpu_torch.ops.kernels.beam_loop import (
    beam_loop, beam_loop_reference)
from amira_rust_asr_server_tpu_torch.ops.kernels.decode_loop import \
    DecodeWeights
from amira_rust_asr_server_tpu_torch.vocab import Vocabulary

torch.set_num_threads(2)
ATOL, RTOL = 1e-5, 1e-6
TRACE_FIELDS = ("pool_lens", "exp_parent", "exp_token", "pool_parent_s",
                "pool_parent_k", "pool_final")


def assert_same_trace(got: tb.BeamTrace, want) -> None:
    g = got.numpy()
    for f in TRACE_FIELDS:
        np.testing.assert_array_equal(getattr(g, f),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(g.pool_scores, np.asarray(want.pool_scores),
                               atol=ATOL, rtol=RTOL)


def assert_same_result(got: tb.BeamResult, want) -> None:
    np.testing.assert_array_equal(got.counts, np.asarray(want.counts))
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_allclose(got.scores, np.asarray(want.scores),
                               atol=ATOL, rtol=RTOL)
    assert (got.n_best is None) == (want.n_best is None)
    for lg, lw in zip(got.n_best or [], want.n_best or []):
        assert [s for _, s in lg] == [s for _, s in lw]
        np.testing.assert_allclose([x for x, _ in lg], [x for x, _ in lw],
                                   atol=ATOL, rtol=RTOL)


def trie_tables(trie):
    return [np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()
            for x in (trie.next_state, trie.is_final, trie.arc_weight,
                      trie.final_weight)]


# -- decoding graphs, bias, top-k ---------------------------------------------
DIGITS_MAP = {0: "▁one", 1: "▁two", 2: "▁t", 3: "wo", 4: "▁three", 5: "▁on",
              6: "e"}
# each side gets its own package's vocabulary, made from the same map
DIGITS = {tb: Vocabulary.from_map(DIGITS_MAP),
          jb: JaxVocabulary.from_map(DIGITS_MAP)}
TRIE_CASES = {
    "phrases": lambda m: m.TokenTrie.from_phrases(
        DIGITS[m], ["one", "two", "three one"], 9),
    "phrases_no_loop": lambda m: m.TokenTrie.from_phrases(
        DIGITS[m], ["one two", "three"], 9, loop=False),
    "weighted_phrases": lambda m: m.TokenTrie.from_phrases(
        DIGITS[m], ["one", "two", "three two"], 9,
        weights=[-0.5, 0.25, -2.0]),
    "prefix_phrases": lambda m: m.TokenTrie.from_token_seqs(
        [[1, 2], [1, 2, 3], [1], [4], [1, 2]], 7,
        weights=[-1.0, 0.5, -0.25, 2.0, -3.0],
        final_weights=[0.1, 0.2, 0.3, 0.4, 0.5]),
    "from_tables": lambda m: m.TokenTrie.from_tables(
        [[1, -1, 2], [-1, 0, -1], [2, 2, -1]], [False, True, True],
        arc_weight=[[0.5, 0, -1], [0, 0.25, 0], [1, 2, 0]],
        final_weight=[0, -0.5, 1.5]),
    "from_tables_unweighted": lambda m: m.TokenTrie.from_tables(
        [[1, -1], [-1, 0]], [False, True]),
}


@pytest.mark.parametrize("case", list(TRIE_CASES))
def test_token_trie_tables_match(case):
    got, want = TRIE_CASES[case](tb), TRIE_CASES[case](jb)
    for g, w in zip(trie_tables(got), trie_tables(want)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got.n_states == want.n_states
    assert got.weighted == want.weighted


def test_make_bias_vector_matches_on_real_vocab():
    phrases = ["hello world", "The Cat sat", "  amira  "]
    got = tb.make_bias_vector(Vocabulary.load("model-repo/vocab.txt"),
                              phrases, 2.5, 1030)
    want = np.asarray(jb.make_bias_vector(
        JaxVocabulary.load("model-repo/vocab.txt"), phrases, 2.5, 1030))
    assert got.dtype == torch.float32 and (got.numpy() > 0).sum() > 10
    np.testing.assert_array_equal(got.numpy(), want)


def kpass_topk(x: np.ndarray, k: int):
    """K passes of (max, smallest index of the max): the definition."""
    x = x.astype(np.float64).copy()
    vals, idxs = [], []
    for _ in range(k):
        i = np.argmax(x, axis=-1)  # numpy's argmax takes the first index
        vals.append(np.take_along_axis(x, i[:, None], 1)[:, 0])
        idxs.append(i)
        np.put_along_axis(x, i[:, None], -np.inf, 1)
    return np.stack(vals, -1), np.stack(idxs, -1)


@pytest.mark.parametrize("k", [1, 3, 10])
def test_topk_first_breaks_ties_by_first_index(k):
    rng = np.random.default_rng(k)
    x = rng.choice([2 * tb.NEG_INF, tb.NEG_INF, -1.0, 0.5, 2.0],
                   size=(6, 40)).astype(np.float32)
    x[0] = tb.NEG_INF                     # a lane of dead hypotheses
    vals, idx = tb.topk_first(torch.from_numpy(x), k)
    want_v, want_i = kpass_topk(x, k)
    np.testing.assert_array_equal(idx.numpy(), want_i)
    np.testing.assert_array_equal(vals.numpy(), want_v.astype(np.float32))
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))


# -- scripted lattices (as tests/test_beam.py) ---------------------------------
BLANK, VOCAB = 3, 4


def one_hot_joint(xp):
    """20 x one-hot of the frame's token, blank once the hypothesis has
    emitted it."""
    def joint(enc_frame, pred_out):
        if xp is jnp:
            want = enc_frame[:, 0].astype(jnp.int32)
            done = pred_out[:, 0].astype(jnp.int32) == want
            return 20.0 * jax.nn.one_hot(jnp.where(done, BLANK, want), VOCAB)
        want = enc_frame[:, 0].long()
        done = pred_out[:, 0].long() == want
        return 20.0 * F.one_hot(torch.where(done, BLANK, want), VOCAB).float()
    return joint


def garden_joint(xp):
    lp = np.log(np.array([
        [1e-6, 0.98, 1e-6, 0.01], [1e-6, 1e-6, 0.04, 0.95],
        [0.5, 0.45, 1e-6, 0.05], [0.5, 0.45, 1e-6, 0.05]], np.float32))

    def joint(enc_frame, pred_out):
        if xp is jnp:
            return jnp.asarray(lp)[jnp.clip(pred_out[:, 0].astype(jnp.int32),
                                            0, 3)]
        return torch.from_numpy(lp)[pred_out[:, 0].long().clamp(0, 3)]
    return joint


def fake_pred(xp):
    def pred(tokens, state):
        if xp is jnp:
            return tokens[:, None].astype(jnp.float32), state
        return tokens[:, None].float(), state
    return pred


SCRIPTED = {
    "peaked": (one_hot_joint, [[0, 2, 1, 0]], [4], 4, 3),
    "garden_path": (garden_joint, [[0, 0]], [2], 4, 2),
    "ragged": (one_hot_joint, [[0, 1, 2, 0, 1]] * 2, [5, 2], 4, 3),
    "zero_length_lane": (one_hot_joint, [[0, 1, 2]] * 2, [3, 0], 4, 3),
}


@pytest.mark.parametrize("case", list(SCRIPTED))
def test_scripted_lattices_match(case):
    joint, frames, lens, k, s = SCRIPTED[case]
    enc = np.asarray(frames, np.float32)[:, :, None]
    lens = np.asarray(lens, np.int32)
    want = jb.beam_decode(fake_pred(jnp), joint(jnp), jnp.asarray(enc),
                          jnp.asarray(lens),
                          (jnp.zeros((1, enc.shape[0], 1)),), BLANK,
                          beam_width=k, max_expansions=s, vocab_size=VOCAB)
    got = tb.beam_decode(fake_pred(torch), joint(torch),
                         torch.from_numpy(enc), torch.from_numpy(lens),
                         (torch.zeros((1, enc.shape[0], 1)),), BLANK,
                         beam_width=k, max_expansions=s, vocab_size=VOCAB)
    assert_same_trace(got, want)
    assert_same_result(tb.backtrace(got, lens, n_best=3),
                       jb.backtrace(want, lens, n_best=3))


# -- the tiny model ---------------------------------------------------------
@pytest.fixture(scope="module")
def tiny():
    jm = JaxTransducer.from_preset("tiny")
    params = jm.init(jax.random.PRNGKey(0))
    params["joint"]["out"]["b"] = (
        params["joint"]["out"]["b"].at[jm.config.blank_id].add(1.0))
    model = Transducer(jm.config)
    model.load_state_dict(from_jax_params(jax.device_get(params), jm.config))
    return jm, params, model.eval()


def tiny_inputs(cfg, b=3, t=9, seed=0):
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((b, t, cfg.d_enc)).astype(np.float32)
    lens = np.array([t, t - 4, 0, t - 1][:b], np.int32)
    bias = (rng.standard_normal(cfg.vocab_size) * 0.5).astype(np.float32)
    seqs = [[0, 1], [2], [3, 4, 5], [1, 2]]
    weights = rng.standard_normal(4).tolist()
    final_weights = rng.standard_normal(4).tolist()
    return enc, lens, bias, seqs, weights, final_weights


BEAM_CASES = {"plain": (False, None), "bias": (True, None),
              "graph": (False, "graph"), "weighted_graph": (True, "weighted")}


def run_both(jm, params, model, case, k=4, s=3, seed=0):
    """The same inputs through the reference's beam_decode and the port's."""
    use_bias, gmode = BEAM_CASES[case]
    cfg = jm.config
    enc, lens, bias, seqs, w, fw = tiny_inputs(cfg, seed=seed)
    jg = tg = None
    if gmode:
        kw = dict(weights=w, final_weights=fw) if gmode == "weighted" else {}
        jg = jb.TokenTrie.from_token_seqs(seqs, cfg.vocab_size, **kw)
        tg = tb.TokenTrie.from_token_seqs(seqs, cfg.vocab_size, **kw)
    want = jb.beam_decode(
        partial(jm.predict_step, params), partial(jm.joint_step_pre, params),
        jm.joint_precompute_enc(params, jnp.asarray(enc)), jnp.asarray(lens),
        jm.init_state(enc.shape[0]), cfg.blank_id, beam_width=k,
        max_expansions=s, bias=jnp.asarray(bias) if use_bias else None,
        vocab_size=cfg.vocab_size, graph=jg)
    with torch.no_grad():
        got = tb.beam_decode(
            model.predict_step, model.joint_step_pre,
            model.joint_precompute_enc(torch.from_numpy(enc)),
            torch.from_numpy(lens), model.init_state(enc.shape[0]),
            cfg.blank_id, beam_width=k, max_expansions=s,
            bias=torch.from_numpy(bias) if use_bias else None,
            vocab_size=cfg.vocab_size, graph=tg)
    return got, want, lens


@pytest.mark.parametrize("case", list(BEAM_CASES))
def test_beam_decode_matches_jax(tiny, case):
    got, want, lens = run_both(*tiny, case)
    assert_same_trace(got, want)
    assert_same_result(tb.backtrace(got, lens, n_best=3),
                       jb.backtrace(want, lens, n_best=3))


def test_beam_decode_transducer_matches_jax(tiny):
    jm, params, model = tiny
    enc, lens, bias, *_ = tiny_inputs(jm.config, seed=6)
    want = jb.beam_decode_transducer(
        jm, params, jnp.asarray(enc), jnp.asarray(lens), beam_width=4,
        bias=jnp.asarray(bias), n_best=2, length_penalty=0.5)
    with torch.no_grad():
        got = tb.beam_decode_transducer(
            model, torch.from_numpy(enc), torch.from_numpy(lens),
            beam_width=4, bias=torch.from_numpy(bias), n_best=2,
            length_penalty=0.5)
    assert_same_result(got, want)


@pytest.mark.parametrize("kw", [dict(n_best=4), dict(max_total=2),
                                dict(n_best=2, length_penalty=0.6),
                                dict(n_best=1)])
def test_backtrace_matches_jax(tiny, kw):
    """On the reference's own trace: n-best order, the zero-length lane
    (lane 2), the max_total budget and length normalization."""
    _, want, lens = run_both(*tiny, "weighted_graph", seed=1)
    host = tb.BeamTrace(*(np.asarray(getattr(want, f))
                          for f in ("pool_scores",) + TRACE_FIELDS))
    got = tb.backtrace(host, lens, **kw)
    ref = jb.backtrace(want, lens, **kw)
    assert_same_result(got, ref)
    assert got.counts[2] == 0
    if "max_total" in kw:
        assert got.tokens.shape[1] == 2


@pytest.mark.parametrize("n_best", [1, 4])
def test_timed_nbest_and_lattice_match_jax(tiny, n_best):
    got, want, lens = run_both(*tiny, "bias", seed=2)
    tg = tlat.timed_nbest(got, lens, n_best=n_best)
    tw = jlat.timed_nbest(want, lens, n_best=n_best)
    assert [[p for _, p in lane] for lane in tg] == \
        [[p for _, p in lane] for lane in tw]
    for lg, lw in zip(tg, tw):
        np.testing.assert_allclose([x for x, _ in lg], [x for x, _ in lw],
                                   atol=ATOL, rtol=RTOL)
    words = {i: f"▁w{i}" for i in range(16)}
    vocab, jvocab = Vocabulary.from_map(words), JaxVocabulary.from_map(words)
    for lg, lw in zip(tlat.lattice_from_trace(got, lens, n_best=n_best),
                      jlat.lattice_from_trace(want, lens, n_best=n_best)):
        assert (lg.n_nodes, lg.arcs) == (lw.n_nodes, lw.arcs)
        assert [n for n, _ in lg.finals] == [n for n, _ in lw.finals]
        np.testing.assert_allclose([x for _, x in lg.finals],
                                   [x for _, x in lw.finals], atol=ATOL,
                                   rtol=RTOL)
        dg = lg.to_dict(vocab=vocab, sec_per_frame=0.04)
        dw = lw.to_dict(vocab=jvocab, sec_per_frame=0.04)
        assert {k: dg[k] for k in dg if k != "finals"} == \
            {k: dw[k] for k in dw if k != "finals"}


def test_lattice_merge_matches_jax():
    paths = [(-1.0, [(0, 0), (1, 1), (2, 2)]), (-2.0, [(0, 0), (1, 1), (1, 2)]),
             (-3.0, [(2, 0)]), (-0.5, [(2, 0)])]
    got, want = tlat.lattice_from_timed(paths), jlat.lattice_from_timed(paths)
    assert (got.n_nodes, got.arcs, got.finals) == \
        (want.n_nodes, want.arcs, want.finals)
    assert got.paths() == want.paths()


# -- the OpenFST importer (texts of tests/test_fst_io.py) ---------------------
FST_TEXTS = {
    "acceptor": ("0 1 1 0.5\n1 2 2 0.25\n2 0.125", {}),
    "unweighted": ("0 1 3\n1", {}),
    "transducer": ("0 1 1 7 0.5\n1 2 2 8\n2", {}),
    "start_not_zero": ("3 1 2\n1 0.0", {}),
    "comments": ("# decoding graph\n\n0 1 1\n# done\n1\n", {}),
    "duplicate_finals": ("0 1 1\n1 2.0\n1 0.5", {}),
    "epsilon": ("0 1 0 1.0\n1 2 2 0.5\n2", dict(eps_id=0)),
    "epsilon_zero_cycle": ("0 1 0 0.0\n1 0 0 0.0\n1 2 1 0.5\n2",
                           dict(eps_id=0)),
    "nondeterministic": ("0 1 1 0.5\n0 2 1 0.1\n1 3 2 0.1\n2 3 2 0.9\n3 0.0",
                         {}),
    "lexicon": ("0 1 1 0.0\n1 4 2 0.5\n0 2 2 0.0\n2 3 2 -0.25\n1 1.0\n"
                "4 0.0\n3 0.0", {}),
}


@pytest.mark.parametrize("case", list(FST_TEXTS))
def test_openfst_text_matches_jax(case):
    text, kw = FST_TEXTS[case]
    got = tfst.token_trie_from_openfst_text(text, vocab_size=4, **kw)
    want = jfst.token_trie_from_openfst_text(text, vocab_size=4, **kw)
    for g, w in zip(trie_tables(got), trie_tables(want)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("text, kw", [
    ("", {}), ("0 1 x", {}), ("0 1 1 2 3 4", {}), ("0 1 9\n1", {}),
    ("0 1 1\n1 abc", {}), ("0 1 0 -1.0\n1 0 0 0.0\n1 2 1\n2", dict(eps_id=0))])
def test_openfst_errors_match_jax(text, kw):
    with pytest.raises(jfst.FstFormatError) as want:
        jfst.token_trie_from_openfst_text(text, vocab_size=4, **kw)
    with pytest.raises(tfst.FstFormatError) as got:
        tfst.token_trie_from_openfst_text(text, vocab_size=4, **kw)
    assert str(got.value) == str(want.value)


def test_openfst_file_and_symbols_match_jax(tmp_path):
    fst = tmp_path / "graph.fst.txt"
    fst.write_text("0 1 1 0.5\n1 2 2\n2\n0 3 0 0.25\n3 2 2 1.0\n",
                   encoding="utf-8")
    (tmp_path / "graph.syms").write_text("<eps> 0\n▁a 1\n▁b 2\n",
                                         encoding="utf-8")
    words = {0: "▁a", 1: "▁b"}
    got = tfst.token_trie_from_openfst_file(
        str(fst), vocab_size=3, vocab=Vocabulary.from_map(words))
    want = jfst.token_trie_from_openfst_file(
        str(fst), vocab_size=3, vocab=JaxVocabulary.from_map(words))
    for g, w in zip(trie_tables(got), trie_tables(want)):
        np.testing.assert_array_equal(g, w)
    assert tfst.load_symbols(str(tmp_path / "graph.syms")) == \
        jfst.load_symbols(str(tmp_path / "graph.syms"))


# -- the beam kernel's plain version against the TPU kernel --------------------
def pallas_trace(jm, params, enc_pre, lens, bias, graph, k, s):
    h, c = jm.init_state(enc_pre.shape[0])
    outs = beam_loop_pallas(enc_pre, jnp.asarray(lens), h, c,
                            jnp.asarray(bias), params["predictor"],
                            params["joint"], beam_width=k, max_expansions=s,
                            blank_id=jm.config.blank_id, graph=graph,
                            interpret=True)
    scores, plens, expp, expt, pps, ppk = outs[:6]
    if graph is not None:
        g_f = outs[6]
        fin = graph.is_final[g_f]
        return jb.BeamTrace(
            pool_scores=scores + jnp.where(fin & (plens > 0),
                                           graph.final_weight[g_f], 0.0),
            pool_lens=plens, exp_parent=expp, exp_token=expt,
            pool_parent_s=pps, pool_parent_k=ppk,
            pool_final=fin | ((plens == 0) & graph.is_final[0]))
    return jb.BeamTrace(pool_scores=scores, pool_lens=plens, exp_parent=expp,
                        exp_token=expt, pool_parent_s=pps, pool_parent_k=ppk,
                        pool_final=jnp.ones(scores.shape, bool))


@pytest.mark.parametrize("variant", ["bias", "graph"])
def test_bf16_reference_matches_pallas(tiny, variant):
    """bf16, the served type, beam 3, S=2, 6 frames: the kernel's plain
    version against the TPU kernel (interpret mode) on the same bf16
    ``enc_pre``. Both accumulate in f32 and round h, c, pred_out and the
    joint hidden vector to bf16 at the same points, so every backtrace
    array and the n-best are identical; pool scores agree within 1e-5
    relative / 1e-4 absolute (f32 summation order over bf16 inputs; equal
    to the bit here). A mutation check (the joint hidden vector left
    unrounded in the plain version) fails this test."""
    jm, params, model = tiny
    cfg = jm.config
    k, s = 3, 2
    enc, lens, bias, seqs, w, fw = tiny_inputs(cfg, b=3, t=6, seed=4)
    enc_pre = jm.joint_precompute_enc(params, jnp.asarray(enc)).astype(
        jnp.bfloat16)
    jg = tg = None
    if variant == "graph":
        jg = jb.TokenTrie.from_token_seqs(seqs, cfg.vocab_size, weights=w,
                                          final_weights=fw)
        tg = tb.TokenTrie.from_token_seqs(seqs, cfg.vocab_size, weights=w,
                                          final_weights=fw)
    want = pallas_trace(jm, params, enc_pre, lens, bias, jg, k, s)
    zeros = torch.zeros((2, 3, cfg.d_pred), dtype=torch.bfloat16)
    outs = beam_loop(
        torch.from_numpy(np.array(enc_pre, np.float32)).bfloat16(),
        torch.from_numpy(lens), zeros, zeros, torch.from_numpy(bias),
        DecodeWeights.from_model(model, torch.bfloat16), beam_width=k,
        max_expansions=s, blank_id=cfg.blank_id, graph=tg)
    got = tb.finish_trace(*outs, graph=tg).numpy()
    for f in TRACE_FIELDS:
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(got.pool_scores, np.asarray(want.pool_scores),
                               rtol=1e-5, atol=1e-4)
    rg = tb.backtrace(got, lens, n_best=3)
    rw = jb.backtrace(want, lens, n_best=3)
    np.testing.assert_array_equal(rg.tokens, rw.tokens)
    assert [[q for _, q in lane] for lane in rg.n_best] == \
        [[q for _, q in lane] for lane in rw.n_best]
    assert any(seq for lane in rg.n_best for _, seq in lane)


def test_f32_reference_matches_beam_decode(tiny):
    """In f32 the kernel's plain version is the model's own arithmetic: its
    trace equals the reference's XLA beam."""
    jm, params, model = tiny
    cfg = jm.config
    enc, lens, bias, *_ = tiny_inputs(cfg, seed=5)
    got, want, _ = run_both(jm, params, model, "bias", seed=5)
    zeros = torch.zeros((2, enc.shape[0], cfg.d_pred))
    with torch.no_grad():
        outs = beam_loop_reference(
            model.joint_precompute_enc(torch.from_numpy(enc)),
            torch.from_numpy(lens), zeros, zeros, torch.from_numpy(bias),
            DecodeWeights.from_model(model, torch.float32), beam_width=4,
            max_expansions=3, blank_id=cfg.blank_id)
    assert_same_trace(tb.finish_trace(*outs), want)
    assert outs[6].abs().sum() == 0   # no graph: every state is the root


def test_beam_loop_rejects_unsupported_device(tiny):
    _, _, model = tiny
    w = DecodeWeights.from_model(model, torch.float32)
    x = torch.zeros((1, 2, model.config.d_joint), device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        beam_loop(x, torch.ones(1), x, x, x, w, beam_width=2,
                  max_expansions=1, blank_id=model.config.blank_id)


def test_kpass_definition_is_exhaustive():
    """The oracle itself: on every 0/1 vector of length 6, k passes of
    (max, first index) give the stable descending order."""
    for bits in itertools.product([0.0, 1.0], repeat=6):
        x = np.asarray([bits], np.float32)
        _, idx = kpass_topk(x, 6)
        assert idx[0].tolist() == sorted(range(6), key=lambda i: -bits[i])
