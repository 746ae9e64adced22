"""PyTorch port: the bucket programs (``runtime/programs.py``) and the
static buffers their CUDA graphs rely on.

A bucket's program keeps its inputs and outputs in the same device memory
from one dispatch to the next, and the lane engine's chunk step updates
its cache and carry in place. These tests run the same programs on the
CPU (where the body runs on the same static buffers) and hold every case
to the JAX package's tokens, identical, f32, on the committed tiny-digits
weights or JAX-initialized tiny-streaming weights:

- one bucket, a long request then a short one: the short one decodes as
  on a fresh pipeline;
- a batch of 3 after a batch of 4 in bucket 4: real and padding lanes as
  on a fresh pipeline;
- the stream states one dispatch returns are unchanged by the next
  dispatch of the same bucket (they are the pipeline's own copies);
- the lane engine with its in-place carry: attach, tick, reset a lane,
  tick again, against solo sessions and the JAX lane engine;
- two threads, one warming buckets and one dispatching, give the tokens
  of one thread;
- decoding graphs made per call: graphs of like size share one beam
  program, each decodes as on the JAX pipeline (scores within 1e-4), and
  the pipeline keeps none of them;
- a capture's launches are recorded, not counted, and a reset on another
  thread meanwhile stays a reset.

The cases that need the card (the ``dev`` fixture skips them here) hold a
replay to the eager body on the same inputs (identical tokens, f32 and
bf16), count a replay's launches against its capture, capture on one
thread while another replays, and hold a beam replay, on the kernel's route
and on the plain scan's (a graph over 1024 states), to the eager body after
the graph it was captured with has been swapped for another. The JAX package is imported inside the
fixtures that hold the port to it, so the file also runs on a card's
machine without flax: there its CUDA cases run and the JAX-held cases skip
(here flax is present and they run).
"""

import dataclasses
import gc
import sys
import threading
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from amira_rust_asr_server_tpu_torch.config import Config
from amira_rust_asr_server_tpu_torch.convert import from_jax_params, load_npz
from amira_rust_asr_server_tpu_torch.models import Transducer
from amira_rust_asr_server_tpu_torch.models.presets import TINY_STREAMING
from amira_rust_asr_server_tpu_torch.ops import kernels
from amira_rust_asr_server_tpu_torch.ops.beam import TokenTrie
from amira_rust_asr_server_tpu_torch.runtime import AsrPipeline
from amira_rust_asr_server_tpu_torch.runtime.lane_engine import \
    StreamingLaneEngine
from amira_rust_asr_server_tpu_torch.runtime.native_stream import \
    NativeStreamSession
from amira_rust_asr_server_tpu_torch.testing import (TINY_DIGITS_NPZ,
                                                     TINY_DIGITS_VOCAB,
                                                     synth_digits)
from amira_rust_asr_server_tpu_torch.vocab import Vocabulary

torch.set_num_threads(2)
CKPT = Path(__file__).resolve().parents[1] / "model-repo" / "tiny-digits"
BUCKETS = dict(audio_sec_buckets=[2.0], batch_buckets=[1, 4],
               compute_dtype="float32")
WORDS = {i: f"▁w{i}" for i in range(15)}
END = np.zeros(0, np.float32)
NO_FLAX = "the JAX package, this case's oracle, needs flax"


@pytest.fixture(scope="module")
def jax_pipe():
    """The JAX pipeline on the same weights and buckets, f32, CPU."""
    pytest.importorskip("flax", reason=NO_FLAX)
    from amira_rust_asr_server_tpu.config import Config as JaxConfig
    from amira_rust_asr_server_tpu.models import Transducer as JaxTransducer
    from amira_rust_asr_server_tpu.runtime import AsrPipeline as JaxPipeline
    from amira_rust_asr_server_tpu.vocab import Vocabulary as JaxVocabulary
    jm = JaxTransducer.from_preset("tiny")
    return JaxPipeline(jm, jm.load_checkpoint(str(CKPT)),
                       JaxVocabulary.load(TINY_DIGITS_VOCAB),
                       JaxConfig(inference_backend="cpu", **BUCKETS))


def port_pipe(device: str = "cpu", **overrides) -> AsrPipeline:
    model = Transducer.from_preset("tiny")
    model.load_state_dict(load_npz(TINY_DIGITS_NPZ))
    backend = "cpu" if device == "cpu" else "tpu"  # "tpu": the card
    return AsrPipeline(model, Vocabulary.load(TINY_DIGITS_VOCAB),
                       Config(inference_backend=backend,
                              **{**BUCKETS, **overrides}),
                       torch.device(device))


def utterances(seed: int, words):
    rng = np.random.default_rng(seed)
    return [synth_digits(w, noise=0.004, rng=rng) for w in words]


def lanes(res, rows):
    """(tokens, frames) of ``rows``, each cut at its count."""
    counts = np.asarray(res.counts)
    return [(np.asarray(res.tokens)[i, :counts[i]].tolist(),
             np.asarray(res.frame_idx)[i, :counts[i]].tolist())
            for i in rows]


def test_short_request_after_long_in_one_bucket(jax_pipe):
    """The short request reuses the bucket's buffers the long one filled:
    its tokens and frames are a fresh pipeline's and the JAX pipeline's."""
    long, short = utterances(1, [["three", "five", "zero", "eight", "one"],
                                 ["two", "nine"]])
    assert short.shape[0] < long.shape[0] <= 32000
    pipe = port_pipe()
    pipe.decode_samples_batch([long])
    got, got_fl, got_el, _ = pipe.decode_samples_batch([short])
    fresh, _, _, _ = port_pipe().decode_samples_batch([short])
    want, want_fl, want_el, _ = jax_pipe.decode_samples_batch([short])
    assert len(pipe.programs) == 1
    assert lanes(got, [0]) == lanes(fresh, [0]) == lanes(want, [0])
    assert got.counts[0] > 0
    assert (got_fl[0], got_el[0]) == (want_fl[0], want_el[0])


def test_batch_of_three_after_four_in_bucket_four(jax_pipe):
    """Three requests in bucket 4 after four: the fourth lane is a padding
    lane again (zero samples), and every lane, padding included, equals a
    fresh dispatch; the real lanes equal the JAX pipeline's."""
    four = utterances(2, [["one"], ["two", "nine"], ["seven"], ["four"]])
    three = utterances(3, [["six", "eight"], ["zero"], ["five", "three"]])
    pipe = port_pipe()
    pipe.decode_samples_batch(four)
    got, got_fl, got_el, _ = pipe.decode_samples_batch(three)
    fresh, fresh_fl, fresh_el, _ = port_pipe().decode_samples_batch(three)
    want, _, _, _ = jax_pipe.decode_samples_batch(three)
    assert list(pipe.programs) == [("greedy", 4, 32000)]
    assert got.tokens.shape[0] == 4 and got_fl[3] == fresh_fl[3] == 1
    np.testing.assert_array_equal(got_el, fresh_el)
    assert lanes(got, range(4)) == lanes(fresh, range(4))
    assert lanes(got, range(3)) == lanes(want, range(3))
    np.testing.assert_array_equal(got.tokens, fresh.tokens)


def test_stream_states_survive_the_next_dispatch(jax_pipe):
    """Chunked streams: the states one dispatch hands back are the
    pipeline's own copies, so a dispatch of other audio in the same bucket
    leaves them bit for bit; the streams' next windows, decoded from them,
    equal the JAX pipeline's carried decode."""
    first = utterances(4, [["one", "two"], ["three"]])
    second = utterances(5, [["four"], ["five", "six"]])
    other = utterances(6, [["seven", "eight"], ["nine"], ["zero"]])
    pipe = port_pipe()
    _, _, _, states = pipe.decode_samples_batch(first)
    kept = [[t.clone() for t in (*st.state, st.pred_out, st.last_token)]
            for st in states]
    pipe.decode_samples_batch(other)
    for st, before in zip(states, kept):
        for now, then in zip((*st.state, st.pred_out, st.last_token),
                             before):
            assert torch.equal(now, then)
    got, _, _, got_states = pipe.decode_samples_batch(second, states)

    _, _, _, jstates = jax_pipe.decode_samples_batch(first)
    want, _, _, want_states = jax_pipe.decode_samples_batch(second, jstates)
    assert lanes(got, range(2)) == lanes(want, range(2))
    assert got.counts[:2].sum() > 0
    for g, w in zip(got_states, want_states):
        assert g.tokens_emitted == w.tokens_emitted
        for a, b in zip(g.state, w.state):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_two_threads_warming_and_dispatching(jax_pipe):
    """One thread warms every bucket while another dispatches (the
    background warm-up beside the dispatch thread), with a short switch
    interval: the tokens are one thread's, and every bucket ends warm."""
    batches = [utterances(10 + i, [["one", "four"], ["two"]][:1 + i % 2])
               for i in range(6)]
    want = [lanes(jax_pipe.decode_samples_batch(b)[0], range(len(b)))
            for b in batches]
    pipe = port_pipe(batch_buckets=[1, 2, 4])
    got = [None] * len(batches)

    def dispatch():
        for i, b in enumerate(batches):
            got[i] = lanes(pipe.decode_samples_batch(b)[0], range(len(b)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=dispatch),
                   threading.Thread(target=pipe.warmup,
                                    args=([1, 2, 4], [2.0]))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert got == want
    assert all(pipe.is_warm(b, 32000) for b in (1, 2, 4))


def test_a_capture_records_launches_without_counting():
    """While a thread records (as a capture does), its wrappers' launches
    go to the record and no count moves; another thread's launches count,
    and its reset meanwhile stays a reset."""
    from amira_rust_asr_server_tpu_torch.ops.kernels import _build
    mel, loop = kernels.KERNELS["log_mel"], kernels.KERNELS["greedy_loop"]

    def other_thread():
        _build.count_launch(loop)
        kernels.reset_launch_counts()
        _build.count_launch(loop)

    kernels.reset_launch_counts()
    _build.count_launch(mel)
    with kernels.recording_launches() as recorded:
        _build.count_launch(mel)
        _build.count_launch(mel)
        t = threading.Thread(target=other_thread)
        t.start()
        t.join()
    assert recorded == {"log_mel": 2}
    assert kernels.launch_counts()["log_mel"] == 0
    assert kernels.launch_counts()["greedy_loop"] == 1
    kernels.add_launches(recorded)  # a replay
    assert kernels.launch_counts()["log_mel"] == 2
    kernels.reset_launch_counts()


# -- decoding graphs made per call ------------------------------------------
BEAM = dict(decoding_mode="beam", beam_width=4, beam_n_best=2)
GRAMMARS = (["one two", "three", "five six"],
            ["four", "nine eight", "zero seven"])


def test_per_call_graphs_share_one_beam_program():
    """A caller that builds its grammar per call: each graph is copied into
    the static tables of its capacity, so graphs of like size run one beam
    program; each call decodes as on the JAX pipeline with the same
    grammar (tokens and n-best identical, scores within 1e-4), and the
    pipeline holds no graph once the caller drops it."""
    pytest.importorskip("flax", reason=NO_FLAX)
    from amira_rust_asr_server_tpu.config import Config as JaxConfig
    from amira_rust_asr_server_tpu.models import Transducer as JaxTransducer
    from amira_rust_asr_server_tpu.ops.beam import TokenTrie as JaxTrie
    from amira_rust_asr_server_tpu.runtime import AsrPipeline as JaxPipeline
    from amira_rust_asr_server_tpu.vocab import Vocabulary as JaxVocabulary
    jm = JaxTransducer.from_preset("tiny")
    jvocab = JaxVocabulary.load(TINY_DIGITS_VOCAB)
    ref = JaxPipeline(jm, jm.load_checkpoint(str(CKPT)), jvocab,
                      JaxConfig(inference_backend="cpu", **BUCKETS, **BEAM))
    pipe = port_pipe(**BEAM)
    v = pipe.model.config.vocab_size
    samples = utterances(7, [["one", "two", "three"]])
    refs = []
    for phrases in (*GRAMMARS, GRAMMARS[0]):
        g = TokenTrie.from_phrases(pipe.vocab, phrases, v)
        got = pipe.decode_beam_batch(samples, graph=g, n_best=2)[0]
        want = ref.decode_beam_batch(
            samples, graph=JaxTrie.from_phrases(jvocab, phrases, v),
            n_best=2)[0]
        np.testing.assert_array_equal(got.counts, np.asarray(want.counts))
        np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
        np.testing.assert_allclose(got.scores, np.asarray(want.scores),
                                   atol=1e-4)
        assert [[q for _, q in lane] for lane in got.n_best] == \
            [[q for _, q in lane] for lane in want.n_best]
        assert got.counts[0] > 0
        refs.append(weakref.ref(g))
    del g
    gc.collect()
    assert list(pipe.programs) == [("beam", 1, 32000, 16)]
    assert all(r() is None for r in refs)


# -- the lane engine's in-place carry ----------------------------------------
@pytest.fixture(scope="module")
def streaming():
    """(JAX model, JAX params, the port's f32 CPU pipeline) on
    tiny-streaming, JAX-initialized with blank bias +1.5, as
    tests/test_torch_lane_engine.py builds them."""
    pytest.importorskip("flax", reason=NO_FLAX)
    import jax

    from amira_rust_asr_server_tpu.models import Transducer as JaxTransducer
    from amira_rust_asr_server_tpu.models.presets import \
        TINY_STREAMING as JAX_TINY_STREAMING
    jm = JaxTransducer(JAX_TINY_STREAMING)
    params = jm.init(jax.random.PRNGKey(0))
    params["joint"]["out"]["b"] = params["joint"]["out"]["b"].at[
        jm.config.blank_id].add(1.5)
    model = Transducer(TINY_STREAMING)
    model.load_state_dict(from_jax_params(jax.device_get(params),
                                          model.config))
    pipe = AsrPipeline(model, Vocabulary.from_map(WORDS), Config(
        compute_dtype="float32", inference_backend="cpu",
        audio_sec_buckets=[1.0], batch_buckets=[1]))
    return jm, params, pipe


def wave(seed: int, n: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(n) * 0.3).astype(
        np.float32)


def reset_and_retick(eng, waves):
    """Attach a lane per wave and tick; then lane 1's stream ends and a
    new stream (the last wave) takes the lane over, reset in place; then
    feed everything and drain. Returns each stream's tokens."""
    a, b = eng.attach(), eng.attach()
    eng.feed(a, waves[0][:4800])
    eng.feed(b, waves[1][:4800])
    eng.tick()
    eng.detach(b)
    assert eng.attach() == b  # the lane's cache and carry reset in place
    eng.feed(a, waves[0][4800:])
    eng.feed(b, waves[2])
    eng.tick()
    for lane in (a, b):
        eng.feed(lane, END, final=True)
        eng.drain(lane)
    return [list(eng.tokens[a]), list(eng.tokens[b])]


def test_lane_engine_in_place_carry(streaming):
    """The chunk step writes the carry and the cache into the buffers the
    engine allocated (their storage never moves), and a lane reset between
    ticks leaves the next stream on that lane equal to a solo session and
    to the JAX lane engine."""
    from amira_rust_asr_server_tpu.runtime.lane_engine import \
        StreamingLaneEngine as JaxLaneEngine
    from amira_rust_asr_server_tpu.vocab import Vocabulary as JaxVocabulary
    jm, params, pipe = streaming
    waves = [wave(1, 9600), wave(2, 9600), wave(3, 8000)]
    eng = StreamingLaneEngine(pipe, n_lanes=3, chunk_frames=16, norm="none")
    eng.warm()
    buffers = [t.data_ptr() for t in (eng.dec_h, eng.dec_c, eng.pred_out,
                                      eng.last_token,
                                      *eng.enc_cache.tensors())]
    got = reset_and_retick(eng, waves)
    assert buffers == [t.data_ptr() for t in (
        eng.dec_h, eng.dec_c, eng.pred_out, eng.last_token,
        *eng.enc_cache.tensors())]
    want = reset_and_retick(JaxLaneEngine(
        jm, params, JaxVocabulary.from_map(WORDS), n_lanes=3,
        chunk_frames=16, norm="none"), waves)
    solo = []
    for w in (waves[0], waves[2]):
        sess = NativeStreamSession(pipe, chunk_frames=16, norm="none")
        sess.feed(w)
        solo.append(sess.end().tokens)
    assert all(want) and got == want == solo


# -- the per-step route's loop as device programs ---------------------------
STEP_ROUTE = dict(use_pallas_decode_loop=False, use_pallas_decode_step=True)


def counting_steps(monkeypatch):
    """Count the steps the host loop (``greedy_decode``) takes."""
    from amira_rust_asr_server_tpu_torch.ops import greedy
    calls = [0]
    step = greedy.greedy_step

    def counted(*a, **kw):
        calls[0] += 1
        return step(*a, **kw)

    monkeypatch.setattr(greedy, "greedy_step", counted)
    return calls


def test_step_route_bucket_equals_eager_and_jax(jax_pipe, monkeypatch):
    """The step route: a bucket's program runs the loop's first steps and
    its StepLoop's program the rest, asking the host once per run; tokens,
    frames and counts equal the eager host loop's (which asks after every
    step) and the JAX pipeline's, and the host reads at most
    ceil(steps / STEPS_PER_RUN) + 1 times."""
    from amira_rust_asr_server_tpu_torch.runtime import pipeline
    n = 2  # the trained weights take few steps
    monkeypatch.setattr(pipeline, "STEPS_PER_RUN", n)
    batch = utterances(8, [["one", "two", "three"], ["nine"]])
    pipe = port_pipe(**STEP_ROUTE)
    assert pipe.greedy_route == "step"
    got = pipe.decode_samples_batch(batch)[0]
    steps = counting_steps(monkeypatch)
    want = pipe._decode_batch(batch, eager=True)[0]
    prog = pipe.programs[("greedy", 4, 32000)]
    reads = prog.steps.reads
    again = pipe.decode_samples_batch(batch)[0]
    assert prog.steps.reads - reads == reads <= -(-steps[0] // n) + 1
    assert steps[0] > n and prog.steps.program.warm  # the steps' program
    ref = jax_pipe.decode_samples_batch(batch)[0]
    assert lanes(got, range(2)) == lanes(want, range(2)) == \
        lanes(again, range(2)) == lanes(ref, range(2))
    assert got.counts[:2].sum() > 0


def test_lane_engine_step_route_equals_eager(streaming):
    """The lane engine on the step route: its chunk step runs the loop's
    first steps and its StepLoop the rest; the tokens and the carry equal
    the eager engine's (the host loop), and the JAX-held loop route's."""
    _, _, loop_pipe = streaming
    pipe = AsrPipeline(loop_pipe.model, loop_pipe.vocab, Config(
        compute_dtype="float32", inference_backend="cpu",
        audio_sec_buckets=[1.0], batch_buckets=[1], **STEP_ROUTE))
    assert pipe.greedy_route == "step"
    engines = [StreamingLaneEngine(p, n_lanes=3, chunk_frames=16,
                                   norm="none")
               for p in (pipe, pipe, loop_pipe)]
    stepped, eager, loop = engines
    eager._step = lambda *a: StreamingLaneEngine._step(eager, *a, eager=True)
    waves = [wave(40 + i, 8000) for i in range(3)]
    for eng in engines:
        eng.warm()
        for lane, w in zip([eng.attach() for _ in waves], waves):
            eng.feed(lane, w, final=True)
        while eng.pending():
            eng.tick()
    assert stepped.steps.reads > 0 and eager.steps.reads == 0
    assert stepped.tokens == eager.tokens == loop.tokens
    assert any(stepped.tokens)
    for a, b in zip((stepped.dec_h, stepped.dec_c, stepped.pred_out,
                     stepped.last_token),
                    (eager.dec_h, eager.dec_c, eager.pred_out,
                     eager.last_token)):
        assert torch.equal(a, b)


# -- on the card -------------------------------------------------------------
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_replay_equals_eager_body(dev, dtype):
    """A bucket's replay and its eager body on the same inputs give the
    same tokens, frames and counts, carried state included."""
    batch = utterances(20, [["one", "two", "three"], ["nine"], ["five"]])
    pipe = port_pipe("cuda", compute_dtype=dtype)
    got, fl, el, got_st = pipe.decode_samples_batch(batch)
    want, wfl, wel, want_st = pipe._decode_batch(batch, eager=True)
    assert pipe.programs[("greedy", 4, 32000)].graph is not None
    for field in ("tokens", "counts", "frame_idx"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    np.testing.assert_array_equal(fl, wfl)
    np.testing.assert_array_equal(el, wel)
    for g, w in zip(got_st, want_st):
        for a, b in zip((*g.state, g.pred_out, g.last_token),
                        (*w.state, w.pred_out, w.last_token)):
            assert torch.equal(a, b)


def test_replay_counts_the_captured_launches(dev):
    """A replay adds the launches its capture recorded, the capture itself
    none: one mel and one loop-kernel launch per greedy dispatch."""
    pipe = port_pipe("cuda")
    pipe.warmup()
    prog = pipe.programs[("greedy", 1, 32000)]
    assert prog.launches == {"log_mel": 1, "greedy_loop": 1}
    kernels.reset_launch_counts()
    for _ in range(3):
        pipe.decode_samples_batch(utterances(21, [["four"]]))
    counts = kernels.launch_counts()
    assert counts["log_mel"] == counts["greedy_loop"] == 3
    assert sum(counts.values()) == 6


def test_capture_beside_replays_on_another_thread(dev):
    """One thread captures every other bucket while another replays a warm
    one: neither raises, and the replays' tokens equal a lone thread's."""
    pipe = port_pipe("cuda", batch_buckets=[1, 2, 4, 8, 16])
    pipe.warmup([1], [2.0])
    batch = utterances(22, [["six", "seven"]])
    want = lanes(pipe.decode_samples_batch(batch)[0], [0])
    got, errors = [], []

    def replay():
        try:
            for _ in range(20):
                got.append(lanes(pipe.decode_samples_batch(batch)[0], [0]))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=replay),
               threading.Thread(target=pipe.warmup,
                                args=([2, 4, 8, 16], [2.0]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors and got == [want] * 20
    assert all(pipe.programs[("greedy", b, 32000)].graph is not None
               for b in (1, 2, 4, 8, 16))


def test_lane_engine_replay_equals_eager_steps(dev):
    """The lane engine's replayed chunk steps and its eager steps give the
    same tokens and leave the same carry."""
    model = Transducer(TINY_STREAMING).init_weights(
        torch.Generator().manual_seed(0))
    pipe = AsrPipeline(model, Vocabulary.from_map(WORDS), Config(
        compute_dtype="float32", inference_backend="tpu",
        audio_sec_buckets=[1.0], batch_buckets=[1]), dev)
    engines = [StreamingLaneEngine(pipe, n_lanes=4, chunk_frames=16,
                                   norm="none") for _ in range(2)]
    replayed, eager = engines
    eager._step = lambda *a: StreamingLaneEngine._step(eager, *a, eager=True)
    waves = [wave(30 + i, 8000) for i in range(3)]
    for eng in engines:
        eng.warm()
        lanes_ = [eng.attach() for _ in waves]
        for lane, w in zip(lanes_, waves):
            eng.feed(lane, w, final=True)
        while eng.pending():
            eng.tick()
    assert replayed.program.graph is not None
    assert replayed.tokens == eager.tokens and any(replayed.tokens)
    for a, b in zip((replayed.dec_h, replayed.dec_c, replayed.pred_out,
                     replayed.last_token),
                    (eager.dec_h, eager.dec_c, eager.pred_out,
                     eager.last_token)):
        assert torch.equal(a, b)


def random_grammar(seed: int, n_seqs: int, vocab_size: int) -> TokenTrie:
    """A trie of ``n_seqs`` random 8-token phrases (blank excluded)."""
    rng = np.random.default_rng(seed)
    return TokenTrie.from_token_seqs(
        rng.integers(0, vocab_size - 1, (n_seqs, 8)).tolist(), vocab_size)


@pytest.mark.parametrize("route", ["pallas_kernel", "xla_scan"])
def test_beam_replay_with_a_swapped_graph_equals_eager(dev, route):
    """A beam bucket captured with one decoding graph and replayed with
    another of like size gives the eager body's trace on that graph, on
    the beam kernel's route and on the plain scan's (over 1024 states),
    which the bucket captures as well."""
    pipe = port_pipe("cuda", **BEAM)
    v = pipe.model.config.vocab_size
    if route == "pallas_kernel":
        first, second = (TokenTrie.from_phrases(pipe.vocab, p, v)
                         for p in GRAMMARS)
    else:
        first, second = (random_grammar(s, 200, v) for s in (1, 2))
    assert pipe.graph_capacity(first) == pipe.graph_capacity(second)
    samples = utterances(23, [["one", "two", "three"], ["nine", "four"]])
    pipe.decode_beam_batch(samples, graph=first)
    assert pipe.last_decode_path == route
    got = pipe._beam_dispatch(samples, graph=second)
    want = pipe._beam_dispatch(samples, graph=second, eager=True)
    (prog,) = pipe.programs.values()
    assert prog.graph is not None
    for f in dataclasses.fields(got[0]):
        np.testing.assert_array_equal(getattr(got[0], f.name),
                                      getattr(want[0], f.name), f.name)
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_route_replay_equals_eager(dev, dtype, monkeypatch):
    """The step route on the card: the bucket's graph runs the loop's first
    steps and the StepLoop's graph the rest, replayed until the device
    flag reads false; tokens, frames, counts and the carry equal the eager
    host loop's, and each replay of the steps' graph counts its
    joint-argmax launches."""
    from amira_rust_asr_server_tpu_torch.runtime import pipeline
    monkeypatch.setattr(pipeline, "STEPS_PER_RUN", 4)
    batch = utterances(24, [["one", "two", "three"], ["nine"], ["five"]])
    pipe = port_pipe("cuda", compute_dtype=dtype, **STEP_ROUTE)
    pipe.decode_samples_batch(batch)  # warm and capture both programs
    prog = pipe.programs[("greedy", 4, 32000)]
    assert prog.graph is not None and prog.steps.program.graph is not None
    assert prog.steps.program.launches == {"joint_argmax": 4}
    kernels.reset_launch_counts()
    reads = prog.steps.reads
    got, fl, el, got_st = pipe.decode_samples_batch(batch)
    runs = prog.steps.reads - reads - 1
    assert runs >= 1 and kernels.launch_counts()["joint_argmax"] == \
        4 * (runs + 1)
    want, wfl, wel, want_st = pipe._decode_batch(batch, eager=True)
    for field in ("tokens", "counts", "frame_idx"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    np.testing.assert_array_equal(el, wel)
    for g, w in zip(got_st, want_st):
        for a, b in zip((*g.state, g.pred_out, g.last_token),
                        (*w.state, w.pred_out, w.last_token)):
            assert torch.equal(a, b)


def test_beam_chunk_replay_equals_eager_with_two_sessions(dev):
    """Two streaming-beam sessions fed in turns share the chunk program,
    their caches and carries copied in and out: the replayed sessions end
    with the eager sessions' tokens, histories and scores (f32 and exact),
    and the beam kernel launches once per chunk inside the replays."""
    from amira_rust_asr_server_tpu_torch.runtime.beam_stream import \
        StreamingBeamSession
    model = Transducer(TINY_STREAMING).init_weights(
        torch.Generator().manual_seed(0))
    pipe = AsrPipeline(model, Vocabulary.from_map(WORDS), Config(
        compute_dtype="float32", inference_backend="tpu",
        audio_sec_buckets=[1.0], batch_buckets=[1], decoding_mode="beam"),
        dev)
    bias = np.zeros((model.config.vocab_size,), np.float32)
    bias[[2, 5, 9]] = [8.0, 7.5, 7.8]
    pipe.warm_beam_chunk(16, 4)
    waves = [wave(50, 9600), wave(51, 8000)]
    ends = []
    for eager in (False, True):
        kernels.reset_launch_counts()
        sessions = [StreamingBeamSession(pipe, chunk_frames=16, norm="none",
                                         beam_width=4, bias=bias,
                                         eager=eager) for _ in waves]
        for i in range(0, 9600, 1600):
            for sess, w in zip(sessions, waves):
                sess.feed(w[i:i + 1600])
        ends.append([(s.end(), s.hists) for s in sessions])
        if not eager:
            assert kernels.launch_counts()["beam_loop"] == sum(
                s.chunks for s in sessions)
    (prog,) = pipe.beam_chunk_programs.values()
    assert prog.graph is not None
    for (a, ha), (b, hb) in zip(*ends):
        assert a.tokens == b.tokens and ha == hb and a.score == b.score
    assert all(a.tokens for a, _ in ends[0])


@pytest.mark.parametrize("mode", ["greedy", "beam"])
@pytest.mark.parametrize("family", ["ctc", "aed"])
def test_family_replay_equals_eager_body(dev, family, mode):
    """A CTC or AED bucket's replay and its eager body on the same inputs,
    f32: identical tokens, counts, frames and confidences (greedy), n-best
    tokens and scores (beam); the replay runs the mel kernel once and no
    other hand kernel; the committed tiny-digits weights transcribe the
    golden through the replay."""
    from amira_rust_asr_server_tpu_torch.runtime.family_pipeline import \
        build_family_pipeline
    from amira_rust_asr_server_tpu_torch.testing import (
        TINY_DIGITS_FAMILY_NPZ, pcm16_digits)
    cfg = Config(model_family=family, inference_backend=dev.type.replace(
                     "cuda", "tpu"), decoding_mode=mode,
                 checkpoint_path=str(TINY_DIGITS_FAMILY_NPZ[family]),
                 **BUCKETS)
    _, pipe = build_family_pipeline(
        family, "tiny", Vocabulary.load(TINY_DIGITS_VOCAB), cfg, dev)
    batch = utterances(21, [["one", "two", "three"], ["nine"], ["five"]])
    if mode == "greedy":
        got = pipe.decode_samples_batch(batch)[0]
        want = pipe._decode_batch(batch, eager=True)[0]
        for field in ("tokens", "counts", "frame_idx", "confidence"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field))
    else:
        got = pipe.family_beam(batch, n_best=3)[0]
        want = pipe.family_beam(batch, n_best=3, eager=True)[0]
        np.testing.assert_array_equal(got.tokens, want.tokens)
        assert got.n_best == want.n_best
    prog = next(p for k, p in pipe.programs.items() if k[0] == mode)
    assert prog.graph is not None and prog.launches == {"log_mel": 1}
    assert pipe.process_batch(
        pcm16_digits(["two", "five", "nine"])).text == "two five nine"
