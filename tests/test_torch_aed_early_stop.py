"""PyTorch port: the AED greedy loop that stops once its last real lane has
emitted EOS (``models/aed.py`` ``greedy_open``/``greedy_chunk`` on a
``CachedLoop`` whose device position says where a chunk starts,
``runtime/family_pipeline.py`` ``AEDPipeline``'s one chunk program a bucket,
replayed by ``runtime/programs.py`` ``FlagLoop`` with its flag read one
chunk behind), on seeded weights at tiny widths: d 32, 2 decoder layers of
2 heads, a prompt of 3, 40 outputs with EOS 2. The EOS bias sets how long
the lanes run: at 20 every lane ends at the prefill, at 4.2 the real lanes
end after 1, 12 and 13 decisions, at -1 none ends within 30.

The oracle is the whole loop, ``greedy_cached_from_enc`` at ``max_len``
on the bucket's encoder output: every decision, whatever the lanes emit.
Tokens and counts are compared exactly. The CUDA cases skip without a
card.
"""

import gc

import numpy as np
import pytest
import torch

from amira_rust_asr_server_tpu_torch.config import Config
from amira_rust_asr_server_tpu_torch.models.aed import LOOP_CHUNK, AEDModel
from amira_rust_asr_server_tpu_torch.models.presets import ModelConfig
from amira_rust_asr_server_tpu_torch.runtime import programs
from amira_rust_asr_server_tpu_torch.runtime.family_pipeline import (
    AEDPipeline, build_family_pipeline)
from amira_rust_asr_server_tpu_torch.vocab import Vocabulary

torch.set_num_threads(2)

EOS = 2
CFG = ModelConfig(n_mels=32, d_model=32, n_layers=2, n_heads=2,
                  ff_expansion=2, conv_kernel=5, subsampling_factor=4,
                  subsampling_dim=32, d_enc=32, vocab_size=40, blank_id=EOS,
                  dec_layers=2, dec_heads=2, d_dec=32, dec_prompt=(37, 38, 36))
VOCAB = Vocabulary.from_map({i: f"▁w{i}" for i in range(40) if i != EOS})
N_SAMPLES = 8000  # the one length bucket, 0.5 s
BUCKET = ("greedy", 4, N_SAMPLES)


def samples(seed=0, lens=(3200, 7000, 5000)):
    """Three lanes of noise: a batch of 4 with a padding lane."""
    rng = np.random.default_rng(seed)
    return [(0.2 * rng.standard_normal(n)).astype(np.float32) for n in lens]


def pipeline(eos_bias: float, max_len: int = 30, dtype: str = "float32",
             backend: str = "cpu", device=None) -> AEDPipeline:
    model = AEDModel(CFG).init_weights(torch.Generator().manual_seed(11))
    with torch.no_grad():
        model.decoder.out["b"][EOS] = eos_bias
    cfg = Config(audio_sec_buckets=[N_SAMPLES / 16000], batch_buckets=[1, 4],
                 max_total_tokens=max_len, compute_dtype=dtype,
                 inference_backend=backend, model_family="aed")
    return build_family_pipeline("aed", "tiny", VOCAB, cfg, device,
                                 model=model.eval())[1]


def whole_loop(pipe: AEDPipeline):
    """The bucket's staged audio through the encoder and the whole loop:
    (tokens, counts) on the host."""
    prog = pipe.programs[BUCKET]
    with torch.inference_mode():
        _, enc, enc_lens = pipe._encode_stage(prog.inputs)
        toks, counts = pipe.model.greedy_cached_from_enc(
            enc, enc_lens, max_len=pipe.max_len)
    return toks.cpu().numpy(), counts.cpu().numpy()


def dispatch(pipe: AEDPipeline, batch, eager=False):
    """One greedy dispatch: (result, the ``aed`` counters it added)."""
    before = pipe.aed_stats.to_json()
    res = pipe._decode_batch(batch, eager=eager)[0]
    after = pipe.aed_stats.to_json()
    return res, {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("eos_bias, chunks", [(20.0, 1), (4.2, 2),
                                              (-1.0, 3)])
def test_real_lanes_equal_the_whole_loop_beside_a_padding_lane(
        eos_bias, chunks, dtype):
    """With a padding lane in the bucket, the served real lanes' tokens
    and counts are the whole loop's, row for row, whether the loop stops
    after the look-ahead chunk, in the middle or runs out of chunks; the
    eager pieces give the same."""
    pipe = pipeline(eos_bias, dtype=dtype)
    batch = samples()
    res, d = dispatch(pipe, batch)
    want_t, want_c = whole_loop(pipe)
    np.testing.assert_array_equal(res.tokens[:3], want_t[:3])
    np.testing.assert_array_equal(res.counts[:3], want_c[:3])
    assert d["loop_chunks_total"] == chunks
    eager, _ = dispatch(pipe, batch, eager=True)
    np.testing.assert_array_equal(eager.tokens[:3], want_t[:3])
    np.testing.assert_array_equal(eager.counts[:3], want_c[:3])


def test_with_no_lane_ending_every_chunk_runs():
    pipe = pipeline(-1.0)
    res, d = dispatch(pipe, samples())
    loop = pipe.programs[BUCKET].loop
    assert (res.counts[:3] == pipe.max_len).all()
    assert d["loop_chunks_total"] == loop.limit == 3
    assert d["steps_total"] == pipe.max_len == 30


def test_with_every_lane_ending_at_the_prefill_the_look_ahead_chunk_is_last():
    """The opening's flag says no real lane is live; the first chunk was
    queued before the host read it, and nothing after it runs."""
    pipe = pipeline(20.0)
    res, d = dispatch(pipe, samples())
    assert (res.counts[:3] == 0).all() and (res.tokens[:3] == EOS).all()
    assert d["loop_chunks_total"] == 1
    assert d["steps_total"] == 2 * LOOP_CHUNK


@pytest.mark.parametrize("max_len", [5, 8, 13, 30])
def test_a_loop_off_the_chunk_size_ends_with_a_short_chunk(max_len):
    """``max_len`` not a multiple of N: the loop's one chunk program runs
    until the chunks reach ``max_len`` (none where the opening does), the
    last one past it on positions that hold whole chunks; the decisions
    counted stop at ``max_len``, and a loop that runs out of chunks is the
    whole loop."""
    chunks = -(-max_len // LOOP_CHUNK) - 1
    pipe = pipeline(-1.0, max_len=max_len)
    res, d = dispatch(pipe, samples())
    loop, state = pipe.programs[BUCKET].loop, pipe._loop_state(4, N_SAMPLES)
    assert (loop is None) == (chunks == 0)
    assert d["loop_chunks_total"] == chunks == state.chunks
    if loop is not None:
        assert loop.limit == chunks and loop.program.warm
    n_p = len(CFG.dec_prompt)
    assert state.buf.shape[1] == n_p + LOOP_CHUNK * (chunks + 1)
    assert int(state.pos[0]) == n_p - 1 + LOOP_CHUNK * (chunks + 1)
    assert d["steps_total"] == max_len <= LOOP_CHUNK * (chunks + 1)
    want_t, want_c = whole_loop(pipe)
    np.testing.assert_array_equal(res.tokens[:3], want_t[:3])
    np.testing.assert_array_equal(res.counts[:3], want_c[:3])


def test_the_counters_follow_the_chunks_run():
    """Three dispatches of one bucket at three EOS biases (the bias set in
    place between them): each adds the chunks it replayed, the opening's
    and those chunks' decisions, the lane steps of its 3 real lanes and
    their live steps."""
    pipe = pipeline(20.0)
    for bias, chunks in ((20.0, 1), (-1.0, 3), (4.2, 2)):
        with torch.no_grad():
            pipe.model.decoder.out["b"][EOS] = bias
        res, d = dispatch(pipe, samples())
        steps = min(LOOP_CHUNK * (chunks + 1), pipe.max_len)
        counts = res.counts[:3].astype(np.int64)
        assert d == {
            "dispatches": 1, "lanes_total": 3, "steps_total": steps,
            "lane_steps_total": 3 * steps,
            "live_lane_steps_total": int(np.minimum(counts + 1,
                                                    steps).sum()),
            "prompt_tokens_total": 3 * len(CFG.dec_prompt),
            "loop_chunks_total": chunks, "attention_launches_total": 0,
            "encode_device_s_total": 0.0, "decode_device_s_total": 0.0}
        assert counts.max() < steps or steps == pipe.max_len
    assert pipe.aed_stats.loop_chunks_total == 6
    assert pipe.aed_stats.steps_total == 16 + 30 + 24


def test_a_padding_lane_never_holds_the_loop():
    """After a dispatch that never ends (EOS bias -1), the real lanes are
    marked done by hand: the next chunk lowers the flag though the padding
    lane (no audio) has not emitted EOS, and leaves the real
    lanes' tokens as they were."""
    pipe = pipeline(-1.0)
    dispatch(pipe, samples())
    loop = pipe._loop_state(4, N_SAMPLES)
    assert loop.real.tolist() == [True, True, True, False]
    with torch.inference_mode():
        loop.done.copy_(torch.tensor([True, True, True, False]))
        before = loop.tokens.clone()
        # the chunk of decisions LOOP_CHUNK .. 2 LOOP_CHUNK - 1
        loop.pos.fill_(loop.prompt_len + LOOP_CHUNK - 1)
        pipe.model.greedy_chunk(loop, LOOP_CHUNK)
        assert not loop.done[3] and not loop.live[0]
        now = loop.tokens
        assert torch.equal(now[:3, :LOOP_CHUNK], before[:3, :LOOP_CHUNK])
        assert (now[:3, LOOP_CHUNK:2 * LOOP_CHUNK] == EOS).all()


def test_warming_a_bucket_makes_every_chunk_program_whatever_the_flag():
    """The warm-up on silence, and a dispatch into a cold bucket, leave
    the bucket's one chunk program made, though the loop stopped after
    the look-ahead chunk (EOS bias 20); the warm-up reads no flag."""
    pipe = pipeline(20.0)
    pipe._warm_one(4, N_SAMPLES)
    loop = pipe.programs[BUCKET].loop
    assert loop.program.warm and pipe.programs[BUCKET].warm
    assert loop.reads == 0
    cold = pipeline(20.0)
    _, d = dispatch(cold, samples())
    assert d["loop_chunks_total"] == 1
    assert cold.programs[BUCKET].loop.program.warm


def test_buckets_of_one_batch_size_share_the_loop_state():
    """Two length buckets of 4 lanes view one set of buffers, made for the
    longer bucket's encoder frames; each view's cross K/V are contiguous."""
    model = AEDModel(CFG).init_weights(torch.Generator().manual_seed(11))
    cfg = Config(audio_sec_buckets=[0.5, 2.0], batch_buckets=[4],
                 max_total_tokens=12, compute_dtype="float32",
                 inference_backend="cpu", model_family="aed")
    pipe = build_family_pipeline("aed", "tiny", VOCAB, cfg,
                                 model=model.eval())[1]
    pipe._bucket_program("greedy", 4, 8000)
    pipe._bucket_program("greedy", 4, 32000)
    short = pipe._loop_state(4, 8000)
    long = pipe._loop_state(4, 32000)
    assert short.t < long.t == long.capacity == short.capacity
    assert short.k.data_ptr() == long.k.data_ptr()
    assert short.cross.data_ptr() == long.cross.data_ptr()
    for loop in (short, long):
        ck, cv = loop.cross_kv(1)
        assert ck.is_contiguous() and cv.is_contiguous()
        assert ck.shape == (4, loop.t, 2, 16)
    for n in (3200, 30000):
        res = pipe.decode_samples_batch(samples(lens=(n,)))[0]
        b = pipe._bucket_len(n)
        prog = pipe.programs[("greedy", 4, b)]
        with torch.inference_mode():
            _, enc, el = pipe._encode_stage(prog.inputs)
            toks, counts = pipe.model.greedy_cached_from_enc(
                enc, el, max_len=12)
        np.testing.assert_array_equal(res.tokens[0], toks[0].numpy())
        assert res.counts[0] == counts[0]


@pytest.mark.parametrize("max_len", [13, 200])
def test_a_greedy_bucket_makes_two_programs(monkeypatch, max_len):
    """A greedy bucket's warm-up and dispatches make two programs, the
    bucket's and its one chunk program, both run (on a card: captured),
    whatever ``max_len`` asks of the loop."""
    made = []
    init = programs.DeviceProgram.__init__

    def counted(self, *a, **kw):
        made.append(self)
        init(self, *a, **kw)

    monkeypatch.setattr(programs.DeviceProgram, "__init__", counted)
    pipe = pipeline(-1.0, max_len=max_len)
    pipe._warm_one(4, N_SAMPLES)
    _, d = dispatch(pipe, samples())
    prog = pipe.programs[BUCKET]
    assert made == [prog.loop.program, prog]
    assert all(p.warm for p in made)
    assert d["loop_chunks_total"] == prog.loop.limit == -(-max_len // 8) - 1
    assert d["steps_total"] == max_len


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_chunk_program_run_again_equals_the_whole_loop(dtype):
    """One program of a chunk of decisions from the device position, run
    after the opening until the chunks reach ``max_len``, gives the whole
    loop's (``greedy_cached_from_enc``) tokens, counts and every logit,
    exactly."""
    model = AEDModel(CFG).init_weights(torch.Generator().manual_seed(11))
    with torch.no_grad():
        model.decoder.out["b"][EOS] = -1.0
    model = model.eval().to(dtype)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, CFG.n_mels, 90))
                         .astype(np.float32)).to(dtype)
    with torch.inference_mode():
        enc, el = model.encode(x, torch.tensor([90, 61, 30],
                                               dtype=torch.int32))
        want_t, want_c, want_l = model.greedy_cached_from_enc(
            enc, el, max_len=30, return_logits=True)
        state = model.cached_loop(3, enc.shape[1], 30, enc.device)
        kept = []
        model.greedy_open(enc, el, state, kept)
    chunk = programs.DeviceProgram(
        "chunk", torch.device("cpu"),
        lambda: (model.greedy_chunk(state, LOOP_CHUNK, kept), state.live)[1:])
    for _ in range(state.chunks):
        chunk.run()
    assert len(kept) == 32
    assert torch.equal(state.tokens, want_t)
    assert torch.equal(state.counts, want_c)
    assert torch.equal(torch.stack(kept[:30], dim=1), want_l)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("eos_bias", [20.0, 4.2, -1.0])
def test_replayed_chunks_equal_an_eager_run(dev, eos_bias, dtype):
    """On a card: the bucket's program and its one chunk program each
    captured as a graph; a dispatch of replays, an eager dispatch of the
    same pieces and the whole loop give the same real lanes' tokens and
    counts, and the decode's device time covers the chunks."""
    pipe = pipeline(eos_bias, dtype=dtype, backend="tpu", device=dev)
    pipe._warm_one(4, N_SAMPLES)
    prog = pipe.programs[BUCKET]
    assert prog.graph is not None
    assert prog.loop.program.graph is not None
    batch = samples()
    got, d = dispatch(pipe, batch)
    eager, _ = dispatch(pipe, batch, eager=True)
    want_t, want_c = whole_loop(pipe)
    for res in (got, eager):
        np.testing.assert_array_equal(res.tokens[:3], want_t[:3])
        np.testing.assert_array_equal(res.counts[:3], want_c[:3])
    assert d["loop_chunks_total"] >= 1
    assert d["decode_device_s_total"] > 0 and d["encode_device_s_total"] > 0


def test_no_collection_runs_inside_a_capture(dev, monkeypatch):
    """A collection inside a capture would free the captured graphs of a
    dropped pipeline waiting in a cycle, a call a capture forbids, and the
    capture would fail: the bucket's program and its chunk program are
    each captured with the collector off, and it is on again after."""
    seen = []
    begin = torch.cuda.CUDAGraph.capture_begin

    def recording(self, *args, **kwargs):
        seen.append(gc.isenabled())
        return begin(self, *args, **kwargs)

    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin", recording)
    assert gc.isenabled()
    pipeline(20.0, backend="tpu", device=dev)._warm_one(4, N_SAMPLES)
    assert seen == [False, False] and gc.isenabled()
