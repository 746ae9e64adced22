"""PyTorch port: the AED step's decode attention (``ops/kernels/
aed_attention.py`` ``decode_attention``, ``csrc/aed_attention.cu`` on a
card) on the loop state's own buffers (``models/aed.py`` ``CachedLoop``:
the self-attention cache viewed ``k[li, :, :u]``, the cross K/V, the
additive frame mask).

On the CPU the wrapper takes its plain version, the decoder's einsum
attention in the working type; it is held against an attention written
here in float64 over the visible keys alone (uniform weights where a query
sees none). Tolerances: f32 1e-5 (summation order); bf16 3e-2, as the
plain version rounds the logits, the scale, the mask
sum and the softmax's weights to bf16 (2^-9 relative each) before the
weighted sum.

The card's cases take the ``dev`` fixture, which skips them without CUDA:
the kernel against the plain version and against the float64 attention at
Canary-1B-flash's heads (8 of 128), and a chunk of the loop captured
through ``FlagLoop``. The kernel sums in f32 and rounds once, so against
float64 it is within f32's 1e-5 in f32 and within one bf16 rounding of the
output (2^-9 relative; 4e-3 allowed) in bf16; against the plain version,
within the sum of the two. Every tolerance is relative to 1 + the value's
size.
"""

import numpy as np
import pytest
import torch

from amira_rust_asr_server_tpu_torch.config import Config
from amira_rust_asr_server_tpu_torch.models import aed as aed_mod
from amira_rust_asr_server_tpu_torch.models.aed import (LOOP_CHUNK, AEDModel,
                                                        CachedLoop)
from amira_rust_asr_server_tpu_torch.models.presets import ModelConfig
from amira_rust_asr_server_tpu_torch.ops import kernels
from amira_rust_asr_server_tpu_torch.ops.kernels.aed_attention import (
    NEG, decode_attention, decode_attention_reference)
from amira_rust_asr_server_tpu_torch.runtime.family_pipeline import \
    build_family_pipeline
from amira_rust_asr_server_tpu_torch.vocab import Vocabulary

torch.set_num_threads(2)

# Canary's prompt, and a max_len off the chunk size: the cache holds 209
# positions, a step views the first 204 (a view with a gap between lanes)
PROMPT, MAX_LEN = 9, 195
TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


def config(heads: int = 2, d: int = 32, layers: int = 2,
           prompt=(37, 38, 36)) -> ModelConfig:
    return ModelConfig(n_mels=32, d_model=32, n_layers=1, n_heads=2,
                       ff_expansion=2, conv_kernel=5, subsampling_factor=4,
                       subsampling_dim=32, d_enc=32, vocab_size=40,
                       blank_id=2, dec_layers=layers, dec_heads=heads,
                       d_dec=d, dec_prompt=prompt)


def tiny_model() -> AEDModel:
    return AEDModel(config()).init_weights(torch.Generator().manual_seed(5))


def filled_loop(b: int, t: int, heads: int, d: int, dtype, device="cpu",
                lens=None, seed=0) -> CachedLoop:
    """A loop state of ``b`` lanes, ``t`` frames and 4 decoder layers at
    :data:`PROMPT` and :data:`MAX_LEN`, its caches and cross K/V random, its
    frame mask from ``lens`` (valid frames a lane)."""
    with torch.device("meta"):  # the state's shapes alone: no weights
        model = AEDModel(config(heads, d, 4, tuple(range(30, 30 + PROMPT))))
    loop = model.to(dtype).cached_loop(b, t, MAX_LEN, torch.device(device))
    g = torch.Generator().manual_seed(seed)
    for buf in (loop.k, loop.v, loop.cross):
        buf.copy_(torch.randn(buf.shape, generator=g).to(dtype))
    lens = torch.tensor([t] * b if lens is None else lens)
    keep = torch.arange(t)[None, :] < lens[:, None]
    loop.enc_mask.copy_(torch.where(keep, 0.0, NEG).to(dtype)[:, None,
                                                              None, :])
    return loop


def exact(q, k, v, visible) -> torch.Tensor:
    """float64 attention over the keys ``visible [B, n, T]`` bool alone;
    uniform weights over all T where a query sees none."""
    q, k, v = (x.double() for x in (q, k, v))
    b, n, h, dh = q.shape
    s = torch.einsum("bnhd,bthd->bnht", q, k) / dh ** 0.5
    vis = visible[:, :, None, :].expand_as(s)
    none = ~vis.any(-1, keepdim=True)
    s = torch.where(vis, s, -torch.inf)
    s = torch.where(none, 0.0, s)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bnht,bthd->bnhd", w, v).reshape(b, n, h * dh)


def close(got, want, tol: float) -> None:
    """Within ``tol`` of ``want``, relative to 1 + its size."""
    got, want = got.double(), want.double()
    err = ((got - want).abs() / (1 + want.abs())).max().item()
    assert err <= tol, err


def query(b, n, heads, dh, dtype, device="cpu", seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((b, n, heads, dh), generator=g).to(dtype).to(device)


# -- the plain version on the CPU --------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 9])
@pytest.mark.parametrize("where", ["first", "mid", "last"])
def test_self_attention_sees_the_cache_up_to_each_position(where, n, dtype):
    """Query i at position at[i] sees cache positions 0..at[i] of the
    non-contiguous view the step takes (``CachedLoop.k[li, :, :u]``), at
    the first, a middle and the last positions of P + max_len."""
    b, heads, d = 3, 2, 32
    loop = filled_loop(b, 25, heads, d, dtype)
    u = loop.ar.shape[0]
    start = {"first": 0, "mid": u // 2, "last": u - n}[where]
    at = torch.arange(start, start + n)
    k, v = loop.k[1, :, :u], loop.v[1, :, :u]
    assert not k.is_contiguous()
    q = query(b, n, heads, d // heads, dtype)
    got = decode_attention(q, k, v, at=at)
    visible = (torch.arange(u)[None, :] <= at[:, None]).expand(b, n, u)
    assert got.shape == (b, n, d) and got.dtype == dtype
    close(got, exact(q, k, v, visible), TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 9])
def test_cross_attention_sees_each_lanes_valid_frames(n, dtype):
    """Ragged valid frames (all, some, one, none): a lane sees its valid
    frames, and a lane with none takes uniform weights over all T."""
    b, t, heads, d = 4, 25, 2, 32
    lens = [25, 11, 1, 0]
    loop = filled_loop(b, t, heads, d, dtype, lens=lens)
    ck, cv = loop.cross_kv(1)
    q = query(b, n, heads, d // heads, dtype)
    got = decode_attention(q, ck, cv, mask=loop.enc_mask)
    visible = (torch.arange(t)[None, :] < torch.tensor(lens)[:, None])
    want = exact(q, ck, cv, visible[:, None, :].expand(b, n, t))
    close(got, want, TOL[dtype])
    mean = cv[3].double().mean(0).reshape(-1)
    close(got[3], mean.expand(n, d), TOL[dtype])


def test_the_mask_may_come_as_rows():
    """``[B, T]`` and the loop's ``[B, 1, 1, T]`` are one mask."""
    loop = filled_loop(2, 25, 2, 32, torch.float32, lens=[25, 4])
    ck, cv = loop.cross_kv(0)
    q = query(2, 1, 2, 16, torch.float32)
    assert torch.equal(decode_attention(q, ck, cv, mask=loop.enc_mask),
                       decode_attention(q, ck, cv,
                                        mask=loop.enc_mask.reshape(2, 25)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["self", "cross"])
def test_the_cpu_path_is_the_plain_version(kind, dtype):
    loop = filled_loop(2, 25, 2, 32, dtype, lens=[25, 4])
    q = query(2, 9, 2, 16, dtype)
    if kind == "self":
        u = loop.ar.shape[0]
        k, v = loop.k[0, :, :u], loop.v[0, :, :u]
        keys = {"at": torch.arange(40, 49)}
    else:
        (k, v), keys = loop.cross_kv(0), {"mask": loop.enc_mask}
    assert torch.equal(decode_attention(q, k, v, **keys),
                       decode_attention_reference(q, k, v, **keys))


def test_another_device_raises():
    q = torch.zeros((1, 1, 2, 16), device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        decode_attention(q, q, q)


def test_every_attention_of_the_step_goes_through_the_wrapper(monkeypatch):
    """The opening (the prompt's prefill, then LOOP_CHUNK - 1 steps) and a
    chunk call the wrapper twice a layer a decision: self-attention with
    the positions, cross-attention with the frame mask."""
    calls = []

    def counting(q, k, v, *, at=None, mask=None):
        calls.append("self" if at is not None else "cross")
        assert (at is None) != (mask is None)
        return decode_attention(q, k, v, at=at, mask=mask)

    monkeypatch.setattr(aed_mod, "decode_attention", counting)
    model = tiny_model().eval()
    g = torch.Generator().manual_seed(2)
    enc = torch.randn((2, 7, 32), generator=g)
    loop = model.cached_loop(2, 7, 30, torch.device("cpu"))
    with torch.inference_mode():
        model.greedy_open(enc, torch.tensor([7, 3]), loop)
        assert calls == ["self", "cross"] * 2 * LOOP_CHUNK
        model.greedy_chunk(loop, LOOP_CHUNK)
    assert calls == ["self", "cross"] * 2 * 2 * LOOP_CHUNK


# -- the kernel on the card --------------------------------------------------
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [25, 375])
@pytest.mark.parametrize("b", [1, 8, 16])
@pytest.mark.parametrize("kind", ["self", "cross"])
def test_kernel_equals_the_plain_version(dev, kind, b, t, dtype):
    """At Canary's heads (8 of 128), one query (a step) and nine (the
    prefill): the kernel against float64 and against the plain version on
    the loop state's own views; one launch a call. Self-attention at the
    first, a middle and the last positions; cross-attention with ragged
    valid frames and a lane with none."""
    heads, d = 8, 1024
    lens = [t, max(1, t // 3), 0, t - 1] * 4
    loop = filled_loop(b, t, heads, d, dtype, dev, lens=lens[:b], seed=b + t)
    u = loop.ar.shape[0]
    for n in (1, 9):
        q = query(b, n, heads, d // heads, dtype, dev, seed=n)
        if kind == "self":
            k, v = loop.k[2, :, :u], loop.v[2, :, :u]
            for start in (0, u // 2 - n, u - n):
                at = torch.arange(start, start + n, device=dev)
                visible = (torch.arange(u, device=dev)[None, :]
                           <= at[:, None]).expand(b, n, u)
                check_kernel(q, k, v, visible, dtype, at=at)
        else:
            k, v = loop.cross_kv(3)
            visible = (torch.arange(t, device=dev)[None, :]
                       < torch.tensor(lens[:b], device=dev)[:, None])
            check_kernel(q, k, v, visible[:, None, :].expand(b, n, t),
                         dtype, mask=loop.enc_mask)


def check_kernel(q, k, v, visible, dtype, **keys) -> None:
    before = decode_attention.launches
    got = decode_attention(q, k, v, **keys)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    plain = decode_attention_reference(q, k, v, **keys)
    kernel_tol = {torch.float32: 1e-5, torch.bfloat16: 4e-3}[dtype]
    close(got, exact(q, k, v, visible), kernel_tol)
    close(got, plain, kernel_tol + TOL[dtype])


def test_replays_of_a_captured_launch_follow_the_position(dev):
    """A split launch captured once, replayed as the device position moves:
    each replay equals an eager launch at that position (the counters the
    last block resets are zero for the next)."""
    b, heads, d = 8, 8, 1024
    loop = filled_loop(b, 375, heads, d, torch.bfloat16, dev)
    u = loop.ar.shape[0]
    q = query(b, 1, heads, d // heads, torch.bfloat16, dev)
    k, v = loop.k[0, :, :u], loop.v[0, :, :u]
    pos = torch.zeros(1, dtype=torch.int64, device=dev)
    decode_attention(q, k, v, at=pos)  # eager first: the counters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention(q, k, v, at=pos)
    for p in (0, 5, 100, 208, 57):
        pos.fill_(p)
        graph.replay()
        want = decode_attention(q, k, v, at=pos)
        torch.cuda.synchronize()
        assert torch.equal(out, want), p


def test_a_captured_chunk_replays_its_attention_launches(dev):
    """The AED pipeline's bucket program and its chunk program, captured:
    the chunk's record holds 2 x dec_layers x LOOP_CHUNK launches of the
    kernel, a replayed dispatch gives its eager run's tokens, and the
    ``aed`` counter adds the launches its program and chunks ran."""
    eos = 2
    model = tiny_model()
    with torch.no_grad():
        model.decoder.out["b"][eos] = -10.0  # no lane ends: every chunk runs
    cfg = Config(audio_sec_buckets=[0.5], batch_buckets=[4],
                 max_total_tokens=24, compute_dtype="bfloat16",
                 inference_backend="tpu", model_family="aed")
    vocab = Vocabulary.from_map({i: f"▁w{i}" for i in range(40) if i != eos})
    pipe = build_family_pipeline("aed", "tiny", vocab, cfg, dev,
                                 model=model.eval())[1]
    pipe._warm_one(4, 8000)
    prog = pipe.programs[("greedy", 4, 8000)]
    per_chunk = 2 * model.config.dec_layers * LOOP_CHUNK
    assert prog.loop.program.launches == {"aed_attention": per_chunk}
    assert prog.launches["aed_attention"] == per_chunk
    rng = np.random.default_rng(3)
    batch = [(0.2 * rng.standard_normal(n)).astype(np.float32)
             for n in (3200, 8000, 5000)]
    before = pipe.aed_stats.to_json()
    kernels.reset_launch_counts()
    got = pipe._decode_batch(batch)[0]
    launched = kernels.launch_counts()["aed_attention"]
    after = pipe.aed_stats.to_json()
    eager = pipe._decode_batch(batch, eager=True)[0]
    np.testing.assert_array_equal(got.tokens[:3], eager.tokens[:3])
    np.testing.assert_array_equal(got.counts[:3], eager.counts[:3])
    steps = after["steps_total"] - before["steps_total"]
    assert steps == 24
    added = (after["attention_launches_total"]
             - before["attention_launches_total"])
    assert added == launched == 2 * model.config.dec_layers * steps
