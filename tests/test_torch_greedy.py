"""PyTorch port: the greedy label-looping decode against the JAX reference.

Two references for the port's loop:
- ``greedy_decode_transducer`` (the XLA while_loop) for the model-bound
  decode and for the kernel wrapper's CPU path;
- ``greedy_loop_pallas(..., interpret=True)``, the TPU kernel run as the
  reference's own tests run it, for the kernel wrapper's CPU path with carried
  state and ``token_offset``.

In f32 both sides make the same decisions: tokens, frames, counts and last
token are compared exactly; confidences and carried state within 2e-4
relative / 2e-5 absolute (f32 summation order). The scripted fakes of
tests/test_greedy.py pin the bookkeeping (blank runs, ragged lengths, the
max_symbols forced advance, the max_total budget) with exact expectations.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from amira_rust_asr_server_tpu.models import Transducer as JaxTransducer
from amira_rust_asr_server_tpu.ops.greedy import \
    greedy_decode_transducer as jax_greedy
from amira_rust_asr_server_tpu.ops.pallas.decode_loop import \
    greedy_loop_pallas
from amira_rust_asr_server_tpu_torch.convert import from_jax_params
from amira_rust_asr_server_tpu_torch.models import Transducer
from amira_rust_asr_server_tpu_torch.ops.greedy import (
    greedy_active, greedy_decode, greedy_decode_transducer, greedy_init,
    greedy_result, greedy_step)
from amira_rust_asr_server_tpu_torch.ops.kernels.decode_loop import (
    DecodeWeights, greedy_loop)

torch.set_num_threads(2)
RTOL, ATOL = 2e-4, 2e-5

# -- scripted fakes (as tests/test_greedy.py) --------------------------------
BLANK, VOCAB = 4, 5


def fake_pred(tokens, state):
    return tokens[:, None].float(), tuple(s + 1 for s in state)


def one_hot_logits(ids):
    return F.one_hot(ids.long(), VOCAB).float()


def one_symbol_per_frame_joint(enc_frame, pred_out):
    want = enc_frame[:, 0].long()
    emitted = pred_out[:, 0].long() == want
    return one_hot_logits(torch.where(emitted, BLANK, want))


def constant_joint(token):
    return lambda e, p: one_hot_logits(torch.full((e.shape[0],), token))


def zero_state(b):
    return (torch.zeros((1, b, 1)),)


FAKE_CASES = {
    "all_blank": dict(
        enc=torch.zeros((3, 6, 2)), lens=[6, 6, 6],
        joint=constant_joint(BLANK), kw={},
        counts=[0, 0, 0], tokens={}),
    "one_symbol_per_frame_ragged": dict(
        enc=torch.tensor(np.tile((np.arange(6) % 4)[None, :, None],
                                 (2, 1, 2)), dtype=torch.float32),
        lens=[6, 3], joint=one_symbol_per_frame_joint, kw={},
        counts=[6, 3], tokens={0: [0, 1, 2, 3, 0, 1], 1: [0, 1, 2]},
        frames={0: list(range(6))}, last=[1, 2]),
    "max_symbols_forced_advance": dict(
        enc=torch.zeros((1, 4, 2)), lens=[4], joint=constant_joint(2),
        kw=dict(max_symbols=3, max_total=100), counts=[12],
        tokens={0: [2] * 12}, frames={0: list(np.repeat(np.arange(4), 3))}),
    "max_total_budget": dict(
        enc=torch.zeros((1, 100, 2)), lens=[100], joint=constant_joint(1),
        kw=dict(max_symbols=5, max_total=7), counts=[7],
        tokens={0: [1] * 7}),
}


@pytest.mark.parametrize("case", list(FAKE_CASES))
def test_scripted_fakes(case):
    c = FAKE_CASES[case]
    b = c["enc"].shape[0]
    res = greedy_decode(fake_pred, c["joint"], c["enc"],
                        torch.tensor(c["lens"]), zero_state(b), BLANK,
                        **c["kw"])
    assert res.counts.tolist() == c["counts"]
    for lane, toks in c["tokens"].items():
        assert res.tokens[lane, :len(toks)].tolist() == toks
    for lane, frames in c.get("frames", {}).items():
        assert res.frame_idx[lane, :len(frames)].tolist() == \
            [int(f) for f in frames]
    if "last" in c:
        assert res.last_token.tolist() == c["last"]


# -- the tiny model against JAX ----------------------------------------------
@pytest.fixture(scope="module")
def tiny():
    jm = JaxTransducer.from_preset("tiny")
    params = jm.init(jax.random.PRNGKey(0))
    params["joint"]["out"]["b"] = (
        params["joint"]["out"]["b"].at[jm.config.blank_id].add(1.5))
    model = Transducer(jm.config)
    model.load_state_dict(from_jax_params(jax.device_get(params), jm.config))
    return jm, params, model.eval()


def with_joint_bias(jm, params, model, delta):
    """Copies of both models with ``delta`` added to the blank logit bias."""
    params = jax.tree_util.tree_map(lambda x: x, params)
    params["joint"]["out"]["b"] = (
        params["joint"]["out"]["b"].at[jm.config.blank_id].add(delta))
    model = Transducer(jm.config)
    model.load_state_dict(from_jax_params(jax.device_get(params), jm.config))
    return params, model.eval()


def assert_same(got, ref):
    counts = np.asarray(ref.counts)
    np.testing.assert_array_equal(np.asarray(got.counts), counts)
    for i, n in enumerate(counts):
        np.testing.assert_array_equal(np.asarray(got.tokens)[i, :n],
                                      np.asarray(ref.tokens)[i, :n])
        np.testing.assert_array_equal(np.asarray(got.frame_idx)[i, :n],
                                      np.asarray(ref.frame_idx)[i, :n])
        np.testing.assert_allclose(np.asarray(got.confidence)[i, :n],
                                   np.asarray(ref.confidence)[i, :n],
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(np.asarray(got.last_token),
                                  np.asarray(ref.last_token))
    for g, r in ((got.state[0], ref.state[0]), (got.state[1], ref.state[1]),
                 (got.pred_out, ref.pred_out)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)


def torch_result(res):
    """GreedyResult of tensors -> numpy, field by field."""
    return dataclasses.replace(
        res, **{f.name: (tuple(x.numpy() for x in getattr(res, f.name))
                         if f.name == "state" else
                         getattr(res, f.name).numpy())
                for f in dataclasses.fields(res)})


def run_loop(model, enc, lens, *, carry=None, token_offset=None, **kw):
    """The kernel wrapper (CPU path) from a fresh or carried state."""
    cfg = model.config
    b = enc.shape[0]
    with torch.no_grad():
        enc_pre = model.joint_precompute_enc(torch.from_numpy(enc))
        if carry is None:
            blank = torch.full((b,), cfg.blank_id, dtype=torch.int32)
            pred0, (h0, c0) = model.predict_step(blank, model.init_state(b))
            last0 = blank
        else:
            (h0, c0), pred0, last0 = (carry.state, carry.pred_out,
                                      carry.last_token)
        off = (torch.zeros(b, dtype=torch.int32) if token_offset is None
               else token_offset)
        return greedy_loop(enc_pre, torch.from_numpy(lens), h0, c0, pred0,
                           last0, off,
                           DecodeWeights.from_model(model, torch.float32),
                           blank_id=cfg.blank_id, **kw)


LOOP_CASES = {
    "random_batch": dict(b=4, t=21, lens=[21, 13, 1, 7], bias=0.0,
                         kw=dict(max_symbols=30, max_total=200, lookahead=8)),
    "max_symbols_pressure": dict(b=3, t=9, lens=[9, 9, 5], bias=-4.0,
                                 kw=dict(max_symbols=3, max_total=20,
                                         lookahead=4)),
    "max_total_budget": dict(b=2, t=30, lens=[30, 30], bias=-4.0,
                             kw=dict(max_symbols=30, max_total=5,
                                     lookahead=8)),
}


@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_loop_matches_jax_xla_and_pallas(tiny, case):
    jm, params, model = tiny
    c = LOOP_CASES[case]
    if c["bias"]:
        params, model = with_joint_bias(jm, params, model, c["bias"])
    rng = np.random.default_rng(0)
    enc = rng.standard_normal((c["b"], c["t"], jm.config.d_enc)).astype(
        np.float32)
    lens = np.asarray(c["lens"], np.int32)
    got = torch_result(run_loop(model, enc, lens, **c["kw"]))
    ref = jax_greedy(jm, params, jnp.asarray(enc), jnp.asarray(lens),
                     **c["kw"])
    assert_same(got, ref)
    # the TPU kernel (interpret mode) from the same SOS state
    cfg = jm.config
    b = c["b"]
    h0, c0 = jm.init_state(b)
    pred0, (h0, c0) = jm.predict_step(
        params, jnp.full((b,), cfg.blank_id, jnp.int32), (h0, c0))
    enc_pre = jm.joint_precompute_enc(params, jnp.asarray(enc))
    toks, counts, frames, confs, st, p_out, last = greedy_loop_pallas(
        enc_pre, jnp.asarray(lens), h0, c0, pred0,
        jnp.full((b,), cfg.blank_id, jnp.int32), jnp.zeros((b,), jnp.int32),
        params["predictor"], params["joint"], blank_id=cfg.blank_id,
        interpret=True, **c["kw"])
    assert_same(got, dataclasses.replace(
        ref, tokens=toks, counts=counts, frame_idx=frames, confidence=confs,
        state=st, pred_out=p_out, last_token=last))


def test_carry_resume_and_token_offset_match_pallas(tiny):
    """Chunk 1 -> carried state -> chunk 2 with ``token_offset`` = chunk 1's
    count: the budget and the emit slots count from the offset."""
    jm, params, model = tiny
    cfg = jm.config
    rng = np.random.default_rng(2)
    b, t = 2, 10
    enc1, enc2 = (rng.standard_normal((b, t, cfg.d_enc)).astype(np.float32)
                  for _ in range(2))
    lens = np.full((b,), t, np.int32)
    kw = dict(max_symbols=30, max_total=40, lookahead=8)
    first = run_loop(model, enc1, lens, **kw)
    second = run_loop(model, enc2, lens, carry=first,
                      token_offset=first.counts, **kw)

    def pallas(enc, h0, c0, pred0, last0, off):
        out = greedy_loop_pallas(
            jm.joint_precompute_enc(params, jnp.asarray(enc)),
            jnp.asarray(lens), h0, c0, pred0, last0, off,
            params["predictor"], params["joint"], blank_id=cfg.blank_id,
            interpret=True, **kw)
        toks, counts, frames, confs, st, p_out, last = out
        return dataclasses.replace(
            torch_result(first), tokens=toks, counts=counts,
            frame_idx=frames, confidence=confs, state=st, pred_out=p_out,
            last_token=last)

    h0, c0 = jm.init_state(b)
    pred0, (h0, c0) = jm.predict_step(
        params, jnp.full((b,), cfg.blank_id, jnp.int32), (h0, c0))
    ref1 = pallas(enc1, h0, c0, pred0, jnp.full((b,), cfg.blank_id,
                                                jnp.int32),
                  jnp.zeros((b,), jnp.int32))
    ref2 = pallas(enc2, *ref1.state, ref1.pred_out, ref1.last_token,
                  jnp.asarray(ref1.counts))
    assert_same(torch_result(first), ref1)
    assert_same(torch_result(second), ref2)


def test_model_bound_decode_matches_jax_with_carry(tiny):
    jm, params, model = tiny
    rng = np.random.default_rng(4)
    enc = rng.standard_normal((2, 16, jm.config.d_enc)).astype(np.float32)
    lens = np.array([16, 11], np.int32)
    ref1 = jax_greedy(jm, params, jnp.asarray(enc[:, :8]),
                      jnp.asarray(np.minimum(lens, 8)))
    ref2 = jax_greedy(jm, params, jnp.asarray(enc[:, 8:]),
                      jnp.asarray(lens - 8), carry=ref1)
    with torch.no_grad():
        got1 = greedy_decode_transducer(
            model, torch.from_numpy(enc[:, :8]),
            torch.from_numpy(np.minimum(lens, 8)))
        got2 = greedy_decode_transducer(
            model, torch.from_numpy(enc[:, 8:]), torch.from_numpy(lens - 8),
            carry=got1)
    assert_same(torch_result(got1), ref1)
    assert_same(torch_result(got2), ref2)


def test_bf16_reference_rounds_state_to_working_type(tiny):
    """The plain loop in bf16 stores h, c and pred_out in bf16, as the
    kernel does, and still decodes (finite confidences, tokens in range)."""
    jm, params, model = tiny
    cfg = jm.config
    rng = np.random.default_rng(5)
    enc = torch.from_numpy(rng.standard_normal((2, 12, cfg.d_enc)).astype(
        np.float32))
    with torch.no_grad():
        enc_pre = model.joint_precompute_enc(enc).to(torch.bfloat16)
        blank = torch.full((2,), cfg.blank_id, dtype=torch.int32)
        pred0, (h0, c0) = model.predict_step(blank, model.init_state(2))
        res = greedy_loop(
            enc_pre, torch.tensor([12, 5]), h0.bfloat16(), c0.bfloat16(),
            pred0.bfloat16(), blank, torch.zeros(2, dtype=torch.int32),
            DecodeWeights.from_model(model, torch.bfloat16),
            blank_id=cfg.blank_id, max_symbols=30, max_total=50)
    assert res.state[0].dtype == res.pred_out.dtype == torch.bfloat16
    assert torch.isfinite(res.confidence).all()
    for i, n in enumerate(res.counts.tolist()):
        toks = res.tokens[i, :n]
        assert ((toks >= 0) & (toks < cfg.vocab_size)
                & (toks != cfg.blank_id)).all()


@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_bf16_loop_matches_pallas(tiny, case):
    """bf16, the served type: the wrapper's CPU path against the TPU kernel
    (interpret mode) on the same bf16 ``enc_pre``, weights and SOS state.
    Both accumulate in f32 and round h, c, pred_out and the joint hidden
    vector to bf16 at the same points, so the decisions are identical.
    Carried state agrees within 8e-3 relative, one bf16 ulp (a last-bit
    flip from f32 summation order). Confidences are f32 and agree within
    2e-4 relative / 5e-5 absolute; rounding the joint hidden vector or the
    projected prediction at another point than the kernel moves them by
    3e-4 or more."""
    jm, params, model = tiny
    c = LOOP_CASES[case]
    if c["bias"]:
        params, model = with_joint_bias(jm, params, model, c["bias"])
    cfg = jm.config
    b = c["b"]
    rng = np.random.default_rng(6)
    enc = rng.standard_normal((b, c["t"], cfg.d_enc)).astype(np.float32)
    lens = np.asarray(c["lens"], np.int32)
    enc_pre = jm.joint_precompute_enc(params, jnp.asarray(enc)).astype(
        jnp.bfloat16)
    pred0, (h0, c0) = jm.predict_step(
        params, jnp.full((b,), cfg.blank_id, jnp.int32), jm.init_state(b))
    blank = np.full((b,), cfg.blank_id, np.int32)
    toks, counts, frames, confs, st, p_out, last = greedy_loop_pallas(
        enc_pre, jnp.asarray(lens), h0, c0, pred0, jnp.asarray(blank),
        jnp.zeros((b,), jnp.int32), params["predictor"], params["joint"],
        blank_id=cfg.blank_id, interpret=True, **c["kw"])

    def bf16(x):
        return torch.from_numpy(np.array(x, np.float32)).bfloat16()

    got = greedy_loop(
        bf16(enc_pre), torch.from_numpy(lens), bf16(h0), bf16(c0),
        bf16(pred0), torch.from_numpy(blank), torch.zeros(b, dtype=torch.int32),
        DecodeWeights.from_model(model, torch.bfloat16),
        blank_id=cfg.blank_id, **c["kw"])
    n = np.asarray(counts)
    np.testing.assert_array_equal(got.counts.numpy(), n)
    np.testing.assert_array_equal(got.last_token.numpy(), np.asarray(last))
    for i, k in enumerate(n):
        np.testing.assert_array_equal(got.tokens[i, :k].numpy(),
                                      np.asarray(toks)[i, :k])
        np.testing.assert_array_equal(got.frame_idx[i, :k].numpy(),
                                      np.asarray(frames)[i, :k])
        np.testing.assert_allclose(got.confidence[i, :k].numpy(),
                                   np.asarray(confs)[i, :k], rtol=2e-4,
                                   atol=5e-5)
    for g, r in ((got.state[0], st[0]), (got.state[1], st[1]),
                 (got.pred_out, p_out)):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(r, np.float32), rtol=8e-3,
                                   atol=1e-5)


def unpack_columns(packed: torch.Tensor, n: int,
                   groups: int = 1) -> torch.Tensor:
    """The inverse of ``decode_loop.pack_columns`` for ``n`` columns per
    group: ``[blocks, K, groups * width]`` -> ``[K, groups * n]`` (a vector
    ``[blocks, groups * width]`` -> ``[groups * n]``)."""
    vec = packed.dim() == 2
    if vec:
        packed = packed[:, None]
    blocks, k, gw = packed.shape
    width = gw // groups
    out = (packed.reshape(blocks, k, groups, width).permute(1, 2, 0, 3)
           .reshape(k, groups, blocks * width)[:, :, :n]
           .reshape(k, groups * n))
    return out[0] if vec else out


def unpack_rows4(words: torch.Tensor) -> torch.Tensor:
    """The inverse of ``decode_loop.pack_rows4``: int32 ``[K / 4, N]`` ->
    int8 ``[K, N]``."""
    kw, n = words.shape
    return (words.contiguous().view(torch.int8).reshape(kw, n, 4)
            .permute(0, 2, 1).reshape(4 * kw, n))


# quant: False (bf16, the tensor-core plan), True (the int8 LSTM on the
# FMA plan, odd pb allowed) and "tensor_cores" (the int8 LSTM on the
# tensor-core plan the int8 kernels take: pb even)
@pytest.mark.parametrize("max_blocks", [3, 7, 132])
@pytest.mark.parametrize("quant", [False, True, "tensor_cores"])
def test_block_slices_unpack_to_weights(tiny, max_blocks, quant):
    """The decode kernel's per-block weight slices (``block_slices``) hold
    the weights exactly: unpacking each gives the original matrix, bias or
    int8 half (``quantize_pred_lstm``'s, with its scales), and the padding
    past each width is zero."""
    from amira_rust_asr_server_tpu_torch.ops.kernels.decode_loop import \
        slice_plan
    _, _, model = tiny
    w = DecodeWeights.from_model(model, torch.bfloat16)
    if quant:
        w = w.with_int8_lstm()
    p, j = w.wp.shape
    v = w.wo.shape[1]
    fma_plan = quant is True
    blocks, pb, jb, vb = slice_plan(p, j, v, max_blocks,
                                    tensor_cores=not fma_plan)
    assert blocks <= max_blocks and (blocks - 1) * pb < p <= blocks * pb
    align = 2 if fma_plan else 8
    assert 4 * pb % align == jb % align == vb % align == 0
    assert blocks * jb >= j and blocks * vb >= v
    sl = w.block_slices(blocks, pb, jb, vb)
    assert sl is w.block_slices(blocks, pb, jb, vb)  # packed once
    want = {"w0s": (w.w0, 4), "b0s": (w.b0, 4), "w1s": (w.w1, 4),
            "b1s": (w.b1, 4), "wps": (w.wp, 1), "bps": (w.bp, 1),
            "wos": (w.wo, 1), "bos": (w.bo, 1)}
    if quant:
        qw = w.quant_words
        want.update(wq0s=(torch.cat([qw["wx0"], qw["wh0"]]), 4),
                    wq1s=(torch.cat([qw["wx1"], qw["wh1"]]), 4),
                    **{k + "s": (w.quant[k], 4)
                       for k in ("sx0", "sh0", "sx1", "sh1")})
    assert set(sl) == set(want)
    for name, (orig, groups) in want.items():
        packed = sl[name]
        assert packed.shape[0] == blocks and packed.dtype == orig.dtype
        n = orig.shape[-1] // groups
        assert torch.equal(unpack_columns(packed, n, groups), orig), name
        assert int((packed != 0).sum()) == int((orig != 0).sum()), name
    if quant == "tensor_cores":  # the words are quantize_pred_lstm's halves
        for layer in (0, 1):
            x_rows = w.quant[f"wx{layer}_q"].shape[0]
            got = unpack_rows4(unpack_columns(sl[f"wq{layer}s"], p, 4))
            assert torch.equal(got[:x_rows], w.quant[f"wx{layer}_q"])
            assert torch.equal(got[x_rows:], w.quant[f"wh{layer}_q"])


@pytest.mark.parametrize("d_embed", [48, 20])
def test_int8_block_slices_pad_halves(d_embed):
    """An x half whose width is not a multiple of 32 (48, 20 inputs): the
    int8 words of each half are zero-padded to a multiple of 8 words (the
    int8 tensor cores' k-step), unpack to ``quantize_pred_lstm``'s halves,
    and the gates computed from the padded per-block slices, as the kernels
    compute them (zero-padded quantized inputs, exact integer sums, then
    ``acc * (s * ws)`` per half plus the bias), equal the plain int8 gates
    (``_qdot``) exactly."""
    from amira_rust_asr_server_tpu_torch.models import get_preset
    from amira_rust_asr_server_tpu_torch.ops.kernels.decode_loop import (
        _qdot, pad_words, quant_scale, slice_plan)
    cfg = dataclasses.replace(get_preset("tiny"), n_layers=0, d_embed=d_embed)
    model = Transducer(cfg).init_weights(torch.Generator().manual_seed(4))
    w = DecodeWeights.from_model(model, torch.float32).with_int8_lstm()
    p, j = w.wp.shape
    blocks, pb, jb, vb = slice_plan(p, j, w.wo.shape[1], 5,
                                    tensor_cores=True)
    sl = w.block_slices(blocks, pb, jb, vb)
    rng = np.random.default_rng(d_embed)
    b = 3
    for layer, d_x in ((0, d_embed), (1, p)):
        qx, qh = w.quant[f"wx{layer}_q"], w.quant[f"wh{layer}_q"]
        xw = pad_words(w.quant_words[f"wx{layer}"]).shape[0]
        hw = pad_words(w.quant_words[f"wh{layer}"]).shape[0]
        assert xw % 8 == hw % 8 == 0 and 4 * xw >= d_x and 4 * hw >= p
        got = unpack_rows4(unpack_columns(sl[f"wq{layer}s"], p, 4))
        assert got.shape[0] == 4 * (xw + hw)
        assert torch.equal(got[:d_x], qx)
        assert not got[d_x:4 * xw].any()  # the x half's padding
        assert torch.equal(got[4 * xw:4 * xw + p], qh)
        assert not got[4 * xw + p:].any()  # the h half's padding
        x = torch.from_numpy(rng.standard_normal((b, d_x)).astype(np.float32))
        h = torch.from_numpy(rng.standard_normal((b, p)).astype(np.float32))
        bias = w.b0 if layer == 0 else w.b1
        want = (_qdot(x, qx.double(), w.quant[f"sx{layer}"])
                + _qdot(h, qh.double(), w.quant[f"sh{layer}"]) + bias)
        # per block, as the kernels read their slices
        sx, sh = (quant_scale(v.abs().amax(dim=1, keepdim=True))
                  for v in (x, h))
        xq = torch.zeros((b, 4 * (xw + hw)), dtype=torch.float64)
        xq[:, :d_x] = torch.round(x / sx).double()
        xq[:, 4 * xw:4 * xw + p] = torch.round(h / sh).double()
        gates = []
        for g in range(blocks):
            words = unpack_rows4(sl[f"wq{layer}s"][g]).double()
            acc_x = (xq[:, :4 * xw] @ words[:4 * xw]).float()
            acc_h = (xq[:, 4 * xw:] @ words[4 * xw:]).float()
            gates.append(acc_x * (sx * sl[f"sx{layer}s"][g])
                         + acc_h * (sh * sl[f"sh{layer}s"][g])
                         + sl[f"b{layer}s"][g])
        got_gates = unpack_columns(torch.stack(gates), p, 4)
        assert torch.equal(got_gates, want)


# -- the loop as steps (greedy_init / greedy_step) ----------------------------
@pytest.fixture(scope="module")
def by_depth():
    """{layers: (JAX model, params, port model)} for tiny nets with 1, 2
    and 3 prediction layers (blank bias +1.5), JAX-initialized."""
    out = {}
    for layers in (1, 2, 3):
        cfg = dataclasses.replace(JaxTransducer.from_preset("tiny").config,
                                  pred_layers=layers)
        jm = JaxTransducer(cfg)
        params = jm.init(jax.random.PRNGKey(layers))
        params["joint"]["out"]["b"] = (
            params["joint"]["out"]["b"].at[cfg.blank_id].add(1.5))
        model = Transducer(cfg)
        model.load_state_dict(from_jax_params(jax.device_get(params), cfg))
        out[layers] = (jm, params, model.eval())
    return out


STEP_KW = dict(max_symbols=3, max_total=40, lookahead=4)


def step_case(model, seed=3):
    cfg = model.config
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((3, 17, cfg.d_enc)).astype(np.float32)
    lens = np.asarray([17, 9, 2], np.int32)
    with torch.no_grad():
        enc_pre = model.joint_precompute_enc(torch.from_numpy(enc))
    return enc, lens, enc_pre, model.init_state(3)


def blocks(model, enc_pre, lens, state, n):
    """The loop in blocks of ``n`` steps, the host asking once per block
    (as the step route's captured programs do): (result, host reads,
    steps run)."""
    cfg = model.config
    with torch.no_grad():
        loop = greedy_init(model.predict_step, enc_pre,
                           torch.from_numpy(lens), state, cfg.blank_id,
                           max_total=STEP_KW["max_total"])
        reads = steps = 0
        while True:
            reads += 1
            if not bool(greedy_active(loop, STEP_KW["max_total"]).any()):
                return greedy_result(loop), reads, steps
            for _ in range(n):
                loop = greedy_step(loop, model.predict_step,
                                   model.joint_step_pre, cfg.blank_id,
                                   **STEP_KW)
                steps += 1


def test_steps_past_termination_are_no_ops(by_depth):
    """Once every lane is done a step neither emits, skips nor is forced:
    every tensor of the loop's state stays bit for bit."""
    _, _, model = by_depth[2]
    _, lens, enc_pre, state = step_case(model)
    done, _, steps = blocks(model, enc_pre, lens, state, 1)
    assert steps > 0 and done.counts.sum() > 0
    with torch.no_grad():
        loop = greedy_init(model.predict_step, enc_pre,
                           torch.from_numpy(lens), state,
                           model.config.blank_id,
                           max_total=STEP_KW["max_total"])
        for _ in range(steps):
            loop = greedy_step(loop, model.predict_step,
                               model.joint_step_pre, model.config.blank_id,
                               **STEP_KW)
        assert not greedy_active(loop, STEP_KW["max_total"]).any()
        before = [x.clone() for x in loop.tensors()]
        for _ in range(5):
            loop = greedy_step(loop, model.predict_step,
                               model.joint_step_pre, model.config.blank_id,
                               **STEP_KW)
    for a, b in zip(loop.tensors(), before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [1, 3, 8, 64])
@pytest.mark.parametrize("layers", [1, 2, 3])
def test_blocks_of_steps_equal_greedy_decode(by_depth, layers, n):
    """The loop run in blocks of ``n`` steps gives greedy_decode's result
    bit for bit and JAX's per-step greedy decode's (f32), on 1-, 2- and
    3-layer prediction nets; the host reads once per block and once at
    the start, at most ceil(steps / n) + 1 times."""
    jm, params, model = by_depth[layers]
    enc, lens, enc_pre, state = step_case(model)
    got, reads, _ = blocks(model, enc_pre, lens, state, n)
    _, _, steps = blocks(model, enc_pre, lens, state, 1)
    with torch.no_grad():
        want = greedy_decode(model.predict_step, model.joint_step_pre,
                             enc_pre, torch.from_numpy(lens), state,
                             model.config.blank_id, **STEP_KW)
    for a, b in zip((got.tokens, got.counts, got.frame_idx, got.confidence,
                     *got.state, got.pred_out, got.last_token),
                    (want.tokens, want.counts, want.frame_idx,
                     want.confidence, *want.state, want.pred_out,
                     want.last_token)):
        assert torch.equal(a, b)
    assert reads <= -(-steps // n) + 1 and got.counts.sum() > 0
    assert_same(torch_result(got), jax_greedy(
        jm, params, jnp.asarray(enc), jnp.asarray(lens), **STEP_KW))
