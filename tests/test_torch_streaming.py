"""PyTorch port: the streaming encoder (``ops/streaming.py``) against the
JAX package's, on the ``tiny-streaming`` preset with JAX-initialized weights
carried across by ``convert.from_jax_params``.

Tolerances: one chunk step against JAX's ``encode_chunk``, f32, within
1e-5 (two backends, the same arithmetic); chunked against the full causal
forward, and one chunking against another, within atol 2e-4 / rtol 1e-3
(the reference's own bound, PARITY.md); the cache's bookkeeping and the
masked keep exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amira_rust_asr_server_tpu.models import Transducer as JaxTransducer
from amira_rust_asr_server_tpu.models.encoder import _rope as jax_rope
from amira_rust_asr_server_tpu.models.presets import \
    TINY_STREAMING as JAX_TINY_STREAMING
from amira_rust_asr_server_tpu.ops.streaming import \
    encode_chunk as jax_encode_chunk
from amira_rust_asr_server_tpu.ops.streaming import \
    init_encoder_cache as jax_init_cache
from amira_rust_asr_server_tpu_torch.convert import from_jax_params
from amira_rust_asr_server_tpu_torch.models import Transducer
from amira_rust_asr_server_tpu_torch.models.encoder import rope
from amira_rust_asr_server_tpu_torch.models.presets import TINY_STREAMING
from amira_rust_asr_server_tpu_torch.ops.streaming import (encode_chunk,
                                                           init_encoder_cache)

torch.set_num_threads(2)


def model_pair(layerscale: float = 0.0, seed: int = 0):
    """The JAX tiny-streaming model with JAX-initialized params, and the
    port's model on the converted params (f32, eval)."""
    jcfg = dataclasses.replace(JAX_TINY_STREAMING, layerscale=layerscale)
    jm = JaxTransducer(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    model = Transducer(dataclasses.replace(TINY_STREAMING,
                                           layerscale=layerscale))
    model.load_state_dict(from_jax_params(jax.device_get(params),
                                          model.config))
    return jm, params, model.eval()


@pytest.fixture(scope="module")
def pair():
    return model_pair()


def feats(seed: int, b: int, t: int, n_mels: int = 32) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (b, n_mels, t)).astype(np.float32)


def chunked(model, f: np.ndarray, step: int) -> np.ndarray:
    cache = init_encoder_cache(model.config, f.shape[0])
    outs = []
    with torch.no_grad():
        for i in range(0, f.shape[2], step):
            enc, cache = encode_chunk(model.encoder,
                                      torch.from_numpy(f[:, :, i:i + step]),
                                      cache)
            outs.append(enc.numpy())
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize("layerscale", [0.0, 0.1])
def test_encode_chunk_matches_jax(layerscale):
    """Four chunk steps over two lanes, the caches carried on both sides:
    every step's output within 1e-5 of JAX's, and the carried caches too."""
    jm, params, model = model_pair(layerscale, seed=1)
    f = feats(0, 2, 64)
    cache = init_encoder_cache(model.config, 2)
    jcache = jax_init_cache(jm.config, batch=2)
    with torch.no_grad():
        for i in range(0, 64, 16):
            got, cache = encode_chunk(model.encoder,
                                      torch.from_numpy(f[:, :, i:i + 16]),
                                      cache)
            want, jcache = jax_encode_chunk(params["encoder"], jm.config,
                                            jnp.asarray(f[:, :, i:i + 16]),
                                            jcache)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5, rtol=0)
    for layer in range(model.config.n_layers):
        np.testing.assert_allclose(cache.attn_k[layer].numpy(),
                                   np.asarray(jcache.attn_k[layer]),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(cache.conv_tail[layer].numpy(),
                                   np.asarray(jcache.conv_tail[layer]),
                                   atol=1e-5, rtol=0)
    # stage 0 caches the features themselves, later stages conv outputs
    np.testing.assert_array_equal(cache.sub_inputs[0].numpy(),
                                  np.asarray(jcache.sub_inputs[0]))
    for got, want in zip(cache.sub_inputs[1:], jcache.sub_inputs[1:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)
    np.testing.assert_array_equal(cache.pos.numpy(), np.asarray(jcache.pos))


def test_int8_model_chunks_in_the_working_type():
    """With the int8 serving path frozen (``quantization="int8"``), the
    chunk encoder still reads every dense layer's unquantized weights,
    attention's too, as the reference's chunk encoder does: its steps
    equal JAX's ``encode_chunk`` on the same params within 1e-5."""
    jm, params, model = model_pair(seed=1)
    model.freeze_int8()
    assert model.encoder.block0.mhsa.qkv.quant
    f = feats(2, 1, 32)
    cache = init_encoder_cache(model.config, 1)
    jcache = jax_init_cache(jm.config, batch=1)
    with torch.no_grad():
        for i in range(0, 32, 16):
            got, cache = encode_chunk(model.encoder,
                                      torch.from_numpy(f[:, :, i:i + 16]),
                                      cache)
            want, jcache = jax_encode_chunk(params["encoder"], jm.config,
                                            jnp.asarray(f[:, :, i:i + 16]),
                                            jcache)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5, rtol=0)


def test_chunked_equals_full(pair):
    _, _, model = pair
    f = feats(0, 1, 64)
    with torch.no_grad():
        full, _ = model.encode(torch.from_numpy(f), torch.tensor([64]))
    streamed = chunked(model, f, 16)
    assert streamed.shape == tuple(full.shape)
    np.testing.assert_allclose(streamed, full.numpy(), atol=2e-4, rtol=1e-3)


def test_chunk_size_invariance(pair):
    _, _, model = pair
    f = feats(1, 1, 48)
    outs = [chunked(model, f, step) for step in (8, 16, 24)]
    np.testing.assert_allclose(outs[0], outs[1], atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(outs[0], outs[2], atol=2e-4, rtol=1e-3)


def test_cache_pos_advances(pair):
    _, _, model = pair
    cache = init_encoder_cache(model.config, 1)
    assert int(cache.pos[0]) == 0
    with torch.no_grad():
        enc, cache = encode_chunk(model.encoder,
                                  torch.from_numpy(feats(2, 1, 16)), cache)
    assert enc.shape == (1, 4, model.config.d_enc)
    assert int(cache.pos[0]) == 4  # 16 mel frames / subsampling 4
    assert cache.pos.dtype == torch.int32


def test_layerscale_chunked_equals_full():
    """LayerScale gains stream as they batch, and change the output."""
    _, params, model = model_pair(0.1, seed=1)
    assert "encoder.block0.ls_ff1" in model.state_dict()
    f = feats(3, 1, 48)
    with torch.no_grad():
        full, _ = model.encode(torch.from_numpy(f), torch.tensor([48]))
    np.testing.assert_allclose(chunked(model, f, 16), full.numpy(),
                               atol=2e-4, rtol=1e-3)
    _, _, plain = model_pair(0.0, seed=1)
    with torch.no_grad():
        other, _ = plain.encode(torch.from_numpy(f), torch.tensor([48]))
    assert np.abs(other.numpy() - full.numpy()).max() > 1e-3


def test_rope_offsets_match_jax():
    """Per-lane absolute positions, as JAX's ``_rope(x, pos_offset=[B])``."""
    x = np.random.default_rng(4).standard_normal((3, 2, 5, 8)).astype(
        np.float32)
    offs = np.array([0, 7, 130], np.int32)
    got = rope(torch.from_numpy(x), torch.from_numpy(offs)).numpy()
    want = np.asarray(jax_rope(jnp.asarray(x), pos_offset=jnp.asarray(offs)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(
        rope(torch.from_numpy(x), torch.zeros(3, dtype=torch.int32)).numpy(),
        rope(torch.from_numpy(x)).numpy())


def test_keep_and_reset_leave_other_lanes_bit_identical(pair):
    """The lane engine's masked keep takes a step on the active lanes only;
    a lane reset zeroes that lane alone."""
    _, _, model = pair
    cache = init_encoder_cache(model.config, 3)
    with torch.no_grad():
        _, cache = encode_chunk(model.encoder,
                                torch.from_numpy(feats(5, 3, 16)), cache)
        before = [t.clone() for t in cache.tensors()]
        _, new = encode_chunk(model.encoder,
                              torch.from_numpy(feats(6, 3, 16)), cache)
        cache.keep_(torch.tensor([True, False, True]), new)
    lane_axis = [0] * len(cache.sub_inputs) + [1, 1, 1, 0]
    for got, old, upd, ax in zip(cache.tensors(), before, new.tensors(),
                                 lane_axis):
        assert torch.equal(got.select(ax, 1), old.select(ax, 1))
        assert torch.equal(got.select(ax, 0), upd.select(ax, 0))
        assert torch.equal(got.select(ax, 2), upd.select(ax, 2))
    cache.reset_lane(2)
    for got, ax in zip(cache.tensors(), lane_axis):
        assert not got.select(ax, 2).any()
        assert got.select(ax, 0).any()
