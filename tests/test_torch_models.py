"""PyTorch port: the weight converter, conformer encoder, prediction net and
joint against the JAX reference.

Parameters are drawn with numpy in the reference's layout (nonzero biases,
non-unit norm scales, so a wrong transpose or a dropped bias shows), fed to
the JAX modules as they are and to the port through
``convert.from_jax_params``. Both sides run in f32 on the CPU; the
tolerances (1e-4 on encoder outputs of magnitude ~5, 1e-5 on the LSTM and
joint) cover f32 summation order only.

Configs: ``tiny``, ``tiny`` with LayerScale, the causal ``tiny-streaming``
(left-only pads, banded attention) and one block of ``large`` at full width
on 1.5 s of features, which pins at real width the flax LayerNorm eps, the
asymmetric stride-2 SAME padding, the RoPE halves and the -1e9 mask.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amira_rust_asr_server_tpu.models import Transducer as JaxTransducer
from amira_rust_asr_server_tpu.models import encoder as jax_encoder
from amira_rust_asr_server_tpu.models.presets import (LARGE, TINY,
                                                      TINY_STREAMING)
from amira_rust_asr_server_tpu_torch.convert import from_jax_params
from amira_rust_asr_server_tpu_torch.models import Transducer, encoder
from amira_rust_asr_server_tpu_torch.models.presets import \
    LARGE as TORCH_LARGE

torch.set_num_threads(2)

CONFIGS = {
    "tiny": TINY,
    "tiny-layerscale": dataclasses.replace(TINY, layerscale=0.1),
    "tiny-streaming": TINY_STREAMING,
    "large-1block": dataclasses.replace(LARGE, n_layers=1),
}


def numpy_params(cfg, seed=0):
    """A random param tree of the reference's structure, without running
    (and compiling) the JAX init."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda: JaxTransducer(cfg).init(jax.random.PRNGKey(0)))

    def draw(path, leaf):
        name = str(path[-1])
        shape = leaf.shape
        if "kernel" in name or name == "['w']":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
                np.float32)
        if "embed" in name:
            return (rng.standard_normal(shape) / np.sqrt(shape[-1])).astype(
                np.float32)
        if "scale" in name:
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if "ls_" in name:
            return (0.1 + 0.02 * rng.standard_normal(shape)).astype(
                np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    cfg = CONFIGS[request.param]
    params = numpy_params(cfg)
    model = Transducer(cfg)
    model.load_state_dict(from_jax_params(params, cfg))
    return cfg, params, model.eval()


def test_converter_loads_every_param(pair):
    cfg, params, model = pair
    n_jax = sum(x.size for x in jax.tree_util.tree_leaves(params))
    assert model.param_count() == n_jax
    enc = params["encoder"]
    np.testing.assert_array_equal(
        model.encoder.subsampler.conv0.weight.detach().numpy(),
        enc["subsampler"]["conv0"]["kernel"].transpose(2, 1, 0))
    np.testing.assert_array_equal(
        model.encoder.block0.mhsa.qkv.weight.detach().numpy(),
        enc["block0"]["mhsa"]["qkv"]["kernel"].T)
    np.testing.assert_array_equal(
        model.encoder.block0.ln_out.weight.detach().numpy(),
        enc["block0"]["ln_out"]["scale"])
    np.testing.assert_array_equal(
        model.predictor.lstm[1].w.detach().numpy(),
        params["predictor"]["lstm"][1]["w"])


def test_large_preset_param_count():
    with torch.device("meta"):
        model = Transducer(TORCH_LARGE)
    assert model.param_count() == 421_818_886


def test_encoder_matches_jax(pair):
    cfg, params, model = pair
    rng = np.random.default_rng(1)
    t = 151  # 1.5 s of 10 ms frames
    feats = rng.standard_normal((3, cfg.n_mels, t)).astype(np.float32)
    lens = np.array([151, 97, 40], np.int32)
    ref, ref_lens = JaxTransducer(cfg).encode(params, jnp.asarray(feats),
                                              jnp.asarray(lens))
    with torch.no_grad():
        got, got_lens = model.encode(torch.from_numpy(feats),
                                     torch.from_numpy(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(ref_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


def test_pred_step_and_joint_match_jax(pair):
    cfg, params, model = pair
    jm = JaxTransducer(cfg)
    rng = np.random.default_rng(2)
    b = 5
    tokens = rng.integers(0, cfg.vocab_size, b).astype(np.int32)
    tokens[0] = cfg.blank_id  # blank embeds to zero
    h = rng.standard_normal((cfg.pred_layers, b, cfg.d_pred)).astype(
        np.float32)
    c = rng.standard_normal((cfg.pred_layers, b, cfg.d_pred)).astype(
        np.float32)
    ref_out, (ref_h, ref_c) = jm.predict_step(
        params, jnp.asarray(tokens), (jnp.asarray(h), jnp.asarray(c)))
    enc = rng.standard_normal((b, 7, cfg.d_enc)).astype(np.float32)
    ref_pre = jm.joint_precompute_enc(params, jnp.asarray(enc))
    ref_logits = jm.joint_step_pre(params, ref_pre[:, 3], ref_out)
    with torch.no_grad():
        out, (nh, nc) = model.predict_step(
            torch.from_numpy(tokens), (torch.from_numpy(h),
                                       torch.from_numpy(c)))
        pre = model.joint_precompute_enc(torch.from_numpy(enc))
        logits = model.joint_step_pre(pre[:, 3], out)
    for got, ref in ((out, ref_out), (nh, ref_h), (nc, ref_c),
                     (pre, ref_pre), (logits, ref_logits)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)


def test_layernorm_eps_matches_flax():
    """At low variance eps dominates: torch's default 1e-5 would be off by
    far more than the tolerance here."""
    x = (1e-3 * np.random.default_rng(3).standard_normal((4, 64))).astype(
        np.float32)
    ref = fnn.LayerNorm().apply({"params": {
        "scale": jnp.ones(64), "bias": jnp.zeros(64)}}, jnp.asarray(x))
    with torch.no_grad():
        got = encoder.LayerNorm(64)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_rope_rotates_halves_like_jax():
    x = np.random.default_rng(4).standard_normal((2, 3, 300, 16)).astype(
        np.float32)
    ref = jax_encoder._rope(jnp.asarray(x))
    got = encoder.rope(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("t,k,s", [(151, 5, 2), (76, 5, 2), (37, 9, 1),
                                   (10, 5, 2)])
def test_same_padding_matches_xla(t, k, s):
    lo, hi = encoder._same_pad(t, k, s)
    ref = jax.lax.padtype_to_pads((t,), (k,), (s,), "SAME")[0]
    assert (lo, hi) == tuple(ref)


def test_moe_is_rejected():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Transducer(dataclasses.replace(TORCH_LARGE, n_layers=1,
                                       moe_experts=4))
