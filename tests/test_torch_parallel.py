"""PyTorch port: the device mesh (``parallel/mesh.py``, ``models/tp.py``),
sharded serving, the sharded train step, the sequence-parallel loss and
GPipe (``parallel/pipeline.py``) against the unsharded port and the JAX
package: the cases of ``tests/test_parallel.py``,
``tests/test_parallel_axes.py`` and ``tests/test_moe.py``'s sharded ones.

The placement rule runs here against JAX's specs on its virtual mesh. The
rest runs in worlds of 2 and 4 ranks over gloo (``parallel/launch.
spawn_world``: a ``file://`` store, one thread per rank, a deadline), one
world per mesh shape ``(data, model)`` in {1x2, 2x1, 2x2}, each check its
own test (``tests/test_torch_parallel_launch.py`` holds the launcher, the
dryrun and the training CLI under torchrun). The ranks import torch and
the port only (``tests/_torch_parallel_ranks.py``): the JAX oracle runs here, writes
its converted weights and the inputs to an ``.npz`` the ranks read, and
holds what they return.

Tolerances: the tensor-parallel encoder atol 2e-4 / rtol 1e-3 (the
reference's; the partial sums of row-parallel layers add in another
order), the expert-parallel encoder rtol 1e-3 / atol 2e-4, the pipelined
encoder 1e-5 and its gradients atol 1e-4 (the reference's); tokens
identical; train-step losses rtol 2e-4 of the unsharded port's and of
JAX's, the gradient norm rtol 2e-4, the weights after one AdamW step
within 2 x lr (a sign flip of a gradient near 0, as
``tests/test_torch_train.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from amira_rust_asr_server_tpu.models import Transducer as JaxTransducer
from amira_rust_asr_server_tpu.models.ctc import CTCModel as JaxCTC
from amira_rust_asr_server_tpu.models.presets import TINY as JAX_TINY
from amira_rust_asr_server_tpu.parallel import mesh as jax_mesh
from amira_rust_asr_server_tpu.parallel import train as jax_train
from amira_rust_asr_server_tpu_torch.convert import (MODELS, from_jax_params,
                                                     jax_leaf)
from amira_rust_asr_server_tpu_torch.models.reference_init import \
    init_reference_weights
from amira_rust_asr_server_tpu_torch.models.tp import DATA_AXIS, MODEL_AXIS
from amira_rust_asr_server_tpu_torch.parallel.launch import spawn_world
from amira_rust_asr_server_tpu_torch.parallel.mesh import param_placements
from amira_rust_asr_server_tpu_torch.parallel.pipeline import \
    stack_block_params

import _torch_parallel_ranks as ranks

# the configurations whose weights come from JAX's init (the others from
# the port's copy of it, models/reference_init.py), by name: (model, seed)
JAX_CONFIGS = {
    "tiny": (JaxTransducer, 0),
    "moe": (JaxTransducer, 1),
    "ctc": (JaxCTC, 3),
}
PORT_SEEDS = {"stream": 2, "deep": 4}
SHAPES = [(1, 2), (2, 1), (2, 2)]
WORLD_S = 240.0  # a world's deadline


def host(tree):
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """The JAX side: the configurations' inits, the inputs, and JAX's
    results on them, written for the ranks to ``inputs.npz``; and the
    unsharded port's results on them."""
    rng = np.random.default_rng(0)
    arrays, models = {}, {}
    for name, (cls, seed) in JAX_CONFIGS.items():
        cfg = ranks.CONFIGS[name][1]
        jm = cls(dataclasses.replace(JAX_TINY, moe_experts=cfg.moe_experts,
                                     moe_top_k=cfg.moe_top_k))
        params = jax.jit(jm.init)(jax.random.PRNGKey(seed))
        models[name] = (jm, params)
        for k, v in from_jax_params(host(params), cfg).items():
            arrays[f"{name}/{k}"] = v.numpy()
    for name, seed in PORT_SEEDS.items():
        family, cfg = ranks.CONFIGS[name]
        model = init_reference_weights(MODELS[family](cfg), seed)
        for k, v in model.state_dict().items():
            arrays[f"{name}/{k}"] = v.numpy()
    feats = (rng.standard_normal((2, 32, 64)) * 0.3).astype(np.float32)
    arrays.update(
        feats=feats, feat_lens=np.array([64, 48], np.int32),
        feats8=(rng.standard_normal((8, 32, 64)) * 0.3).astype(np.float32),
        feat_lens8=np.array([64, 56, 48, 32, 64, 40, 64, 24], np.int32),
        probe=rng.standard_normal((64, JAX_TINY.d_enc)).astype(np.float32),
        wave0=(rng.standard_normal(4000) * 0.1).astype(np.float32),
        wave1=(rng.standard_normal(6500) * 0.1).astype(np.float32),
        wave2=(rng.standard_normal(8000) * 0.3).astype(np.float32))
    n = 3200
    batch = dict(
        audio=(rng.standard_normal((2, n)) * 0.1).astype(np.float32),
        audio_lens=np.array([n, n - 800], np.int32),
        labels=rng.integers(0, JAX_TINY.blank_id, (2, 4)).astype(np.int32),
        label_lens=np.array([4, 2], np.int32))
    arrays.update({f"batch/{k}": v for k, v in batch.items()})
    path = tmp_path_factory.mktemp("parallel") / "inputs.npz"
    np.savez(path, **arrays)

    want = {}
    jbatch = jax_train.TrainBatch(**{k: jnp.asarray(v)
                                     for k, v in batch.items()})
    for name in ("tiny", "moe"):
        jm, params = models[name]
        want[f"enc/{name}"] = np.asarray(jax.jit(jm.encode)(
            params, jnp.asarray(feats), jnp.asarray(arrays["feat_lens"]))[0])
    jm, params = models["tiny"]
    opt = jax_train.make_optimizer(lr=ranks.LR)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jax_train.loss_fn(jm, p, jbatch)))(params)
    new = jax.jit(lambda p, g: optax.apply_updates(
        p, opt.update(g, opt.init(p), p)[0]))(params, grads)
    want["step"] = (float(loss), float(optax.global_norm(grads)),
                    {k: v.numpy() for k, v in from_jax_params(
                        host(new), JAX_TINY).items()})
    jm, params = models["ctc"]
    want["ctc_loss"] = float(jax.jit(
        lambda p: jax_train.ctc_loss_fn(jm, p, jbatch))(params))
    plain = ranks.results(dict(np.load(path)))
    return str(path), want, models, plain


@pytest.fixture(scope="module", params=SHAPES,
                ids=[f"{d}x{m}" for d, m in SHAPES])
def world(request, oracle):
    """Rank 0's results of one mesh shape, and every rank's."""
    shape = request.param
    got = spawn_world(ranks.run_checks, shape[0] * shape[1],
                      timeout_s=WORLD_S, args=(shape, oracle[0]))
    return got[0], got, shape


# -- the placement rule, against JAX's specs (no world) -----------------------
def jax_spec(sharding, ndim):
    spec = tuple(sharding.spec) + (None,) * (ndim - len(sharding.spec))
    return spec


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{d}x{m}" for d, m in SHAPES])
@pytest.mark.parametrize("name", ["tiny", "moe", "ctc"])
def test_placements_match_jax_specs(oracle, name, shape, fsdp):
    """Every leaf's spec from the port's rule, read on the reference's
    path and shape through the converter's key map, equals JAX's
    ``make_param_shardings``; the placements shard the torch dim that is
    the reference's."""
    jm, params = oracle[2][name]
    mesh = jax_mesh.make_mesh({"data": shape[0], "model": shape[1]})
    want = jax.tree_util.tree_flatten_with_path(
        jax_mesh.make_param_shardings(mesh, params, fsdp=fsdp))[0]
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): s for path, s in want}
    model = ranks.load(dict(np.load(oracle[0])), name)
    got = param_placements(model, {"data": shape[0], "model": shape[1]},
                           fsdp)
    assert len(got) == len(want)
    for key, (spec, placements) in got.items():
        path, perm = jax_leaf(key, len(spec))
        assert spec == jax_spec(want[path], len(spec)), key
        for axis, pl in zip((DATA_AXIS, MODEL_AXIS), placements):
            if axis in spec:
                assert pl.dim == perm.index(spec.index(axis)), key
            else:
                assert pl.is_replicate(), key


def test_jax_leaf_reads_the_converter_backwards(oracle):
    """For every leaf of every family the converter's key, read back by
    ``jax_leaf``, names the reference's path, and the dims it gives take
    the converted array back to the reference's."""
    for name in ("tiny", "moe", "ctc"):
        jm, params = oracle[2][name]
        flat = dict(("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                              for k in path), np.asarray(v))
                    for path, v in
                    jax.tree_util.tree_flatten_with_path(params)[0])
        for key, t in from_jax_params(host(params), jm.config).items():
            path, perm = jax_leaf(key, t.dim())
            np.testing.assert_array_equal(
                t.numpy().transpose(np.argsort(perm)) if t.dim() > 1
                else t.numpy(), flat[path], err_msg=key)


# -- the worlds ---------------------------------------------------------------
def test_tp_encode_matches_unsharded_and_jax(world, oracle):
    res = world[0]
    np.testing.assert_allclose(res["enc/tiny"], oracle[3]["enc/tiny"],
                               atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(res["enc/tiny"], oracle[1]["enc/tiny"],
                               atol=2e-4, rtol=1e-3)


def test_expert_parallel_moe_encode(world, oracle):
    res = world[0]
    np.testing.assert_allclose(res["enc/moe"], oracle[3]["enc/moe"],
                               rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(res["enc/moe"], oracle[1]["enc/moe"],
                               rtol=1e-3, atol=2e-4)


def test_moe_expert_stacks_shard_over_model(world):
    """The expert dim of every stack goes over ``model`` (and, with FSDP,
    the largest other dim over ``data``); the gate ``[d, E]``, E < d, is
    row-parallel: d over ``model``."""
    pl = world[0]["placements"]
    data = world[2][0]
    w1 = pl["encoder.block0.ff2.parametrizations.w1.original"]
    b1 = pl["encoder.block0.ff2.parametrizations.b1.original"]
    gate = pl["encoder.block0.ff2.parametrizations.gate.original"]
    assert w1[1] == b1[1] == gate[1] == 0  # also on a model axis of 1
    assert w1[0] == (2 if data > 1 else None)   # f = 128, the largest


def test_tp_serving_tokens_equal_unsharded(world, oracle):
    """Token for token; a pipeline on a mesh runs its bucket programs
    eager (its split layers call collectives from the host), chosen by the
    mesh argument alone, and reloads whole weights, each rank copying its
    own shards, to the unsharded pipeline's tokens on them."""
    (want, plain_captures, want_reloaded), (got, captures, reloaded) = (
        oracle[3]["tokens"], world[0]["tokens"])
    assert all(want) and got == want
    assert plain_captures and not captures
    assert reloaded == want_reloaded and want_reloaded != want
    assert all(r["tokens"] == world[0]["tokens"] for r in world[1])


def test_seq_parallel_blocks_save_a_share_per_rank(world):
    """One sequence-parallel loss forward of ``tiny``: what the encoder's
    blocks save for the backward on each rank (every storage once,
    weights included) against the plain model on the same rank's share
    of the batch: at most 0.65 of it over ``model = 2``, and the saved
    attention scores and probabilities over ``n_heads / model`` heads;
    the same heads under tensor parallelism alone."""
    data, model = world[2]
    heads = ranks.CONFIGS["tiny"][1].n_heads
    for res in world[1]:
        saved = res["saved"]
        plain_bytes, plain_heads = saved["plain"]
        assert plain_heads == [heads]
        for kind in ("seq", "tp"):
            assert saved[kind][1] == [heads // model], kind
        if model == 2:
            assert saved["seq"][0] <= 0.65 * plain_bytes, saved


@pytest.mark.parametrize("case", ["tiny/False", "tiny/True", "moe/False"])
def test_time_sharded_blocks_equal_unsharded(world, oracle, case):
    """The encoder's blocks on time shards over ``model`` (a T' of 15
    padded to the group with masked frames; with remat; the MoE encoder's
    experts over every frame): the output and every gradient of a probe
    loss on it equal the plain encoder's (the encoder's atol 2e-4 / rtol
    1e-3; the probe's gradients atol 1e-4, as the pipelined encoder's,
    rtol 1e-4), on every rank, each with its share of the batch over
    ``data``. A 2 x 1 mesh has no time shards."""
    if world[2][1] == 1:
        assert f"seq_encode/{case}" not in world[0]
        return
    _, want, want_grads = oracle[3][f"seq_encode/{case}"]
    for res in world[1]:
        first, got, got_grads = res[f"seq_encode/{case}"]
        np.testing.assert_allclose(got, want[first:first + got.shape[0]],
                                   atol=2e-4, rtol=1e-3)
        assert set(got_grads) == set(want_grads)
        for k, g in got_grads.items():
            np.testing.assert_allclose(g, want_grads[k], atol=1e-4,
                                       rtol=1e-4, err_msg=k)


def test_tp_streaming_attention_equals_unsharded(world, oracle):
    """The streaming chunk's attention split by heads over ``model``: its
    output and the new caches, gathered whole over the heads, equal the
    unsharded ones (atol 2e-4 / rtol 1e-3, the encoder's), on every
    rank."""
    for res in world[1]:
        for got, want in zip(res["stream_mhsa"], oracle[3]["stream_mhsa"]):
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_tp_lane_engine_tokens_equal_unsharded(world, oracle):
    res = world[0]
    assert oracle[3]["stream"]
    assert res["stream"] == oracle[3]["stream"]


def test_tp_ctc_tokens_equal_unsharded(world, oracle):
    res = world[0]
    assert any(oracle[3]["ctc"])
    assert res["ctc"] == oracle[3]["ctc"]


def assert_step(world, kind, plain, jax_step=None):
    """Every rank's step against the unsharded one (and JAX's): the loss,
    the gradient norm, each gradient (atol 1e-5, rtol 1e-4, as
    ``tests/test_torch_train.py``) and the weights after it."""
    for res in world[1]:
        loss, norm, params, grads = res[kind]
        for ref in (plain, jax_step or plain):
            np.testing.assert_allclose(loss, ref[0], rtol=2e-4)
            np.testing.assert_allclose(norm, ref[1], rtol=2e-4)
            assert set(params) == set(ref[2])
            for k, v in params.items():
                np.testing.assert_allclose(v, ref[2][k], rtol=0,
                                           atol=2 * ranks.LR, err_msg=k)
        assert set(grads) == set(plain[3])
        for k, g in grads.items():
            np.testing.assert_allclose(g, plain[3][k], atol=1e-5, rtol=1e-4,
                                       err_msg=k)


@pytest.mark.parametrize("kind", ["step", "step_fsdp", "step_sp"])
def test_sharded_train_step_equals_unsharded_and_jax(world, oracle, kind):
    """DP x TP (``step``), with FSDP (``step_fsdp``) and FSDP with the
    sequence-parallel loss (``step_sp``): one AdamW step's loss, global
    gradient norm, gradients and weights, on every rank."""
    assert_step(world, kind, oracle[3]["step"], oracle[1]["step"])


def test_expert_parallel_train_step_equals_unsharded(world, oracle):
    """The MoE encoder's step with its experts over ``model`` and FSDP
    over ``data``: loss, gradient norm, gradients and weights as the
    unsharded step's on every rank (the gate and the input take the sum of
    every rank's share of their gradient)."""
    assert_step(world, "step_moe", oracle[3]["step_moe"])


def test_seq_parallel_ctc_loss(world, oracle):
    res = world[0]
    np.testing.assert_allclose(res["sp_ctc"], oracle[3]["sp_ctc"], rtol=2e-4)
    np.testing.assert_allclose(res["sp_ctc"], oracle[1]["ctc_loss"],
                               rtol=2e-4)


@pytest.mark.parametrize("case", ["gpipe", "gpipe_more_micro",
                                  "gpipe_one_stage"])
def test_gpipe_forward_and_backward(world, case):
    """S = the world (4 layers), M = S; S = 2, M = 4; S = 1: the output
    equals the plain encoder's, and every gradient a rank
    holds (its stage's blocks, the prologue, the epilogue) the
    single-rank one."""
    for res in world[1]:
        got, plain, grad_err, n_grads = res[case]
        np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
        assert n_grads > 0
        assert grad_err <= 1e-4


def test_gpipe_refuses_bad_factorizations(world):
    layers, batch, stages = world[0]["refusals"]
    assert "n_layers 3 not divisible by 2 stages" in layers
    assert "batch 2 not divisible by 3 microbatches" in batch
    assert "need" in stages


def test_stack_block_params_stacks_each_blocks_parameter(oracle):
    """GPipe's staging view: every block parameter stacked on a leading
    [L] dim in block order, the rest of the encoder by name."""
    model = ranks.load(dict(np.load(oracle[0])), "tiny")
    stacked, rest = stack_block_params(model.encoder, 2)
    block = dict(model.encoder.block0.named_parameters())
    assert set(stacked) == set(block)
    for name, t in stacked.items():
        for i in range(2):
            assert np.array_equal(t[i].detach().numpy(), dict(getattr(
                model.encoder, f"block{i}").named_parameters())[
                    name].detach().numpy()), name
    assert {k.split(".")[0] for k in rest} == {"subsampler", "out_proj"}
