"""What each rank of the worlds of ``tests/test_torch_parallel.py`` runs.

Imported by the spawned ranks, so it imports torch and the port only: the
JAX oracle stays in the test process, which writes the weights (JAX's
init, converted) and the inputs to an ``.npz`` that every rank reads, and
compares what the ranks return. Each rank computes every check both
unsharded (its own plain copy) and on the mesh, and returns numpy arrays.
"""

import dataclasses

import numpy as np
import torch

from amira_rust_asr_server_tpu_torch.config import Config
from amira_rust_asr_server_tpu_torch.convert import MODELS
from amira_rust_asr_server_tpu_torch.models.presets import TINY
from amira_rust_asr_server_tpu_torch.models.tp import TimeShards
from amira_rust_asr_server_tpu_torch.parallel import (
    TrainBatch, make_mesh, make_optimizer, make_pp_mesh,
    make_seq_parallel_loss, make_train_step, pipeline_encode, shard_params)
from amira_rust_asr_server_tpu_torch.ops.streaming import _mhsa
from amira_rust_asr_server_tpu_torch.parallel.mesh import (data_slice,
                                                           full_state_dict)
from amira_rust_asr_server_tpu_torch.parallel.memory import saved_in_blocks
from amira_rust_asr_server_tpu_torch.parallel.train import (ctc_loss_fn,
                                                            loss_fn)
from amira_rust_asr_server_tpu_torch.runtime import AsrPipeline
from amira_rust_asr_server_tpu_torch.runtime.family_pipeline import \
    build_family_pipeline
from amira_rust_asr_server_tpu_torch.runtime.lane_engine import \
    StreamingLaneEngine
from amira_rust_asr_server_tpu_torch.vocab import Vocabulary

# the configurations the test writes weights for, by name
CONFIGS = {
    "tiny": ("transducer", TINY),
    "moe": ("transducer", dataclasses.replace(TINY, moe_experts=4,
                                              moe_top_k=2)),
    "stream": ("transducer", dataclasses.replace(TINY, causal=True,
                                                 att_context=(8, 0))),
    "ctc": ("ctc", TINY),
    "deep": ("transducer", dataclasses.replace(TINY, n_layers=4)),
}
WORDS = {i: f"▁w{i}" for i in range(15)}
LR = 1e-3
SERVE = dict(audio_sec_buckets=[0.5], batch_buckets=[1, 2],
             max_symbols_per_step=5, max_total_tokens=40,
             compute_dtype="float32", inference_backend="cpu")


def load(data, name):
    """The plain model ``name`` on the weights in ``data``."""
    family, cfg = CONFIGS[name]
    model = MODELS[family](cfg)
    prefix = f"{name}/"
    model.load_state_dict({k[len(prefix):]: torch.from_numpy(v)
                           for k, v in data.items() if k.startswith(prefix)})
    return model


def batch_of(data):
    return TrainBatch(*(torch.from_numpy(data[f"batch/{f}"])
                        for f in TrainBatch._fields))


def numpy_state(model):
    return {k: v.detach().numpy().copy()
            for k, v in full_state_dict(model).items()}


def grads(model):
    """Every parameter's gradient, whole (a replicated one as this rank
    holds it), by the plain model's name."""
    out = {}
    for name, p in model.named_parameters():
        g = p.grad
        g = g.full_tensor() if hasattr(g, "full_tensor") else g
        name = name.replace(".parametrizations.", ".").replace(
            ".original", "")
        out[name] = g.numpy().copy()
    return out


def train_step(data, mesh=None, fsdp=False, loss=None, name="tiny"):
    """One AdamW step of ``name`` from the test's weights: (loss, the
    global gradient norm, the weights after, the gradients)."""
    model = load(data, name)
    opt = make_optimizer(lr=LR)
    state = opt.init(model.parameters())
    if mesh is not None:
        shard_params(mesh, model, fsdp=fsdp)
        state = opt.init(model.parameters())
    kw = {} if loss is None else {"loss": loss}
    step = make_train_step(model, opt, mesh, **kw)
    value = step(state, batch_of(data))
    return (float(value), float(step.grad_norm), numpy_state(model),
            grads(model))


def serve_tokens(model, waves, mesh=None):
    """(each wave's tokens, whether the pipeline captures its programs,
    each wave's tokens after a reload of whole weights: the same with the
    blank biased down)."""
    staged = {k: v.clone() for k, v in model.state_dict().items()}
    staged["joint.out.b"][model.config.blank_id] -= 1.0
    pipe = AsrPipeline(model, Vocabulary.from_map(WORDS), Config(**SERVE),
                       mesh=mesh)

    def tokens():
        res = pipe.decode_samples_batch(waves)[0]
        return [res.tokens[i, :res.counts[i]].tolist()
                for i in range(len(waves))]

    before = tokens()
    pipe.swap_weights(staged)
    return before, pipe.capture, tokens()


def stream_tokens(model, wave, mesh=None):
    pipe = AsrPipeline(model, Vocabulary.from_map(WORDS), Config(
        compute_dtype="float32", inference_backend="cpu",
        audio_sec_buckets=[1.0], batch_buckets=[1]), mesh=mesh)
    eng = StreamingLaneEngine(pipe, n_lanes=2, chunk_frames=16, norm="none")
    lane = eng.attach()
    for i in range(0, wave.shape[0], 3200):
        eng.feed(lane, wave[i:i + 3200])
        eng.tick()
    eng.feed(lane, np.zeros(0, np.float32), final=True)
    eng.drain(lane)
    return list(eng.tokens[lane])


def ctc_tokens(model, waves, mesh=None):
    _, pipe = build_family_pipeline("ctc", "tiny", Vocabulary.from_map(
        WORDS), Config(model_family="ctc", **SERVE), model=model, mesh=mesh)
    res = pipe.decode_samples_batch(waves)[0]
    return [np.asarray(res.tokens)[i, :int(res.counts[i])].tolist()
            for i in range(len(waves))]


def attention_heads(storages):
    """The head counts of the saved attention scores and probabilities
    (float ``[B, h, T, T]``) among what a loss's blocks saved."""
    return sorted({s[1] for _, s, dt in storages.values()
                   if len(s) == 4 and dt.is_floating_point and s[2] == s[3]})


def saved_bytes(data, mesh=None):
    """What the encoder's blocks of ``tiny`` save for the backward during
    one loss forward on this rank's share of the batch, and the head
    counts of the saved attention tensors: the plain model with the plain
    loss, and, with ``mesh``, the placed model (FSDP) with the
    sequence-parallel loss (``seq``) and with the plain loss under tensor
    parallelism (``tp``)."""
    batch = batch_of(data)
    if mesh is not None:
        batch = TrainBatch(*(data_slice(mesh, x) for x in batch))
    runs = {"plain": (load(data, "tiny"), loss_fn)}
    if mesh is not None:
        runs["seq"] = (shard_params(mesh, load(data, "tiny"), True),
                       make_seq_parallel_loss(mesh))
        runs["tp"] = (shard_params(mesh, load(data, "tiny")), loss_fn)
    out = {}
    for kind, (model, loss) in runs.items():
        with saved_in_blocks(model.encoder) as saved:
            value = loss(model, batch)
        value.backward()
        out[kind] = (saved["bytes"], attention_heads(saved["storages"]))
    return out


def seq_encode(data, name, mesh=None, remat=False):
    """The encoder of ``name`` on 60 feature frames (T' = 15, which the
    time shards pad) and the gradients of a probe loss on its output:
    plain, or with ``mesh`` on this rank's share of the batch over
    ``data`` with its blocks on time shards over ``model``
    (``models/tp.TimeShards``). Returns (the share's first row, its
    output, the gradients by name, summed over the batch)."""
    model = load(data, name)
    if remat:
        model.config = dataclasses.replace(model.config, remat=True)
        model.encoder.cfg = model.config
    seq = None
    if mesh is not None:
        shard_params(mesh, model)
        seq = TimeShards.over(mesh, model.config)
        assert seq is not None
    feats = torch.from_numpy(data["feats"][:, :, :60])
    lens = torch.from_numpy(np.minimum(data["feat_lens"], 60))
    first = 0
    if mesh is not None:  # this rank's share of the batch over data
        feats, lens = data_slice(mesh, feats), data_slice(mesh, lens)
        first = mesh.get_local_rank("data") * feats.shape[0]
    out, _ = model.encode(feats, lens, seq)
    w = torch.from_numpy(data["probe"])
    (out * w[:out.shape[1]]).sum().backward()
    return first, out.detach().numpy(), grads(model.encoder)


def stream_attention(data, mesh=None):
    """``ops/streaming._mhsa`` of the causal model's first block on seeded
    inputs and a filled cache: (out, new k cache, new v cache)."""
    model = load(data, "stream")
    if mesh is not None:
        shard_params(mesh, model)
    cfg = model.config
    rng = np.random.default_rng(7)
    left, dh = cfg.att_context[0], cfg.d_model // cfg.n_heads

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x, k, v = (arr(2, 4, cfg.d_model), arr(2, cfg.n_heads, left, dh),
               arr(2, cfg.n_heads, left, dh))
    with torch.inference_mode():
        got = _mhsa(model.encoder.block0.mhsa, cfg, x, k, v,
                    torch.tensor([8, 3], dtype=torch.int32))
    return [t.numpy().copy() for t in got]


def gpipe(data, name, n_stages, n_micro, batch=""):
    """The pipelined encode of ``name`` on the inputs ``feats<batch>`` and
    the gradient of a loss on it, beside the plain ones: (output, plain
    output, the largest gradient error over the parameters this rank
    holds, how many it compared)."""
    feats = torch.from_numpy(data[f"feats{batch}"])
    lens = torch.from_numpy(data[f"feat_lens{batch}"])
    w = torch.from_numpy(data["probe"])
    plain, model = load(data, name), load(data, name)
    want, _ = plain.encode(feats, lens)
    (want * w[:want.shape[1]]).sum().backward()
    got, got_lens = pipeline_encode(model, feats, lens,
                                    make_pp_mesh(n_stages), n_micro)
    (got * w[:got.shape[1]]).sum().backward()
    want_g = dict(plain.named_parameters())
    errs = [float((p.grad - want_g[k].grad).abs().max())
            for k, p in model.named_parameters() if p.grad is not None]
    return (got.detach().numpy(), want.detach().numpy(), max(errs),
            len(errs))


def refusals(data, world):
    """The factorizations the pipeline refuses, by their messages."""
    out = []
    feats = torch.from_numpy(data["feats"])
    lens = torch.from_numpy(data["feat_lens"])
    odd = MODELS["transducer"](dataclasses.replace(TINY, n_layers=3))
    for call in (lambda: pipeline_encode(odd, feats, lens,
                                         make_pp_mesh(2), 2),
                 lambda: pipeline_encode(load(data, "tiny"), feats, lens,
                                         make_pp_mesh(2), 3),
                 lambda: make_pp_mesh(world + 1)):
        try:
            call()
            out.append("")
        except ValueError as e:
            out.append(str(e))
    return out


def results(data, mesh=None, world=1):
    """Every check's result, on ``mesh`` (one mesh shape ``(data, model)``
    on this rank), or unsharded without one: what the test holds the
    sharded results to, computed once in the test process."""
    feats = torch.from_numpy(data["feats"])
    lens = torch.from_numpy(data["feat_lens"])
    waves = [data["wave0"], data["wave1"]]

    def placed(model, fsdp=False):
        return model if mesh is None else shard_params(mesh, model, fsdp)

    out = {}
    with torch.no_grad():
        for name in ("tiny", "moe"):
            out[f"enc/{name}"] = placed(load(data, name)).encode(
                feats, lens)[0].numpy()
    out["saved"] = saved_bytes(data, mesh)
    if mesh is None or mesh.size(1) > 1:
        for name, remat in (("tiny", False), ("tiny", True), ("moe", False)):
            out[f"seq_encode/{name}/{remat}"] = seq_encode(data, name, mesh,
                                                           remat)
    out["stream_mhsa"] = stream_attention(data, mesh)
    out["tokens"] = serve_tokens(load(data, "tiny"), waves, mesh)
    out["stream"] = stream_tokens(load(data, "stream"), data["wave2"], mesh)
    out["ctc"] = ctc_tokens(load(data, "ctc"), waves, mesh)
    out["step"] = train_step(data, mesh)
    out["step_moe"] = train_step(data, mesh, fsdp=True, name="moe")
    ctc = placed(load(data, "ctc"), fsdp=True)
    if mesh is None:
        with torch.no_grad():
            out["sp_ctc"] = float(ctc_loss_fn(ctc, batch_of(data)))
        return out
    out["step_fsdp"] = train_step(data, mesh, fsdp=True)
    out["step_sp"] = train_step(data, mesh, fsdp=True,
                                loss=make_seq_parallel_loss(mesh))
    opt = make_optimizer(lr=LR)
    out["sp_ctc"] = float(make_train_step(
        ctc, opt, mesh, loss=make_seq_parallel_loss(mesh, "ctc"))(
            opt.init(ctc.parameters()), batch_of(data)))
    stages = world if CONFIGS["deep"][1].n_layers % world == 0 else 2
    out["gpipe"] = gpipe(data, "deep", stages, stages, batch="8")
    out["gpipe_more_micro"] = gpipe(data, "tiny", 2, 4, batch="8")
    out["gpipe_one_stage"] = gpipe(data, "tiny", 1, 2)
    out["refusals"] = refusals(data, world)
    out["placements"] = {
        k: tuple(p.dim if p.is_shard() else None for p in v.placements)
        for k, v in placed(load(data, "moe"), fsdp=True).state_dict().items()}
    return out


def run_checks(rank, world, shape, path):
    """Every check of one mesh shape ``(data, model)`` on this rank."""
    return results(dict(np.load(path)),
                   make_mesh({"data": shape[0], "model": shape[1]}), world)


def hang(rank, world):
    """A rank 1 that never returns, for the launcher's deadline."""
    if rank == 1:
        import time
        time.sleep(600)
    return rank


def fail(rank, world):
    """A rank 1 that raises, for the launcher's report."""
    if rank == 1:
        raise ValueError("this rank fails")
    return rank
