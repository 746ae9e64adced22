"""The multi-device dryruns (port of the reference's ``dryrun_multichip``
and ``dryrun_multihost``).

``dryrun_multichip(n)`` starts a world of ``n`` ranks (``launch.
spawn_world``; gloo on the CPU, NCCL with one rank per card) and, on the
``tiny`` preset with the reference's ``PRNGKey(0)`` weights, runs:

1. a data x tensor parallel train step (``model`` 4, 2 or 1 wide, the
   rest ``data``), whose loss equals the unsharded step's;
2. tensor-parallel serving: ``AsrPipeline(..., mesh=)`` tokens equal to
   the unsharded pipeline's;
3. the tensor-parallel lane engine (``tiny`` made causal, the blank biased
   up): tokens equal to the unsharded engine's;
4. a GPipe encode over 2 stages (1 on one rank) x 2 microbatches, equal
   to the plain encoder;
5. FSDP with the sequence-parallel loss: the step's loss equals the
   plain one's;
6. the expert-parallel MoE encode (4 experts, top 2), equal to the
   unsharded encoder;
7. on 4 or more ranks, an even count, the multi-slice mesh over 2
   simulated slices (``parallel/multislice.py``): no model row leaves a
   slice, the train step's loss equals the unsharded one, and the session
   router places two sessions on the two slices.

Every rank checks its results; rank 0's report lines come back.

``dryrun_multihost(n_processes, local_devices)`` starts ``n_processes x
local_devices`` OS processes with torchrun's environment, which meet over
a TCP coordinator (``parallel/multihost.py``), and runs one sharded train
step in each; every process must report the same loss.

    python -m amira_rust_asr_server_tpu_torch.parallel.dryrun 4
    python -m amira_rust_asr_server_tpu_torch.parallel.dryrun 4 --backend gloo
    python -m amira_rust_asr_server_tpu_torch.parallel.dryrun 2 --hosts 2 --backend gloo
"""

from __future__ import annotations

import copy
import dataclasses
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List

import numpy as np
import torch

from ..errors import DeviceError
from .launch import spawn_world

TIMEOUT_S = 600.0


def _synced_ms(dev: torch.device, t0: float) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3


def _close(got: torch.Tensor, want: torch.Tensor, rtol: float,
           atol: float, what: str) -> None:
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        err = float((got - want).abs().max())
        raise AssertionError(f"{what}: max abs error {err:.3g} past rtol "
                             f"{rtol} atol {atol}")


def _rank(rank: int, world: int, backend: str) -> List[str]:
    from ..config import Config
    from ..models import Transducer
    from ..models.presets import TINY
    from ..runtime.lane_engine import StreamingLaneEngine
    from ..runtime.pipeline import AsrPipeline
    from ..vocab import Vocabulary
    from .mesh import (full_state_dict, make_mesh, make_param_shardings,
                       shard_params)
    from .pipeline import make_pp_mesh, pipeline_encode
    from .train import (TrainBatch, init_training, make_optimizer,
                        make_seq_parallel_loss, make_train_step)

    dev = (torch.device("cuda", torch.cuda.current_device())
           if backend == "nccl" else torch.device("cpu"))
    backend_name = "tpu" if dev.type == "cuda" else "cpu"
    lines: List[str] = []
    model_ax = next(c for c in (4, 2, 1) if world % c == 0)
    data_ax = world // model_ax
    shape = f"({data_ax}x{model_ax})"
    mesh = make_mesh({"data": data_ax, "model": model_ax})

    def seeded(cfg=TINY):
        model = Transducer(cfg).to(dev)
        init_training(model, 0, make_optimizer())
        return model

    # -- 1. DP x TP train step vs the unsharded step
    rng = np.random.default_rng(0)
    b, n = max(2, data_ax), 3200
    batch = TrainBatch(
        audio=torch.from_numpy((rng.standard_normal((b, n)) * 0.1
                                ).astype(np.float32)),
        audio_lens=torch.full((b,), n, dtype=torch.int32),
        labels=torch.from_numpy(rng.integers(
            0, TINY.blank_id, (b, 4)).astype(np.int32)),
        label_lens=torch.full((b,), 4, dtype=torch.int32))
    opt = make_optimizer(lr=1e-3)
    plain = Transducer(TINY).to(dev)
    plain_loss = make_train_step(plain, opt)(
        init_training(plain, 0, opt), batch)
    model = Transducer(TINY).to(dev)
    state = init_training(model, 0, opt, mesh)
    loss = make_train_step(model, opt, mesh)(state, batch)
    _close(loss, plain_loss, 2e-4, 0.0, "DP x TP train step loss")
    lines.append(f"dryrun_multichip({world}): mesh={shape} "
                 f"loss={float(loss):.4f} OK")

    # -- 2. TP serving tokens vs the unsharded pipeline
    vocab = Vocabulary.from_map({i: f"w{i}" for i in range(15)})
    cfg = Config(audio_sec_buckets=[0.5], batch_buckets=[1],
                 compute_dtype="float32", warmup_on_start=False,
                 inference_backend=backend_name)
    wave = (rng.standard_normal(4000) * 0.1).astype(np.float32)
    t_plain = AsrPipeline(seeded(), vocab, cfg, dev).process_batch_samples(
        wave)
    t_tp = AsrPipeline(seeded(), vocab, cfg, dev,
                       mesh=mesh).process_batch_samples(wave)
    if t_plain.tokens != t_tp.tokens:
        raise AssertionError(f"TP serving tokens diverge: {t_plain.tokens} "
                             f"vs {t_tp.tokens}")
    placed = seeded()
    t0 = time.perf_counter()
    shard_params(mesh, placed)
    place_ms = _synced_ms(dev, t0)
    t0 = time.perf_counter()
    full_state_dict(placed)
    gather_ms = _synced_ms(dev, t0)
    lines.append(f"dryrun_multichip({world}): serve tokens match OK "
                 f"({len(t_plain.tokens)} tokens, mesh={shape}; placing "
                 f"the weights {place_ms:.1f} ms, gathering them "
                 f"{gather_ms:.1f} ms)")

    # -- 3. the TP lane engine vs the unsharded engine
    scfg = dataclasses.replace(TINY, causal=True, att_context=(8, 0))
    swave = (np.random.default_rng(17).standard_normal(8000) * 0.3
             ).astype(np.float32)

    def run_stream(m) -> List[int]:
        smodel = seeded(scfg)
        with torch.no_grad():
            smodel.joint.out.b[scfg.blank_id] += 2.0
        eng = StreamingLaneEngine(AsrPipeline(smodel, vocab, cfg, dev,
                                              mesh=m),
                                  n_lanes=2, chunk_frames=16, norm="none")
        lane = eng.attach()
        for i in range(0, swave.shape[0], 3200):
            eng.feed(lane, swave[i:i + 3200])
            eng.tick()
        eng.feed(lane, np.zeros(0, np.float32), final=True)
        eng.drain(lane)
        return eng.tokens[lane]

    s_plain, s_tp = run_stream(None), run_stream(mesh)
    if s_plain != s_tp:
        raise AssertionError(f"TP stream tokens diverge: {s_plain} vs "
                             f"{s_tp}")
    lines.append(f"dryrun_multichip({world}): stream chunk-step tokens "
                 f"match OK ({len(s_plain)} tokens, mesh={shape})")

    # -- 4. GPipe over a stage mesh vs the plain encoder
    pp_stages = 2 if world >= 2 else 1
    pp_mesh = make_pp_mesh(pp_stages)
    feats = torch.from_numpy((rng.standard_normal((2, TINY.n_mels, 64))
                              * 0.3).astype(np.float32)).to(dev)
    flens = torch.tensor([64, 48], dtype=torch.int32, device=dev)
    fresh = seeded()
    with torch.no_grad():
        ref_enc, ref_lens = fresh.encode(feats, flens)
        pp_enc, pp_lens = pipeline_encode(fresh, feats, flens, pp_mesh,
                                          n_microbatches=2)
    if not torch.equal(ref_lens, pp_lens):
        raise AssertionError("pipeline-parallel lengths diverge")
    _close(pp_enc, ref_enc, 1e-5, 1e-5, "pipeline-parallel encode")
    lines.append(f"dryrun_multichip({world}): pipeline-parallel encode "
                 f"matches OK ({pp_stages} stages x 2 microbatches)")

    # -- 5. FSDP + sequence parallelism in one step vs the plain loss
    fsdp_model = Transducer(TINY).to(dev)
    f_state = init_training(fsdp_model, 0, opt, mesh, fsdp=True)
    sp_loss = make_train_step(fsdp_model, opt, mesh,
                              loss=make_seq_parallel_loss(mesh))(f_state,
                                                                 batch)
    _close(sp_loss, plain_loss, 2e-4, 0.0, "FSDP + sequence-parallel loss")
    lines.append(f"dryrun_multichip({world}): fsdp+seq-parallel train step "
                 f"loss matches OK ({float(sp_loss):.4f})")

    # -- 6. expert parallelism: MoE expert stacks over the model axis
    moe = seeded(dataclasses.replace(TINY, moe_experts=4, moe_top_k=2))
    placed = make_param_shardings(mesh, moe)["encoder.block0.ff2.w1"]
    if model_ax > 1 and placed[1].dim != 0:
        raise AssertionError(f"MoE w1 placed {placed}, not over experts")
    with torch.no_grad():
        ref_moe, _ = moe.encode(feats, flens)
        ep_moe, _ = shard_params(mesh, copy.deepcopy(moe)).encode(feats,
                                                                  flens)
    _close(ep_moe, ref_moe, 1e-3, 2e-4, "expert-parallel MoE encode")
    lines.append(f"dryrun_multichip({world}): expert-parallel MoE encode "
                 f"matches OK (4 experts over the model axis)")

    # -- 7. the multi-slice mesh: data across slices, tensor parallel
    # within one; only the gradient all-reduce crosses a slice
    if world >= 4 and world % 2 == 0:
        from .multislice import (SliceRouter, assert_ici_contained,
                                 make_multislice_mesh, slice_groups)
        groups = slice_groups(n_slices=2)
        ms_mesh = make_multislice_mesh(tp=world // 4 or 1, n_slices=2)
        assert_ici_contained(ms_mesh, groups)
        # the batch must divide the multi-slice data axis: repeated lanes
        # leave the mean loss as it is
        reps = ms_mesh.size(0) // batch.audio.shape[0]
        ms_batch = TrainBatch(audio=batch.audio.repeat(reps, 1),
                              audio_lens=batch.audio_lens.repeat(reps),
                              labels=batch.labels.repeat(reps, 1),
                              label_lens=batch.label_lens.repeat(reps))
        ms_model = Transducer(TINY).to(dev)
        ms_state = init_training(ms_model, 0, opt, ms_mesh)
        loss_ms = make_train_step(ms_model, opt, ms_mesh)(ms_state,
                                                          ms_batch)
        _close(loss_ms, plain_loss, 2e-4, 0.0, "multi-slice train loss")
        router = SliceRouter(n_slices=2, lanes_per_slice=4)
        if {router.assign("s1"), router.assign("s2")} != {0, 1}:
            raise AssertionError(f"router placed {router.to_dict()}")
        lines.append(f"dryrun_multichip({world}): multislice mesh "
                     f"{ms_mesh.size(0)}x{ms_mesh.size(1)} ICI-contained, "
                     f"train loss matches OK ({float(loss_ms):.4f})")
    return lines


def dryrun_multichip(n_devices: int, backend: str = "nccl",
                     timeout_s: float = TIMEOUT_S) -> List[str]:
    """Run the dryrun on a new world of ``n_devices`` ranks, one per card
    (NCCL), or on the CPU with ``backend="gloo"``; prints and returns rank
    0's report lines. Raises if any check fails, and ``DeviceError`` for
    NCCL without as many cards."""
    if backend == "nccl" and torch.cuda.device_count() < n_devices:
        raise DeviceError(
            f"dryrun_multichip({n_devices}) over NCCL needs {n_devices} "
            f"CUDA devices, found {torch.cuda.device_count()}; "
            "backend='gloo' runs the ranks on the CPU")
    lines = spawn_world(_rank, n_devices, backend, timeout_s,
                        args=(backend,))[0]
    for line in lines:
        print(line, flush=True)
    return lines


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multihost(n_processes: int = 2, local_devices: int = 1,
                     backend: str = "nccl",
                     timeout_s: float = TIMEOUT_S) -> float:
    """Start ``n_processes`` "hosts" of ``local_devices`` ranks each, as
    OS processes with torchrun's environment meeting at a TCP coordinator
    on this machine, and run one sharded train step in each
    (``multihost.run_multihost_smoke``; NCCL with one card per local rank,
    or gloo on the CPU). Every process must print the same loss, which is
    returned. Past ``timeout_s`` every process is killed and
    :class:`TimeoutError` raised."""
    world = n_processes * local_devices
    if backend == "nccl" and torch.cuda.device_count() < local_devices:
        raise DeviceError(
            f"dryrun_multihost(.., {local_devices}) over NCCL needs "
            f"{local_devices} CUDA devices per host, found "
            f"{torch.cuda.device_count()}; backend='gloo' runs on the CPU")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    port = _free_port()
    procs, logs = [], []
    deadline = time.monotonic() + timeout_s
    try:
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(rank % local_devices),
                       LOCAL_WORLD_SIZE=str(local_devices),
                       GROUP_RANK=str(rank // local_devices),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       OMP_NUM_THREADS="1",
                       PYTHONPATH=os.pathsep.join(
                           p for p in (root, os.environ.get("PYTHONPATH"))
                           if p))
            logs.append(tempfile.TemporaryFile("w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "amira_rust_asr_server_tpu_torch.parallel.multihost",
                 "--backend", backend], env=env, cwd=root,
                stdout=logs[-1], stderr=subprocess.STDOUT, text=True))
        for p in procs:
            try:
                p.wait(max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise TimeoutError(f"dryrun_multihost({n_processes}x"
                                   f"{local_devices}) did not finish "
                                   f"within {timeout_s:.0f} s") from None
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(5.0)
        for log in logs:
            log.close()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"multihost proc {rank} failed rc="
                               f"{p.returncode}:\n{out[-3000:]}")
    losses = {ln.split("loss=")[1].split()[0]
              for out in outs for ln in out.splitlines()
              if ln.startswith("multihost proc") and " OK" in ln}
    if len(losses) != 1:
        raise AssertionError(f"processes disagree on the loss: {losses}")
    loss = losses.pop()
    print(f"dryrun_multihost({n_processes}x{local_devices}): loss={loss} "
          "OK", flush=True)
    return float(loss)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description="the multi-device dryruns")
    ap.add_argument("n_devices", type=int, nargs="?", default=2,
                    help="ranks (with --hosts: ranks per host)")
    ap.add_argument("--hosts", type=int, default=0,
                    help="dryrun_multihost over this many simulated hosts")
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"),
                    help="nccl: one rank per card; gloo: ranks on the CPU")
    a = ap.parse_args()
    if a.hosts:
        dryrun_multihost(a.hosts, a.n_devices, a.backend)
    else:
        dryrun_multichip(a.n_devices, a.backend)
