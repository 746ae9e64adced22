"""Multi-process wiring (port of parallel/multihost.py).

The reference joins N processes into one global device set with
``jax.distributed`` and lets GSPMD span the hosts. The port runs one
process per device, so a world of ranks over ``torch.distributed`` is
already multi-process on one host; across hosts it is the same world with
a coordinator address every process can reach. This module joins that
world and keeps the reference's rules for it:

- every process builds identical host values (the same seed, or one
  checkpoint on a shared filesystem) and fills only its own shard of each
  global tensor (:func:`place_global`, ``DTensor.from_local`` of its
  slice), with no collective and no transfer from rank 0;
- what a check reads must be replicated (the loss), so every process can
  read it without a gather.

``init_distributed`` meets over ``tcp://coordinator`` (a ``TCPStore`` that
rank 0 serves), with NCCL and ``torch.cuda.set_device(LOCAL_RANK)`` on the
card and gloo when the caller asks for the CPU. :func:`from_env` reads
torchrun's environment. ``parallel/dryrun.dryrun_multihost`` starts such a
world as OS processes and runs :func:`run_multihost_smoke` in each:

    python -m amira_rust_asr_server_tpu_torch.parallel.multihost --backend gloo

(under torchrun, or any launcher that sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..errors import DeviceError

WORLD_TIMEOUT_S = 600.0

# how this process joined its world (init_distributed): the coordinator
# and the store it met through; the process group is process-wide, so
# the record of how it was made is too
_joined: Dict[str, object] = {}


@dataclasses.dataclass(frozen=True)
class WorldEnv:
    """One process's place in a world, as torchrun describes it."""

    rank: int
    world_size: int
    local_rank: int
    local_world_size: int
    coordinator: str  # host:port of rank 0's store


def from_env(environ: Optional[Mapping[str, str]] = None
             ) -> Optional[WorldEnv]:
    """torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``; None when
    ``WORLD_SIZE`` is not set (no launcher)."""
    env = os.environ if environ is None else environ
    if "WORLD_SIZE" not in env:
        return None
    world = int(env["WORLD_SIZE"])
    return WorldEnv(
        rank=int(env.get("RANK", 0)), world_size=world,
        local_rank=int(env.get("LOCAL_RANK", 0)),
        local_world_size=int(env.get("LOCAL_WORLD_SIZE", world)),
        coordinator=(f"{env.get('MASTER_ADDR', '127.0.0.1')}:"
                     f"{env.get('MASTER_PORT', '29500')}"))


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     device: str = "cuda", local_rank: Optional[int] = None,
                     timeout_s: float = WORLD_TIMEOUT_S) -> bool:
    """Join the world of ``num_processes`` processes that meets at
    ``coordinator`` (``host:port``; rank 0 serves its store there) as rank
    ``process_id``: NCCL on the card of ``local_rank`` (default
    ``LOCAL_RANK``, else 0), gloo when ``device="cpu"``. Idempotent: True
    when this call made the group, False when this process already is
    that rank of a world of that size; a different world raises."""
    if dist.is_initialized():
        have = (dist.get_world_size(), dist.get_rank())
        joined = _joined.get("coordinator")
        if have != (num_processes, process_id) or (
                joined is not None and joined != coordinator):
            raise RuntimeError(
                f"this process is rank {have[1]} of a world of {have[0]}"
                + (f" met at {joined}" if joined else "")
                + f"; asked to join as rank {process_id} of "
                f"{num_processes} at {coordinator}")
        return False
    backend = "gloo" if device == "cpu" else "nccl"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise DeviceError(
                "init_distributed over NCCL needs a CUDA device; "
                "device='cpu' joins over gloo")
        torch.cuda.set_device(local_rank if local_rank is not None
                              else int(os.environ.get("LOCAL_RANK", 0)))
    host, _, port = coordinator.rpartition(":")
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0, timeout=timeout)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=timeout)
    _joined.update(coordinator=coordinator, store=store)
    return True


def world_store() -> Optional[dist.Store]:
    """The store of the world :func:`init_distributed` joined (None for a
    group made otherwise)."""
    return _joined.get("store") if dist.is_initialized() else None


def leave_world() -> None:
    """Destroy this process's groups and forget how it joined."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _joined.clear()


def place_global(model: nn.Module, mesh, placements: Dict[str, tuple]
                 ) -> nn.Module:
    """Place ``model``'s parameters on ``mesh`` in place by
    ``placements`` (``mesh.make_param_shardings``), the reference's rule:
    every rank holds the same whole host values and keeps only its own
    shard of each (``DTensor.from_local`` of its slice), with no
    collective. The result equals ``shard_params``' bit for bit."""
    from torch.distributed.tensor import DTensor

    from .mesh import local_shard, mesh_device_type, place_each
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh_device_type() == "cuda" else torch.device("cpu"))

    def own(t: torch.Tensor, pl: tuple) -> DTensor:
        mine = local_shard(t, mesh, pl).to(dev).clone(
            memory_format=torch.contiguous_format)
        return DTensor.from_local(mine, mesh, pl, run_check=False)

    return place_each(model, placements, own)


def run_multihost_smoke(process_id: int, num_processes: int,
                        coordinator: str, model_ax: Optional[int] = None,
                        device: str = "cuda") -> float:
    """One sharded train step over the world: ``tiny`` on the reference's
    ``PRNGKey(0)`` weights placed by :func:`place_global`, ``model`` 2
    wide on an even world (else 1) and the rest on ``data``, on the
    reference's batch (``default_rng(0)``, ``b = max(2, data)``, 3200
    samples, 4 labels). Returns the (replicated) loss and prints a
    parseable OK line."""
    from ..models import Transducer
    from ..models.presets import TINY
    from ..models.reference_init import init_reference_weights
    from .mesh import make_mesh, make_param_shardings
    from .train import TrainBatch, make_optimizer, make_train_step

    init_distributed(coordinator, num_processes, process_id, device)
    n_devices = dist.get_world_size()
    if model_ax is None:
        model_ax = 2 if n_devices % 2 == 0 else 1
    data_ax = n_devices // model_ax
    mesh = make_mesh({"data": data_ax, "model": model_ax})

    # identical init on every process, then each fills its own shards
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device != "cpu" else torch.device("cpu"))
    model = init_reference_weights(Transducer(TINY), 0).to(dev)
    place_global(model, mesh, make_param_shardings(mesh, model))
    optimizer = make_optimizer(lr=1e-3)
    step = make_train_step(model, optimizer, mesh)

    rng = np.random.default_rng(0)
    b, n, u = max(2, data_ax), 3200, 4
    batch = TrainBatch(
        audio=torch.from_numpy((rng.standard_normal((b, n)) * 0.1
                                ).astype(np.float32)),
        audio_lens=torch.full((b,), n, dtype=torch.int32),
        labels=torch.from_numpy(rng.integers(
            0, TINY.blank_id, (b, u)).astype(np.int32)),
        label_lens=torch.full((b,), u, dtype=torch.int32))
    loss = float(step(optimizer.init(model.parameters()), batch))
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    print(f"multihost proc {process_id}/{num_processes}: "
          f"mesh=({data_ax}x{model_ax}) devices={n_devices} "
          f"loss={loss:.6f} OK", flush=True)
    return loss


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="one sharded train step over torchrun's world")
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"),
                    help="nccl: one rank per card; gloo: ranks on the CPU")
    ap.add_argument("--model-ax", type=int, default=None)
    args = ap.parse_args(argv)
    env = from_env()
    if env is None:
        raise SystemExit("run under torchrun (WORLD_SIZE is not set)")
    torch.set_num_threads(1)
    try:
        run_multihost_smoke(env.rank, env.world_size, env.coordinator,
                            args.model_ax,
                            "cpu" if args.backend == "gloo" else "cuda")
    finally:
        leave_world()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
