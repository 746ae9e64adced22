"""A world of ranks on one machine, bounded in time.

``spawn_world(fn, world_size)`` starts ``world_size`` processes (the
``spawn`` method: each starts from a fresh import), joins them into one
``torch.distributed`` process group and runs ``fn(rank, world_size,
*args)`` in each; it returns the ranks' results in rank order. The group
meets through a ``file://`` store in a new temporary directory, so no TCP
port is taken and worlds started side by side cannot meet by mistake.
Each rank runs one CPU thread and, with NCCL, takes the device of its
rank.

Every wait has a deadline: the process group's own (``timeout_s``, for a
collective that never completes) and a join deadline here, past which
every rank still alive is terminated and :class:`TimeoutError` raised.
A rank that raises makes ``spawn_world`` raise ``RuntimeError`` with its
traceback.
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(fn, rank: int, world_size: int, backend: str, store: str,
               timeout_s: float, args: Sequence[Any], results) -> None:
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    try:
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            results.put((rank, True, fn(rank, world_size, *args)))
        finally:
            dist.destroy_process_group()
    except Exception:  # the parent reports it with the rank's traceback
        results.put((rank, False, traceback.format_exc()))


def spawn_world(fn: Callable, world_size: int, backend: str = "gloo",
                timeout_s: float = 120.0, args: Sequence[Any] = ()
                ) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` on every rank of a new world of
    ``world_size`` processes; the results in rank order. ``fn`` must be a
    module-level function (it is pickled by name)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="amira_world_")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, backend, store, timeout_s,
                               tuple(args), results))
             for r in range(world_size)]
    deadline = time.monotonic() + timeout_s
    got, failed = {}, {}
    try:
        for p in procs:
            p.start()
        # drain the queue while the ranks run: a rank blocks on exit until
        # what it put is read
        while len(got) < world_size and not failed:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, ok, value = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                if not any(p.is_alive() for p in procs):
                    break
                continue
            (got if ok else failed)[rank] = value
        # after a failure the others get a moment to fail too, then go
        grace = 5.0 if failed else deadline - time.monotonic()
        for p in procs:
            p.join(max(grace, 0.0))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.terminate()
        for p in alive:
            p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join(5.0)
        shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        rank = min(failed)
        raise RuntimeError(f"rank {rank} of {world_size} failed:\n"
                           f"{failed[rank]}")
    if len(got) < world_size:
        missing = sorted(set(range(world_size)) - set(got))
        if time.monotonic() >= deadline:
            raise TimeoutError(f"ranks {missing} of {world_size} did not "
                               f"finish within {timeout_s:.0f} s; "
                               "terminated")
        codes = {r: procs[r].exitcode for r in missing}
        raise RuntimeError(f"ranks {missing} of {world_size} exited "
                           f"without a result (exit codes {codes})")
    return [got[r] for r in range(world_size)]
