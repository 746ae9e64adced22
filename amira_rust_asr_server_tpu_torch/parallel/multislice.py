"""Multi-slice mesh placement and session routing (port of
parallel/multislice.py).

A TPU slice is a set of chips joined by ICI, and slices talk over DCN, far
slower, so the reference lays its mesh out with the axis that moves the
least across slices: ``data``. On GPUs the counterpart of a slice is an
NVLink domain, one host of cards, and the counterpart of DCN the network
between hosts. The rule is the same:

- **serving**: parameters replicate per group, tensor-parallel collectives
  stay inside a group, and nothing crosses hosts at inference time: only
  request routing does, before any device work starts;
- **training**: only the step's gradient all-reduce crosses hosts.

:func:`make_multislice_mesh` returns the standard ``(data, model)``
``DeviceMesh`` whose rank grid is ordered so that no ``model`` row leaves a
group and the ``data`` axis takes the groups in contiguous blocks
(:func:`multislice_grid`). Every placement helper of ``parallel/mesh.py``
and the train step apply unchanged: multi-slice is a placement policy, not
a new programming model.

:class:`SliceRouter` is the host side: a new session is pinned to the
group with the most free lanes and stays there until it ends. It is a
library class, as in the reference, whose server does not use it either.

``slice_groups`` groups the ranks by host (blocks of ``LOCAL_WORLD_SIZE``,
else an all-gather of the host names); ``n_slices`` splits them into
contiguous blocks instead, the reference's simulation hook, which the CPU
tests use.
"""

from __future__ import annotations

import os
import socket
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, MODEL_AXIS, mesh_device_type


def slice_groups(n_slices: Optional[int] = None,
                 ranks: Optional[Sequence[int]] = None) -> List[List[int]]:
    """The ranks grouped by NVLink domain (host), in rank order.

    ``ranks`` defaults to every rank of the world. ``n_slices`` splits
    them into that many equal contiguous blocks (the simulation hook);
    otherwise blocks of torchrun's ``LOCAL_WORLD_SIZE`` when it is set,
    else the ranks that share a host name (an all-gather over the world).
    """
    ranks = list(ranks if ranks is not None
                 else range(dist.get_world_size()))
    if n_slices is not None:
        if n_slices < 1 or len(ranks) % n_slices != 0:
            raise ValueError(
                f"{len(ranks)} ranks do not split into {n_slices} slices")
        per = len(ranks) // n_slices
        return [ranks[i * per:(i + 1) * per] for i in range(n_slices)]
    if "LOCAL_WORLD_SIZE" in os.environ:
        per = max(1, int(os.environ["LOCAL_WORLD_SIZE"]))
        return [ranks[i:i + per] for i in range(0, len(ranks), per)]
    names: List[Optional[str]] = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    by: Dict[str, List[int]] = {}
    for r in ranks:
        by.setdefault(names[r], []).append(r)
    return list(by.values())


def multislice_grid(tp: int, groups: List[List[int]]) -> np.ndarray:
    """The ``[data, model]`` rank grid: ``tp`` ranks per model row, each
    row drawn from one group, the groups in contiguous blocks of rows."""
    rows: List[List[int]] = []
    for gi, g in enumerate(groups):
        if tp < 1 or len(g) % tp != 0:
            raise ValueError(f"slice {gi} has {len(g)} ranks, not "
                             f"divisible by tp={tp}")
        rows.extend(g[r * tp:(r + 1) * tp] for r in range(len(g) // tp))
    return np.asarray(rows, dtype=np.int64).reshape(len(rows), tp)


def make_multislice_mesh(tp: int = 1, n_slices: Optional[int] = None):
    """The ``(data, model)`` device mesh over every rank whose model axis
    never leaves a group (:func:`slice_groups`): data-parallel across
    groups, tensor-parallel within one. Every rank must call it."""
    from torch.distributed.device_mesh import DeviceMesh
    grid = multislice_grid(tp, slice_groups(n_slices))
    return DeviceMesh(mesh_device_type(), torch.from_numpy(grid),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def _grid(mesh) -> np.ndarray:
    if tuple(mesh.mesh_dim_names) != (DATA_AXIS, MODEL_AXIS):
        raise ValueError(f"expected ({DATA_AXIS}, {MODEL_AXIS}) mesh, got "
                         f"{mesh.mesh_dim_names}")
    return np.asarray(mesh.mesh.tolist(), dtype=np.int64)


def assert_ici_contained(mesh, groups: Optional[List[List[int]]] = None
                         ) -> None:
    """Raise if any model row of ``mesh`` spans two groups, so that its
    tensor-parallel collectives would leave NVLink for the network
    between hosts (the reference's name: ICI is the TPU's NVLink).
    ``groups`` defaults to :func:`slice_groups`; the tests and the dryrun
    pass simulated ones."""
    groups = slice_groups() if groups is None else groups
    of = {r: gi for gi, g in enumerate(groups) for r in g}
    for i, row in enumerate(_grid(mesh)):
        slices = {of[int(r)] for r in row}
        if len(slices) > 1:
            raise AssertionError(
                f"model row {i} crosses slices {sorted(slices)}: its "
                f"tensor-parallel collectives would leave NVLink")


def slice_of_row(mesh, groups: Optional[List[List[int]]] = None
                 ) -> List[int]:
    """The group of each data-axis row (the router's placement table)."""
    groups = slice_groups() if groups is None else groups
    of = {r: gi for gi, g in enumerate(groups) for r in g}
    return [of[int(row[0])] for row in _grid(mesh)]


class SliceRouter:
    """Least-loaded slice placement for streaming sessions.

    Sessions are sticky: assigned once, released on close; per-chunk
    work then stays on one slice's NVLink domain. Thread-safe (the
    server's session threads assign/release concurrently).
    """

    def __init__(self, n_slices: int, lanes_per_slice: int):
        if n_slices < 1 or lanes_per_slice < 1:
            raise ValueError("n_slices and lanes_per_slice must be >= 1")
        self.n_slices = n_slices
        self.lanes_per_slice = lanes_per_slice
        self._lock = threading.Lock()
        self._load = [0] * n_slices
        self._of: Dict[str, int] = {}

    def assign(self, session_id: str) -> Optional[int]:
        """Pin ``session_id`` to the least-loaded slice; None when every
        slice is at capacity (caller sheds with 503, like the lane
        engine's admission)."""
        with self._lock:
            if session_id in self._of:
                return self._of[session_id]
            s = min(range(self.n_slices), key=lambda i: self._load[i])
            if self._load[s] >= self.lanes_per_slice:
                return None
            self._load[s] += 1
            self._of[session_id] = s
            return s

    def release(self, session_id: str) -> None:
        with self._lock:
            s = self._of.pop(session_id, None)
            if s is not None:
                self._load[s] -= 1

    def to_dict(self) -> dict:
        with self._lock:
            return {"n_slices": self.n_slices,
                    "lanes_per_slice": self.lanes_per_slice,
                    "load": list(self._load),
                    "sessions": len(self._of)}
