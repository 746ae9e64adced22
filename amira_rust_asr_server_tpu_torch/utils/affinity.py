"""Host CPU topology, NUMA probe and thread-affinity planning (port of
``utils/affinity.py``, host-only: it needs no torch).

The host's latency-critical job is feeding the device: the one dispatch
thread that stages inputs and launches (or replays) the bucket programs.
The plan keeps the reference's surface (the sysfs NUMA topology probe
restricted to the process's cpuset, small-host disabling, per-thread-type
core partitioning, huge-page-aware allocation sizes) and its partition:
DISPATCH gets a dedicated core on the first node, off core 0, IO (the
asyncio event loop) gets core 0, and SESSION and BACKGROUND share the rest.
No memory binding is done.

Detection failures, restricted cpusets and small hosts all give a
disabled plan with a recorded reason, never an error.
"""

from __future__ import annotations

import dataclasses
import enum
import glob
import os
from typing import Callable, Dict, Optional, Tuple

from ..reliability import get_logger

log = get_logger("asr.affinity")


class ThreadType(enum.Enum):
    """The thread roles the plan partitions cores between."""

    DISPATCH = "dispatch"      # device feeder: staging, launches, replays
    IO = "io"                  # asyncio event loop / network
    SESSION = "session"        # per-stream host work (weaving, buffers)
    BACKGROUND = "background"  # warm-up, metrics


def parse_cpulist(text: str) -> Tuple[int, ...]:
    """Parse a sysfs cpulist like ``0-3,8,10-11`` into a sorted tuple."""
    cores = set()
    for part in text.strip().split(","):
        if not part:
            continue
        if "-" in part:
            lo, hi = part.split("-", 1)
            cores.update(range(int(lo), int(hi) + 1))
        else:
            cores.add(int(part))
    return tuple(sorted(cores))


@dataclasses.dataclass(frozen=True)
class NumaNode:
    node_id: int
    cores: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class CpuTopology:
    """NUMA node -> core map, restricted to this process's cpuset
    (``sched_getaffinity``, not ``os.cpu_count()``: pinning to a core
    outside a container's cpuset raises EINVAL)."""

    nodes: Tuple[NumaNode, ...]
    available: Tuple[int, ...]

    @classmethod
    def detect(cls, sysfs_root: str = "/sys") -> "CpuTopology":
        try:
            available = tuple(sorted(os.sched_getaffinity(0)))
        except (AttributeError, OSError):  # not Linux
            available = tuple(range(os.cpu_count() or 1))
        nodes = []
        for path in sorted(glob.glob(
                os.path.join(sysfs_root, "devices/system/node/node[0-9]*"))):
            try:
                with open(os.path.join(path, "cpulist")) as f:
                    cores = tuple(c for c in parse_cpulist(f.read())
                                  if c in available)
            except OSError:
                continue
            if cores:
                node_id = int(os.path.basename(path)[len("node"):])
                nodes.append(NumaNode(node_id, cores))
        if not nodes:
            nodes = [NumaNode(0, available)]
        return cls(nodes=tuple(nodes), available=available)


@dataclasses.dataclass(frozen=True)
class AffinityPlan:
    """Core assignment per thread type, or a disabled plan with a reason:
    pin only on a host big enough, dedicate a core each to the dispatch
    thread and the event loop, share the rest."""

    enabled: bool
    reason: str
    assignments: Dict[ThreadType, Tuple[int, ...]] = \
        dataclasses.field(default_factory=dict)

    MIN_CORES = 4  # below this, partitioning just starves the host

    @classmethod
    def plan(cls, topology: Optional[CpuTopology] = None) -> "AffinityPlan":
        topo = topology or CpuTopology.detect()
        cores = topo.available
        if len(cores) < cls.MIN_CORES:
            return cls(False, f"host too small to partition "
                              f"({len(cores)} < {cls.MIN_CORES} cores)")
        # the first node by convention (no PCIe-locality probe)
        node0 = topo.nodes[0].cores or cores
        # core 0 takes the IRQs on most kernels: it goes to IO, which is
        # interrupt-driven anyway, and the feeder stays off it
        io_core = cores[0]
        dispatch_core = next((c for c in node0 if c != io_core), cores[1])
        rest = tuple(c for c in cores if c not in (io_core, dispatch_core))
        return cls(True, "partitioned", {
            ThreadType.IO: (io_core,),
            ThreadType.DISPATCH: (dispatch_core,),
            ThreadType.SESSION: rest,
            ThreadType.BACKGROUND: rest,
        })

    def cores_for(self, thread_type: ThreadType) -> Tuple[int, ...]:
        return self.assignments.get(thread_type, ())

    def to_log(self) -> dict:
        return {"enabled": self.enabled, "reason": self.reason,
                "assignments": {t.value: list(c)
                                for t, c in self.assignments.items()}}


def set_thread_affinity(cores: Tuple[int, ...]) -> bool:
    """Pin the calling thread; False (never raises) on failure."""
    if not cores:
        return False
    try:
        os.sched_setaffinity(0, set(cores))
        return True
    except (AttributeError, OSError, ValueError) as e:
        log.warning("affinity pin failed", extra={"fields": {
            "cores": list(cores), "error": str(e)}})
        return False


def make_initializer(plan: AffinityPlan,
                     thread_type: ThreadType) -> Optional[Callable[[], None]]:
    """A ``ThreadPoolExecutor`` ``initializer`` that pins each new worker to
    the plan's cores for ``thread_type``; None when the plan is disabled or
    has no cores for it, so callers can pass it straight through."""
    if not plan.enabled:
        return None
    cores = plan.cores_for(thread_type)
    if not cores:
        return None

    def _init() -> None:
        set_thread_affinity(cores)

    return _init


def recommended_allocation_size(requested: int,
                                sysfs_root: str = "/sys") -> int:
    """Round a host-buffer size up to the boundary the kernel can back: 2 MiB
    when transparent huge pages are on and the buffer can use one, else
    4 KiB."""
    huge = 2 * 1024 * 1024
    page = 4096
    thp = os.path.join(sysfs_root, "kernel/mm/transparent_hugepage/enabled")
    try:
        with open(thp) as f:
            mode = f.read()
        enabled = "[always]" in mode or "[madvise]" in mode
    except OSError:
        enabled = False
    align = huge if (enabled and requested >= huge) else page
    return ((requested + align - 1) // align) * align
