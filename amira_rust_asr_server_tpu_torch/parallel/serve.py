"""Serving over a world of ranks: rank 0 answers HTTP and WebSocket, every
other rank follows each of its device dispatches (the port's means to the
reference's serving over a mesh, ``server/app.py:509-513``).

The reference drives every device of its mesh from one controller. The
port's mesh is one process per device (``parallel/mesh.py``), and the
split layers of a placed model issue collectives from the host
(``models/tp.py``), so every rank has to run the same device calls in the
same order. Rank 0 runs the server; the others run :func:`follow`.

**What is mirrored.** Each outermost device entry of the served objects,
the methods marked :func:`mirrored` (the pipeline's dispatches, chunk
steps, warm-ups, swaps; the lane engine's attach, feed, tick, detach,
refresh and warm-up), is sent to the followers with its arguments before
rank 0 runs it. A follower runs the same method of its own replica with
those arguments and drops the result. A session's encoder cache and carry
are arguments, so they travel with each call and followers keep no table
of sessions; the lane engine's state lives in the engine, whose replica
on each follower is fed the same calls.

**Order.** The send happens under the pipeline's ``device_lock``, which
every thread of rank 0 takes around its device work, and only for the
outermost entry: the lock is reentrant and a nested entry runs plain, so
the sends form one total order, the order rank 0 runs them in.

**Channel.** The entry's header (which method, its arguments with every
tensor on the serving device replaced by a slot) goes over a gloo group
of its own with the world's timeout, and a heartbeat keeps an idle
server's followers inside that timeout; the tensors follow as one packed
byte buffer over the default group (NCCL on the card). After the entry
every rank reports whether it raised, over the gloo group.

**Failure.** Ranks that all raise (a bad request, say) agree, and rank 0
re-raises its error. Ranks that disagree leave the world unusable: rank 0
raises :class:`WorldError` (503, status ``ERROR``) for that request and
every later one, reports the world as degraded, and never carries on
alone. A rank whose entry raised waits at most :data:`FAIL_WINDOW_S` for
the others to report, since they may be waiting for it inside a
collective, and then aborts its groups, which ends their waits at once. A
follower's error text reaches rank 0 through the world's store.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import functools
import io
import pickle
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional

import torch
import torch.distributed as dist

from ..errors import AppError
from ..reliability import get_logger

log = get_logger("asr.world")

STOP, BEAT, ENTRY = "stop", "beat", "entry"
# how long a rank whose entry raised waits for the others' outcome before
# it aborts the world (they may be blocked in a collective waiting for it)
FAIL_WINDOW_S = 5.0
ALIGN = 16  # byte alignment of each tensor in the packed buffer
LOG_LEN = 100_000  # entry names each rank keeps, newest last


class WorldError(AppError):
    """The serving world cannot serve: a rank failed an entry the others
    passed, or was lost. Every request fails with it from then on."""

    http_status = 503
    code = "world_degraded"

    def to_json(self) -> dict:
        return {**super().to_json(), "status": "ERROR"}


@dataclasses.dataclass
class ServingWorld:
    """This rank's side of a serving world."""

    rank: int
    size: int
    control: Any         # the gloo group of headers and outcomes
    timeout_s: float
    owned: bool          # this process joined the world (and leaves it)
    entries: Deque[str] = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=LOG_LEN))

    def error_key(self, rank: int) -> str:
        return f"amira/serve/error/{rank}"


def join_serving_world(timeout_s: float, owned: bool) -> ServingWorld:
    """This rank's :class:`ServingWorld` over the default process group;
    every rank calls it (it makes the gloo group of headers)."""
    control = dist.new_group(backend="gloo", timeout=datetime.timedelta(
        seconds=timeout_s))
    return ServingWorld(dist.get_rank(), dist.get_world_size(), control,
                        timeout_s, owned)


def mirrored(method: Optional[Callable] = None, *,
             follower_args: Optional[Callable] = None):
    """Mark a method of a served object (one with ``mirror`` and
    ``mirror_name`` attributes) as a device entry: with a mirror attached
    (rank 0 of a world) the outermost call is sent to the followers
    before it runs (:meth:`DispatchMirror.run`); otherwise it runs as it
    is. ``follower_args(*args, **kwargs) -> (args, kwargs)`` replaces
    what the followers get."""
    def wrap(fn):
        @functools.wraps(fn)
        def entry(self, *args, **kwargs):
            mirror = self.mirror
            if mirror is None:
                return fn(self, *args, **kwargs)
            return mirror.run(self, fn, args, kwargs, follower_args)
        return entry
    return wrap(method) if method is not None else wrap


# ---------------------------------------------------------------------------
# the wire: a pickled header with tensor slots, then one packed buffer
# ---------------------------------------------------------------------------
class _Packer(pickle.Pickler):
    def __init__(self, f, device_type: str, shared: Dict[int, str]):
        super().__init__(f, protocol=pickle.HIGHEST_PROTOCOL)
        self.device_type = device_type
        self.shared = shared
        self.tensors: List[torch.Tensor] = []

    def persistent_id(self, obj):
        if isinstance(obj, torch.Tensor) and \
                obj.device.type == self.device_type:
            self.tensors.append(obj)
            return ("t", len(self.tensors) - 1)
        name = self.shared.get(id(obj))
        return None if name is None else ("ref", name)


class _Unpacker(pickle.Unpickler):
    def __init__(self, f, tensors: List[torch.Tensor], owner):
        super().__init__(f)
        self.tensors = tensors
        self.owner = owner

    def persistent_load(self, pid):
        kind, key = pid
        return self.tensors[key] if kind == "t" else getattr(self.owner, key)


def _padded(n: int) -> int:
    return n + (-n) % ALIGN


def _send(world: ServingWorld, kind: str, body: Any = None,
          device_type: str = "cpu", shared: Optional[Dict[int, str]] = None
          ) -> None:
    buf = io.BytesIO()
    packer = _Packer(buf, device_type, shared or {})
    packer.dump(body)
    tensors = packer.tensors
    layout = [(tuple(t.shape), t.dtype, t.numel() * t.element_size())
              for t in tensors]
    dist.broadcast_object_list([(kind, buf.getvalue(), layout)], src=0,
                               group=world.control)
    if tensors:
        with torch.inference_mode():
            parts = []
            for t, (_, _, n) in zip(tensors, layout):
                parts.append(t.detach().contiguous().reshape(-1).view(
                    torch.uint8))
                if _padded(n) > n:
                    parts.append(torch.zeros(_padded(n) - n,
                                             dtype=torch.uint8,
                                             device=t.device))
            dist.broadcast(torch.cat(parts), src=0)


def _recv(world: ServingWorld, device: torch.device, owner):
    got = [None]
    dist.broadcast_object_list(got, src=0, group=world.control)
    kind, payload, layout = got[0]
    tensors: List[torch.Tensor] = []
    if layout:
        with torch.inference_mode():
            buf = torch.empty(sum(_padded(n) for _, _, n in layout),
                              dtype=torch.uint8, device=device)
            dist.broadcast(buf, src=0)
            off = 0
            for shape, dtype, n in layout:
                tensors.append(buf[off:off + n].view(dtype).reshape(shape))
                off += _padded(n)
    return kind, _Unpacker(io.BytesIO(payload), tensors, owner).load()


def _outcomes(world: ServingWorld, failed: bool) -> List[int]:
    """Every rank's outcome of the entry just run (1: it raised). A rank
    that raised waits at most :data:`FAIL_WINDOW_S`; RuntimeError when the
    exchange fails or times out."""
    got = [torch.zeros(1, dtype=torch.int32) for _ in range(world.size)]
    work = dist.all_gather(got, torch.tensor([int(failed)],
                                             dtype=torch.int32),
                           group=world.control, async_op=True)
    if failed:
        work.wait(datetime.timedelta(seconds=FAIL_WINDOW_S))
    else:
        work.wait()
    return [int(g) for g in got]


def _abort() -> None:
    """Destroy this rank's groups. Their connections close, and the other
    ranks' pending exchanges with this rank end with an error, only when
    the process exits (the groups stay referenced by the mesh), which is
    why a follower of a failed world exits (``server/app.main``)."""
    try:
        if dist.is_initialized():
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001 — aborting a group that already failed
        log.exception("aborting the serving world")


# ---------------------------------------------------------------------------
# rank 0
# ---------------------------------------------------------------------------
class DispatchMirror:
    """Rank 0's side: sends each outermost entry of ``pipeline`` (and of
    its lane engine) to the followers, keeps the world's health, and beats
    while idle. Attached as ``pipeline.mirror``."""

    def __init__(self, world: ServingWorld, pipeline):
        self.world = world
        self.lock = pipeline.device_lock
        self.device_type = pipeline.device.type
        # objects every follower holds too, sent by name
        self.shared = ({id(pipeline.beam_graph): "beam_graph"}
                       if pipeline.beam_graph is not None else {})
        self.degraded: Optional[str] = None
        self._depth = 0  # entries open on the thread that holds the lock
        self._closed = threading.Event()
        self._last_send = time.monotonic()
        # per entry name: [count, send seconds, outcome seconds]
        self._stats: Dict[str, List[float]] = {}
        # an idle world beats well inside the followers' wait timeout
        self.heartbeat_s = world.timeout_s / 4
        self._beat = None
        if world.size > 1:
            self._beat = threading.Thread(target=self._beat_loop,
                                          name="world-heartbeat",
                                          daemon=True)
            self._beat.start()

    # -- entries ------------------------------------------------------------
    def run(self, target, fn, args, kwargs, follower_args):
        with self.lock:
            if self._depth:
                return fn(target, *args, **kwargs)
            self._check()
            self._depth = 1
            try:
                return self._mirror(target, fn, args, kwargs, follower_args)
            finally:
                self._depth = 0

    def _check(self) -> None:
        if self.degraded is not None:
            raise WorldError(f"the serving world is degraded: "
                             f"{self.degraded}")
        if self._closed.is_set():
            raise WorldError("the serving world is closed")

    def _mirror(self, target, fn, args, kwargs, follower_args):
        name = f"{target.mirror_name}.{fn.__name__}"
        fa, fk = (follower_args(*args, **kwargs) if follower_args
                  else (args, kwargs))
        t0 = time.perf_counter()
        try:
            _send(self.world, ENTRY, (target.mirror_name, fn.__name__, fa,
                                      fk), self.device_type, self.shared)
        except RuntimeError as e:  # a lost rank, or the group's timeout
            raise self._degrade(f"sending {name}: {e}") from e
        t1 = time.perf_counter()
        self._last_send = time.monotonic()
        self.world.entries.append(name)
        try:
            out = fn(target, *args, **kwargs)
        except Exception as e:
            self._settle(name, e, t0, t1)
            raise
        self._settle(name, None, t0, t1)
        return out

    def _settle(self, name: str, failed: Optional[BaseException],
                t0: float, t1: float) -> None:
        """Exchange the entry's outcome; raise WorldError when the ranks
        disagree or the exchange fails."""
        t2 = time.perf_counter()
        try:
            outcomes = _outcomes(self.world, failed is not None)
        except RuntimeError as e:
            raise self._degrade(f"{name}: {self._peer_errors() or e}") \
                from (failed or e)
        st = self._stats.setdefault(name, [0, 0.0, 0.0])
        st[0] += 1
        st[1] += t1 - t0
        st[2] += time.perf_counter() - t2
        if len(set(outcomes)) > 1:
            ranks = [r for r, o in enumerate(outcomes) if o != outcomes[0]]
            raise self._degrade(
                f"{name}: ranks {ranks} disagree with rank 0 "
                f"({'rank 0 raised ' + repr(failed) if failed else ''}"
                f"{self._peer_errors()})") from failed

    def _peer_errors(self) -> str:
        from .multihost import world_store
        store = world_store()
        if store is None:
            return ""
        texts = []
        for r in range(1, self.world.size):
            key = self.world.error_key(r)
            try:
                if store.check([key]):
                    texts.append(store.get(key).decode())
            except RuntimeError:  # the store is rank 0's: rarely lost
                break
        return "; ".join(texts)

    def _degrade(self, reason: str) -> WorldError:
        log.error("serving world degraded: %s", reason)
        self.degraded = reason
        _abort()
        return WorldError(f"the serving world is degraded: {reason}")

    # -- idle and close -----------------------------------------------------
    def _beat_loop(self) -> None:
        while not self._closed.wait(self.heartbeat_s / 2):
            if time.monotonic() - self._last_send < self.heartbeat_s / 2:
                continue
            if not self.lock.acquire(timeout=1.0):
                continue  # an entry is under way: that is traffic enough
            try:
                if self.degraded is None and not self._closed.is_set():
                    _send(self.world, BEAT)
                    self._last_send = time.monotonic()
            except RuntimeError as e:
                self._degrade(f"heartbeat: {e}")
            finally:
                self.lock.release()

    def close(self) -> None:
        """Stop the followers (they exit with 0) and the heartbeat; every
        later entry raises :class:`WorldError`."""
        with self.lock:
            if self._closed.is_set():
                return
            self._closed.set()
            if self.degraded is None:
                try:
                    _send(self.world, STOP)
                except RuntimeError as e:
                    log.warning("stopping the followers: %s", e)
        if self._beat is not None:
            self._beat.join(timeout=5.0)

    def health(self) -> dict:
        return {"ranks": self.world.size,
                "status": "degraded" if self.degraded else "ok",
                **({"reason": self.degraded[:500]} if self.degraded else {})}

    def to_json(self) -> dict:
        """The world's health and, per entry name, its count and mean ms
        spent sending it (header and tensors) and exchanging outcomes."""
        with self.lock:
            stats = {k: {"count": int(n), "mirror_ms": s / n * 1e3,
                         "outcome_ms": o / n * 1e3}
                     for k, (n, s, o) in self._stats.items()}
        return {**self.health(), "entries": len(self.world.entries),
                "per_entry": stats}


# ---------------------------------------------------------------------------
# the other ranks
# ---------------------------------------------------------------------------
def follow(state) -> int:
    """Run rank 0's entries on this rank's replica of ``state`` (an
    ``AppState`` built with the same config) until rank 0 stops the world:
    0 then; 1 when the world failed (this rank's entry raised where rank
    0's did not, or rank 0 was lost), after aborting the groups. After 1
    the caller ends the process at once (``os._exit``), which closes the
    connections the other ranks may be blocked on."""
    world: ServingWorld = state.world
    pipe = state.pipeline
    targets = {"pipeline": pipe, "lanes": state.lane_engine}
    from .multihost import world_store
    store = world_store()
    while True:
        try:
            kind, body = _recv(world, pipe.device, pipe)
        except RuntimeError as e:
            log.error("rank %d lost rank 0: %s", world.rank, e)
            _abort()
            return 1
        if kind == BEAT:
            continue
        if kind == STOP:
            return 0
        target, method, args, kwargs = body
        name = f"{target}.{method}"
        world.entries.append(name)
        failed = None
        try:
            getattr(targets[target], method)(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 — reported to rank 0 below
            failed = e
            log.exception("rank %d: %s raised", world.rank, name)
            if store is not None:
                store.set(world.error_key(world.rank),
                          f"rank {world.rank}: {name}: "
                          f"{type(e).__name__}: {e}"[:2000])
        try:
            outcomes = _outcomes(world, failed is not None)
        except RuntimeError as e:
            log.error("rank %d: the outcome of %s was not exchanged: %s",
                      world.rank, name, e)
            _abort()
            return 1
        if len(set(outcomes)) > 1:
            log.error("rank %d: %s: outcomes %s disagree; leaving the "
                      "world", world.rank, name, outcomes)
            _abort()
            return 1
        if failed is not None and store is not None:
            store.delete_key(world.error_key(world.rank))
