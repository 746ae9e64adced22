"""One captured program per fixed-shape piece of device work: the port of
the reference's one jitted program per (batch, length) bucket
(``jax.jit(self._forward)``) and per lane-engine chunk step.

A :class:`DeviceProgram` owns static device inputs (its caller fills them
before each run), a body that reads them, and static outputs. On CUDA its
first run is the warm-up: the body runs eagerly once (the kernels' library,
their device tables, the weights' block slices and every other cache made
lazily come into being; that run's results are the first run's), then the
body is captured as one ``torch.cuda.CUDAGraph`` and every later run
replays it. A capture that fails raises, naming the program; nothing falls
back to running eagerly. On the
CPU (the caller asked for it) the body runs every time and its results are
copied into the same static outputs, so the CPU tests exercise the buffer
reuse the graphs rely on: a run overwrites the last run's outputs. A
program made with ``capture=False`` runs so on CUDA too: the programs of a
pipeline placed on a device mesh, whose layers call collectives and
DTensor redistributions from the host on every run (``models/tp.py``).

A program may run in stages (a tuple of bodies, each taking the outputs of
the one before). On a card a timing event is recorded before, between and
after them, and the capture holds those records as event nodes of the one
graph, so a replay is still one launch and the device time of each stage
(:meth:`DeviceProgram.stage_seconds`) is read after the run's readback with
no wait of its own. The AED family times its encoder and its decode loop so.

A program may open a loop that a :class:`FlagLoop` finishes: one captured
piece of the loop on the owner's static state, replayed while the 1-element
device flag the piece before it left says the loop is live, the flag read
one piece behind. :meth:`DeviceProgram.run_through` runs the program, then
its loop; the transducer's per-step route and the AED's decoder loop so.

The caller serializes runs of all programs of one device behind one lock
(``AsrPipeline.device_lock``): a capture in PyTorch's default "global"
mode makes other threads' CUDA calls fail while it lasts, and programs of
one pipeline share one memory pool, so no two may run at once.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops import kernels

Body = Callable[..., Sequence[torch.Tensor]]


class DeviceProgram:
    """``body()`` returns the program's outputs, a sequence of tensors; it
    reads the static inputs its owner allocated and may update other
    static state in place (the lane engine's carry and cache). ``body`` may
    be a tuple of stages instead: the first is called with no argument,
    each later one with the outputs of the one before, and the last one's
    outputs are the program's."""

    def __init__(self, name: str, device: torch.device,
                 body: Union[Body, Tuple[Body, ...]],
                 inputs: Optional[Dict[str, torch.Tensor]] = None,
                 pool=None, capture: bool = True,
                 loop: Optional["FlagLoop"] = None,
                 oracle: Optional[Body] = None,
                 state: Sequence[torch.Tensor] = ()):
        self.name = name
        self.device = device
        self.stages = tuple(body) if isinstance(body, tuple) else (body,)
        self.body = body if len(self.stages) == 1 else self._staged
        self.capture = capture and device.type == "cuda"
        # a staged program's timing events, on a card only; ``external``
        # makes a capture hold their records as nodes of its graph
        self._marks: Optional[List[torch.cuda.Event]] = None
        if len(self.stages) > 1 and device.type == "cuda":
            self._marks = [torch.cuda.Event(enable_timing=True,
                                            external=True)
                           for _ in range(len(self.stages) + 1)]
        self._timed = False  # the marks hold a whole run
        # the static inputs by name, and the host buffers they are filled
        # from (:func:`host_staging`), both the owner's to allocate
        self.inputs = inputs or {}
        self.host: Dict[str, torch.Tensor] = {}
        # the loop the body opens with its last output, the whole run
        # without a loop (the eager oracle), and the static state the owner
        # fills from a caller's tensors and copies back (a stream's chunk)
        self.loop = loop
        self.oracle = oracle
        self.state = list(state)
        self.pool = pool              # a graph memory pool shared by owner
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Optional[Tuple[torch.Tensor, ...]] = None
        self.launches: Dict[str, int] = {}  # hand kernels one replay runs
        self.capture_seconds: Optional[float] = None
        self.graph_bytes: Optional[int] = None  # pool growth at capture
        self._pinned: Dict[int, torch.Tensor] = {}

    @property
    def warm(self) -> bool:
        """Captured (CUDA), or run once (CPU, or not captured), and so is
        the piece of its loop."""
        return self.outputs is not None and (
            self.loop is None or self.loop.program.outputs is not None)

    def warm_up(self) -> None:
        """Make the program ready to run (see :meth:`run`) on the static
        inputs as they are, then its loop's piece on the state it left."""
        if self.outputs is None:
            self.run()
        if self.loop is not None:
            self.loop.warm_up()

    def run_through(self, eager: bool = False
                    ) -> Tuple[Tuple[torch.Tensor, ...], int]:
        """The program, then its loop from the flag it returns last: (its
        outputs with the loop's result for the flag, the pieces run).
        ``eager`` runs the oracle, or the bodies instead of the replays."""
        if eager and self.oracle is not None:
            with torch.inference_mode():
                return tuple(self.oracle()), 0
        outs = self.run_eager() if eager else self.run()
        if self.loop is None:
            return outs, 0
        with torch.inference_mode():
            pieces = self.loop.finish(outs[-1], eager)
            return (*outs[:-1], *self.loop.result()), pieces

    def run(self) -> Tuple[torch.Tensor, ...]:
        """One run on the static inputs. On CUDA the first run is the
        warm-up: the body runs eagerly (its results are this run's), then
        it is captured, which records and does not execute; every later run
        replays the graph and returns its static outputs. On the CPU the
        body runs and its results are copied into the static outputs.
        Either way the next run overwrites what this one returned, and the
        body's effects on static state happen once per run. A program
        that does not capture runs as on the CPU."""
        if not self.capture:
            with torch.inference_mode():
                outs = tuple(self.body())
            if self.outputs is None:
                self.outputs = tuple(x.clone() for x in outs)
            else:
                for dst, src in zip(self.outputs, outs):
                    dst.copy_(src)
            return self.outputs
        if self.graph is None:
            return self._run_and_capture()
        self.graph.replay()
        kernels.add_launches(self.launches)
        return self.outputs

    def _staged(self) -> Tuple[torch.Tensor, ...]:
        """The stages in order, a timing mark before, between and after."""
        outs: Tuple[torch.Tensor, ...] = ()
        self._mark(0)
        for i, stage in enumerate(self.stages):
            outs = tuple(stage(*outs))
            self._mark(i + 1)
        return outs

    def _mark(self, i: int) -> None:
        if self._marks is not None:
            self._marks[i].record()
            self._timed = True

    def stage_seconds(self) -> Optional[List[float]]:
        """The device time of each stage of the last run, in seconds; None
        off a card, for a program of one stage, or before a run. These are
        the events' times, which need the run to have finished: read them
        after the run's readback (:meth:`to_host` waits for the stream)."""
        if not self._timed:
            return None
        m = self._marks
        return [m[i].elapsed_time(m[i + 1]) / 1e3 for i in range(len(m) - 1)]

    def _run_and_capture(self) -> Tuple[torch.Tensor, ...]:
        dev = self.device
        with torch.inference_mode():
            outs = tuple(self.body())
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()  # so the pool's growth reads apart
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        # no garbage collection inside the capture: a collected cycle that
        # holds a captured graph (a dropped pipeline's programs) resets it,
        # a call a capture forbids, and the capture fails
        collecting = gc.isenabled()
        gc.disable()
        try:
            # the wrappers' launches are recorded here, not counted
            with kernels.recording_launches() as recorded, \
                    torch.inference_mode(), \
                    torch.cuda.graph(graph, pool=self.pool):
                captured = tuple(self.body())
        except Exception as e:
            raise RuntimeError(
                f"CUDA graph capture of {self.name} failed: {e}") from e
        finally:
            if collecting:
                gc.enable()
        self.capture_seconds = time.perf_counter() - t0
        self.graph_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.launches = dict(recorded)
        self.graph, self.outputs = graph, captured
        return outs

    def run_eager(self) -> Tuple[torch.Tensor, ...]:
        """The body run eagerly on the static inputs, never captured: the
        oracle a replay is held to (tests, ``chip_smoke.py``). Returns the
        body's own results."""
        with torch.inference_mode():
            return tuple(self.body())

    def to_host(self, tensors: Sequence[torch.Tensor]) -> Tuple[np.ndarray,
                                                                 ...]:
        """Copies of ``tensors`` on the host, in one wait for the device:
        each goes to a pinned buffer of this program without blocking, then
        the stream is synchronized once."""
        if self.device.type != "cuda":
            return tuple(x.numpy().copy() for x in tensors)
        staged = []
        for i, x in enumerate(tensors):
            buf = self._pinned.get(i)
            if buf is None or buf.shape != x.shape or buf.dtype != x.dtype:
                buf = self._pinned[i] = torch.empty(
                    x.shape, dtype=x.dtype, pin_memory=True)
            buf.copy_(x, non_blocking=True)
            staged.append(buf)
        torch.cuda.current_stream(self.device).synchronize()
        return tuple(b.numpy().copy() for b in staged)


class FlagLoop:
    """A loop on its owner's static state, which the owner's program opens:
    ``piece()`` advances the state and returns a 1-element bool device flag
    "the loop is live", ``result()`` reads the outputs off the state. The
    piece is one program in the owner's pool. Each piece is queued before
    the flag the one before it left is read, so the device does not wait
    for the host and the loop runs one piece past its end, which must
    change none of its results. ``limit`` caps the pieces (None: until the
    flag reads false)."""

    def __init__(self, name: str, device: torch.device,
                 piece: Callable[[], torch.Tensor],
                 result: Callable[[], Sequence[torch.Tensor]], *,
                 limit: Optional[int] = None, pool=None,
                 capture: bool = True):
        self.program = DeviceProgram(name, device, lambda: (piece(),),
                                     pool=pool, capture=capture)
        self.result = result
        self.limit = limit
        self.reads = 0   # flags read on the host
        self.pieces = 0  # pieces run
        cuda = device.type == "cuda"
        self._host = [torch.zeros(1, dtype=torch.bool, pin_memory=cuda)
                      for _ in range(2)]
        # after each pinned copy, then timed around a finish's pieces (a
        # card only)
        self._events = ([torch.cuda.Event(enable_timing=i >= 2)
                         for i in range(4)] if cuda else None)

    def warm_up(self) -> None:
        """Make the piece ready (captured) on the state as it stands."""
        self.program.warm_up()

    def finish(self, flag: torch.Tensor, eager: bool = False) -> int:
        """After the owner's program has queued the loop's opening, which
        left ``flag``: the piece, queued again until the flag the piece
        before it left reads false or :attr:`limit` pieces have run; returns
        the pieces run. ``eager`` runs the piece's body instead of its
        replay."""
        run = self.program.run_eager if eager else self.program.run
        self._post(flag, 0)
        self._record(2)
        ran = 0
        while self.limit is None or ran < self.limit:
            (flag,) = run()
            ran += 1
            self._post(flag, ran % 2)
            self.reads += 1
            if self._events is not None:
                self._events[(ran - 1) % 2].synchronize()
            if not self._host[(ran - 1) % 2][0]:
                break
        self._record(3)
        self.pieces += ran
        return ran

    def _post(self, flag: torch.Tensor, i: int) -> None:
        self._host[i].copy_(flag, non_blocking=True)
        self._record(i)

    def _record(self, i: int) -> None:
        if self._events is not None:
            self._events[i].record()

    def seconds(self) -> Optional[float]:
        """The device time of the last finish's pieces, flag waits
        included; None off a card. Read it after the owner's readback,
        which waited for the device."""
        if self._events is None:
            return None
        return self._events[2].elapsed_time(self._events[3]) / 1e3


def host_staging(shape, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """A host buffer a program's static input is filled from: pinned when
    the program is on CUDA, so the copy does not block."""
    return torch.zeros(shape, dtype=dtype,
                       pin_memory=device.type == "cuda")


def stage(static: torch.Tensor, host: torch.Tensor) -> None:
    """Copy a filled host buffer into its static input, without blocking
    (the next run is ordered after it on the same stream)."""
    with torch.inference_mode():
        static.copy_(host, non_blocking=True)
