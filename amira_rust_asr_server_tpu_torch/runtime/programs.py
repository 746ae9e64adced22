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

The caller serializes runs of all programs of one device behind one lock
(``AsrPipeline.device_lock``): a capture in PyTorch's default "global"
mode makes other threads' CUDA calls fail while it lasts, and programs of
one pipeline share one memory pool, so no two may run at once.
"""

from __future__ import annotations

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
                 pool=None, capture: bool = True):
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
        self.pool = pool              # a graph memory pool shared by owner
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Optional[Tuple[torch.Tensor, ...]] = None
        self.launches: Dict[str, int] = {}  # hand kernels one replay runs
        self.capture_seconds: Optional[float] = None
        self.graph_bytes: Optional[int] = None  # pool growth at capture
        self._pinned: Dict[int, torch.Tensor] = {}

    @property
    def warm(self) -> bool:
        """Captured (CUDA), or run once (CPU, or not captured)."""
        return self.outputs is not None

    def warm_up(self) -> None:
        """Make the program ready to run (see :meth:`run`) on the static
        inputs as they are."""
        if not self.warm:
            self.run()

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
        try:
            # the wrappers' launches are recorded here, not counted
            with kernels.recording_launches() as recorded, \
                    torch.inference_mode(), \
                    torch.cuda.graph(graph, pool=self.pool):
                captured = tuple(self.body())
        except Exception as e:
            raise RuntimeError(
                f"CUDA graph capture of {self.name} failed: {e}") from e
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
