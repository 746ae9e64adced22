"""Host readings of the window, printed beside the result for the log: the
share of a core that the server process, its event loop and the load
generator each used, and the server's garbage collector's pauses. CPU
time is read as the kernel accounts it, in ticks of up to 10 ms, so a
share is sound over a window of seconds and not per request."""

from __future__ import annotations

import gc
import os
import resource
import time


class HostStats:
    """Samples of the server process (this one) and of the generator's
    process ``generator_pid``; take them on the event loop's thread."""

    def __init__(self, generator_pid: int):
        self.pid = generator_pid
        self.gc_s = [0.0, 0.0, 0.0]
        self.gc_n = [0, 0, 0]
        self._t = None
        gc.callbacks.append(self._gc)

    def _gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            g = info["generation"]
            self.gc_s[g] += time.perf_counter() - self._t
            self.gc_n[g] += 1
            self._t = None

    def _generator_cpu(self):
        """The generator's user and system seconds (``/proc/<pid>/stat``)."""
        try:
            with open(f"/proc/{self.pid}/stat", "r", encoding="ascii") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            return (int(fields[11]) + int(fields[12])) / os.sysconf(
                "SC_CLK_TCK")
        except (OSError, ValueError, IndexError):
            return None

    def sample(self) -> dict:
        ru = resource.getrusage(resource.RUSAGE_SELF)
        return {"t": time.monotonic(), "cpu": ru.ru_utime + ru.ru_stime,
                "sys": ru.ru_stime, "loop": time.thread_time(),
                "generator": self._generator_cpu(),
                "gc_s": list(self.gc_s), "gc_n": list(self.gc_n)}

    def close(self) -> None:
        if self._gc in gc.callbacks:
            gc.callbacks.remove(self._gc)


def summary(a: dict, b: dict) -> dict:
    """What the window between samples ``a`` and ``b`` used."""
    dt = b["t"] - a["t"]
    gen = (None if a["generator"] is None or b["generator"] is None
           else (b["generator"] - a["generator"]) / dt)
    return {"server_cpu_share": (b["cpu"] - a["cpu"]) / dt,
            "server_sys_share": (b["sys"] - a["sys"]) / dt,
            "event_loop_cpu_share": (b["loop"] - a["loop"]) / dt,
            "generator_cpu_share": gen,
            "gc_ms_by_generation": [(y - x) * 1e3 for x, y in
                                    zip(a["gc_s"], b["gc_s"])],
            "gc_count_by_generation": [y - x for x, y in
                                       zip(a["gc_n"], b["gc_n"])]}
