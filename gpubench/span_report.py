"""Run one cell once, as ``run.py`` does, and report the port's own spans
in its traced window:

    python3 gpubench/span_report.py --workload NAME --seed N --seconds S --trace 1

from the root of a checkout. Standard output ends with the run's result
line and then one line ``{"program_spans": ...}``
(``program_spans.summary``): the device's idle time by the program span
open in it, the share of it those spans label, and the port's span means
beside the benchmark's own wrappers. A run without a device trace, or
whose ring dropped spans inside the window, reports ``null``. This is a
diagnostic beside the benchmark; no metric reads it.
"""

import json
import sys
import time

T_START = time.monotonic()  # set-up counts from the process's start


def main(argv=None, t_start: float = None) -> int:
    from gpubench import harness, program_spans
    seen: dict = {}
    load = harness.load_reader

    def keeping_ctx(kind: str, name: str):
        read = load(kind, name)

        def reading(ctx):
            seen.setdefault("ctx", ctx)
            return read(ctx)
        return reading

    harness.load_reader = keeping_ctx  # the run's readers see its context
    try:
        rc = harness.main(argv, t_start=t_start)
    finally:
        harness.load_reader = load
    ctx = seen.get("ctx")
    print(json.dumps({"program_spans": None if ctx is None
                      else program_spans.report(ctx)}), flush=True)
    return rc


if __name__ == "__main__":
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    if "--rehearse-cpu" not in sys.argv:
        from gpubench import cores
        cores.pin()  # before torch and numpy size their thread pools
    sys.exit(main(t_start=T_START))
