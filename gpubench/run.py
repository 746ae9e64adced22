"""Run one cell of the benchmark once (see ``gpubench/harness.py``):

    python3 gpubench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. The last line of standard output is the
result's JSON object.
"""

import sys
import time

T_START = time.monotonic()  # set-up counts from the process's start

if __name__ == "__main__":
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    if "--rehearse-cpu" not in sys.argv:
        from gpubench import cores
        cores.pin()  # before torch and numpy size their thread pools
    from gpubench.harness import main
    sys.exit(main(t_start=T_START))
