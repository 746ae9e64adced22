"""The host's cores, split between the server and the load generator.

The load generator takes the last :data:`GENERATOR_CORES` of the cores the
run may use and the server the rest, so that the client's work never takes
a core from the server's threads, as it would not from a client host of its
own. ``run.py`` pins itself with :func:`pin` before it imports torch or
numpy, whose thread pools size themselves by the cores they may use; the
harness starts the generator on :data:`generator`.
"""

import os

GENERATOR_CORES = 2
generator = None  # the generator's cores once pin() has split them


def split(cpus) -> tuple:
    """(server cores, generator cores) of ``cpus``, or (None, None) where
    there are too few to split."""
    cpus = sorted(cpus)
    if len(cpus) < 2 * GENERATOR_CORES + 1:
        return None, None
    return set(cpus[:-GENERATOR_CORES]), set(cpus[-GENERATOR_CORES:])


def pin() -> None:
    """Pin this process to the server's cores and keep the generator's."""
    global generator
    server, generator = split(os.sched_getaffinity(0))
    if server:
        os.sched_setaffinity(0, server)
