"""The HTTP handler's host time outside the batcher per request
(server/app.py): the benchmark's middleware span minus its span around
batcher.submit."""

from gpubench import readers


def read(ctx):
    return readers.http_host_ms(ctx)
