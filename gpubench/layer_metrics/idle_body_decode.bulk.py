"""Share (%) of the traced window in which the device was idle, no
dispatch was open and the event loop was in an http.decode span
(server/app.py): device idleness the body work on the loop explains."""

from gpubench import program_spans


def read(ctx):
    return program_spans.idle_body_decode(ctx)
