"""Mean wall of the port's http.decode span (server/app.py): the body's
synchronous work on the event loop (JSON, validation and base64, PCM) per
request, over the requests that start in the window (ms)."""

from gpubench import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "http.decode")
