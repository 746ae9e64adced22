"""Mean wall of the port's dispatch.stage span (runtime/pipeline.py): a
dispatch's audio and carry staged into its bucket program's static inputs,
over the dispatches that start in the window (ms)."""

from gpubench import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "dispatch.stage")
