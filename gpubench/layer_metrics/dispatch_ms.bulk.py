"""Mean wall of one device dispatch, decode_samples_batch
(runtime/pipeline.py, runtime/programs.py)."""

from gpubench import readers


def read(ctx):
    return readers.mean_span_ms(ctx, "dispatch")
