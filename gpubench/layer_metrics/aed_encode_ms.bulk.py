"""The AED dispatch's encoder stage on the device (models/encoder.py: the
log-mel and the encoder), ms per dispatch: the port's counters
aed.encode_device_s_total over aed.dispatches, differenced over the
window (none off the card)."""

from gpubench.readers_aed import device_ms


def read(ctx):
    return device_ms(ctx, "encode_device_s_total")
