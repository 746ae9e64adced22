"""The AED dispatch's decode stage on the device (models/aed.py: the cross
K/V, the prompt's prefill and the decode loop), ms per dispatch: the
port's counters aed.decode_device_s_total over aed.dispatches, differenced
over the window."""

from gpubench.readers_aed import device_ms


def read(ctx):
    return device_ms(ctx, "decode_device_s_total")
