"""Set-up: the process's start to the window's open (loading, weights,
warm-up and capture, the blank bias, the server)."""


def read(ctx):
    return ctx["setup_s"]
