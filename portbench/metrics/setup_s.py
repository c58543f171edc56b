"""Process start to the first timed call (host clock)."""


def read(ctx):
    return ctx.setup_s
