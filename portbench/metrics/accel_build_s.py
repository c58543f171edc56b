"""Accel build: host seconds around the program's build_accel in set-up,
synchronised on both sides."""


def read(ctx):
    return ctx.accel_build_s
