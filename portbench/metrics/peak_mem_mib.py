"""torch.cuda.max_memory_allocated() over set-up and window, in MiB:
the scene, the accel, the compiled programs and their pools included."""


def read(ctx):
    return ctx.peak_bytes / 2**20 if ctx.peak_bytes > 0 else None
