"""Set-up time: the process's start to the first timed step or frame (import,
the CUDA library's build or load, the scene, targets, warm-up)."""


def read(ctx):
    return ctx.get("setup_s")
