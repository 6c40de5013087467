"""Frames whose image reached the host in the window over its seconds."""


def read(ctx):
    if ctx["kind"] != "render":
        return None
    return ctx["attempted"] / ctx["window_s"]
