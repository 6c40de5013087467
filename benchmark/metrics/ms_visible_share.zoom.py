"""Rows the MS selection leaves visible over live rows, summed over the
traced frames (the program's RenderOutput.visible)."""


def read(ctx):
    if ctx["kind"] != "render" or not ctx.get("visible") or not ctx["live"]:
        return None
    return 100.0 * sum(ctx["visible"]) / (ctx["live"] * len(ctx["visible"]))
