"""Mean binned entries per frame (the program's RenderOutput.num_entries)."""


def read(ctx):
    if ctx["kind"] != "render" or not ctx.get("num_entries"):
        return None
    return sum(ctx["num_entries"]) / len(ctx["num_entries"])
