"""train_step calls completed in the window over its seconds."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return ctx["attempted"] / ctx["window_s"]
