"""The mean examples a scored batch over the window, from the
frontend's own counts of batches and batched examples."""


def read(ctx: dict):
    return ctx["batched"] / ctx["batches"] if ctx.get("batches") else None
