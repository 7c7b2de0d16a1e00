"""The step loop's wait on the pack thread a step:
``Trainer.timers["read"]`` over the window / the window's steps, in ms."""


def read(ctx: dict):
    total, _ = ctx["timers"]["read"]
    return total / ctx["steps"] * 1e3 if ctx["steps"] else None
