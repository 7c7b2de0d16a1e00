"""The main thread's host time in ``train_step`` a step (its dispatch,
and any wait on the device inside it): ``Trainer.timers["train"]`` over
the window / the window's steps, in ms."""


def read(ctx: dict):
    total, _ = ctx["timers"]["train"]
    return total / ctx["steps"] * 1e3 if ctx["steps"] else None
