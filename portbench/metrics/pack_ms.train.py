"""The pack thread's host time a batch (translate, push plan, pin):
``Trainer.timers["translate"]`` over the window, total / count, in ms."""


def read(ctx: dict):
    total, count = ctx["timers"]["translate"]
    return total / count * 1e3 if count else None
