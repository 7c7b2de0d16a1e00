"""The lazy write-back a pass: the D2H of the rows retiring from the
device working set and their write into the host store, inside the pass
boundary's build: ``Trainer.timers["writeback"]`` over the window / the
window's passes, in s. None where the program has no such stage."""


def read(ctx: dict):
    t = ctx["timers"].get("writeback")
    return t[0] / len(ctx["passes"]) if t and ctx["passes"] else None
