"""The pass boundary's build on the main thread a pass, timed from
inside: ``Trainer.timers["feed_begin"]`` (all of
``FeedPassManager.begin_pass``, its queued copies waited for) over the
window / the window's passes, in s. None where the program has no such
stage."""


def read(ctx: dict):
    t = ctx["timers"].get("feed_begin")
    return t[0] / len(ctx["passes"]) if t and ctx["passes"] else None
