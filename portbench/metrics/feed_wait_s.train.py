"""The main thread's joins on the feed thread a pass, where
``FeedPassManager.begin_pass`` and ``begin_feed_pass`` make them (a
staging still running when the main thread needs it):
``Trainer.timers["feed_wait"]`` over the window / the window's passes,
in s. None where the program has no such stage."""


def read(ctx: dict):
    t = ctx["timers"].get("feed_wait")
    return t[0] / len(ctx["passes"]) if t and ctx["passes"] else None
