"""The share of the device's idle time in the profiled pass that the
main thread spent waiting on the pack thread: the seconds of the
breakdown's ``idle_gaps`` whose host op is the program's ``pbt/read``
range, over ``window_s - busy_s``. The breakdown keeps only its top 10
entries and skips gaps under 50 us, so this counts what those entries
hold. None on an empty window, or where no gap is named by a ``pbt/``
range (a program that opens none)."""


def read(ctx: dict):
    prof = ctx.get("profile")
    if not prof or prof["window_s"] - prof["busy_s"] <= 0:
        return None
    gaps = prof["idle_gaps"]
    if not any(": pbt/" in name for name, _ in gaps):
        return None
    return (sum(s for name, s in gaps if name.endswith(": pbt/read"))
            / (prof["window_s"] - prof["busy_s"]))
