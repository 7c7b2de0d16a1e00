"""The share of the device's idle time in the profiled pass that no
host range names: the seconds of the breakdown's ``idle_gaps`` entries
that end in ``: python`` (no host op or range around the gap's middle),
over ``window_s - busy_s``. The breakdown keeps only its top 10 entries
and skips gaps under 50 us, so this counts what those entries hold.
None on an empty window."""


def read(ctx: dict):
    prof = ctx.get("profile")
    if not prof or prof["window_s"] - prof["busy_s"] <= 0:
        return None
    return (sum(s for name, s in prof["idle_gaps"]
                if name.endswith(": python"))
            / (prof["window_s"] - prof["busy_s"]))
