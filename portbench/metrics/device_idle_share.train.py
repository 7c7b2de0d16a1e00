"""1 - the union of device operations' intervals / the wall time, over
one whole pass of the window traced by torch.profiler."""


def read(ctx: dict):
    prof = ctx.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 1.0 - prof["busy_s"] / prof["window_s"]
