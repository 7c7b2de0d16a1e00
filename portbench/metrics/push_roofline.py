"""The sparse push's share of its roofline, in %: the least time for its
bytes (``counts/sectors.py``'s ``push_bytes`` over the card's memory
rate) over the push alone on one batch of the last pass, as device time
(``utils.step_probe.attribute_step``'s isolated ``sparse_push``)."""


def read(ctx: dict):
    rate, t = ctx.get("hbm_bytes_per_s"), ctx.get("isolated", {}).get(
        "sparse_push")
    if not rate or not t or t <= 0:
        return None
    return ctx["push_bytes"] / rate / t * 100.0
