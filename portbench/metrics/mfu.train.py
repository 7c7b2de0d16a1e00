"""The training step's share of the card's float32 peak, in %: the model
FLOPs of an example (``counts/flops.py``: the dense nets' products and
the interaction, forward and backward) times the traced window's
examples/s, over the published peak of the configuration's precision."""


def read(ctx: dict):
    peak = ctx.get("peak_flops")
    if not peak:
        return None
    return ctx["flops_per_example"] * ctx["examples_per_s"] / peak * 100.0
