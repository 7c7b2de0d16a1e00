"""The mean ``serve/score`` span of the window (host lookup, H2D,
forward and D2H of one coalesced batch), in ms."""


def read(ctx: dict):
    spans = ctx.get("score_s")
    return sum(spans) / len(spans) * 1e3 if spans else None
