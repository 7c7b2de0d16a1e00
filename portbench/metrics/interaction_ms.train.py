"""The model's interaction alone, forward and backward, on one batch of
the last pass (DLRM-DCNv2's cross network), as device time in ms:
``utils.step_probe.attribute_step``'s isolated ``interaction``. Absent
for a program whose step probe does not time it."""


def read(ctx: dict):
    t = ctx.get("isolated", {}).get("interaction")
    if not t or t <= 0:
        return None
    return t * 1e3
