"""The cross network's share of the card's float32 peak, in %: its FLOPs
on one batch (``families/dlrm_dcnv2.py``'s
``interaction_flops_per_example`` times the configuration's batch) over
the peak, over the device time of the cross alone, forward and backward
(``utils.step_probe.attribute_step``'s isolated ``interaction``). Only
``dlrm_dcnv2_criteo_1tb.train`` lists it, so its configuration is loaded
by name."""

from portbench import harness

CONFIG = "dlrm_dcnv2_criteo_1tb"


def read(ctx: dict):
    peak = ctx.get("peak_flops")
    t = ctx.get("isolated", {}).get("interaction")
    if not peak or not t or t <= 0:
        return None
    cfg = harness.config(CONFIG)
    fam = harness.load_module("families", cfg["family"])
    flops = fam.interaction_flops_per_example(cfg) * cfg["batch_size"]
    return flops / peak / t * 100.0
