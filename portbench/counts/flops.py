"""Model FLOPs of one training example, forward and backward, and the
card's published peaks. Each family's count is in
``families/<family>.py``, from ``_mlp`` and the rules below.

A matrix product of an (m, k) by a (k, n) operand is 2 m k n FLOPs. The
backward of a dense layer computes the weight gradient (as many FLOPs as
the forward) and the input gradient (as many again), except where the
input needs no gradient: the first layer of a network fed only by the
dense floats. The counts cover the dense nets' products and the
interaction; the elementwise work (activations, the loss, the FM sums,
the sums that pool a multi-hot field's rows) is below a thousandth of it
and left out, so a share of the peak read from them is a lower bound.
"""

from __future__ import annotations

from portbench import harness

# published dense peaks, FLOP/s, by torch.cuda.get_device_name(); NVIDIA's
# H100 SXM data sheet at its 700 W limit. "float32" is the rate outside
# the tensor cores, the one a float32 product runs at with TF32 off.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"float32": 67e12, "tf32": 495e12,
                              "bfloat16": 989e12},
}
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def _mlp(dims, first_needs_grad: bool) -> float:
    fwd = sum(2.0 * a * b for a, b in zip(dims[:-1], dims[1:]))
    first = 2.0 * dims[0] * dims[1]
    return 3.0 * fwd - (0.0 if first_needs_grad else first)


def train_flops_per_example(cfg: dict) -> float:
    """The configuration's family counts them:
    ``families/<family>.py``'s ``train_flops_per_example``."""
    return harness.load_module("families", cfg["family"]) \
        .train_flops_per_example(cfg)
