"""Model FLOPs of one training example, forward and backward, and the
card's published peaks.

A matrix product of an (m, k) by a (k, n) operand is 2 m k n FLOPs. The
backward of a dense layer computes the weight gradient (as many FLOPs as
the forward) and the input gradient (as many again), except where the
input needs no gradient: the first layer of a network fed only by the
dense floats. The counts cover the dense nets' products and the
interaction; the elementwise work (activations, the loss, the FM sums)
is below a thousandth of it and left out, so a share of the peak read
from them is a lower bound.
"""

from __future__ import annotations

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


def deepfm(cfg: dict) -> float:
    """DeepFM: the deep net over [w, embedding] of every slot and the
    dense floats; its input carries the pulled rows, so its first layer
    takes an input gradient too."""
    s, d = cfg["num_sparse"], cfg["embedding_dim"]
    dims = [s * (1 + d) + cfg["num_dense"], *cfg["hidden"], 1]
    return _mlp(dims, first_needs_grad=True)


def dlrm(cfg: dict) -> float:
    """DLRM: the bottom net over the dense floats (no input gradient),
    the (S+1) x (S+1) Gram matrix of [bottom output, slot embeddings] as
    one batched product (its backward two more), and the top net over
    [bottom output, the upper triangle, the slots' w column]."""
    s, d = cfg["num_sparse"], cfg["embedding_dim"]
    bottom = [cfg["num_dense"], *cfg["bottom_hidden"], d]
    n = s + 1
    top = [d + n * (n - 1) // 2 + s, *cfg["top_hidden"], 1]
    gram = 3.0 * 2.0 * n * n * d
    return (_mlp(bottom, first_needs_grad=False) + gram
            + _mlp(top, first_needs_grad=True))


FAMILIES = {"deepfm": deepfm, "dlrm": dlrm}


def train_flops_per_example(cfg: dict) -> float:
    return FAMILIES[cfg["family"]](cfg)
