"""Summary-statistics normalisation — the port of ``ops/cross_norm.py``:
``data_norm`` and ``cross_norm_hadamard``.

data_norm: per-column running summary (count, sum, square_sum);
``mean = sum / count``, ``scale = sqrt(count / square_sum)``,
``out = (x - mean) * scale``.

cross_norm_hadamard: the input is n field pairs of embed_dim vectors
(a_i, b_i) concatenated; per pair the op emits [a, b, a⊙b, <a,b>]
(3*embed_dim+1 columns), normalised with the same summary.

Both are pure functions over an explicit ``summary`` (3, C): row 0 =
count, row 1 = sum, row 2 = square_sum, owned by the caller and updated
with ``summary_update``.
"""

from __future__ import annotations

import torch


def init_summary(num_cols: int, eps: float = 1e-4,
                 device: str | torch.device | None = None) -> torch.Tensor:
    """count=eps, sum=0, square_sum=eps: scale starts at 1, mean at 0."""
    s = torch.zeros((3, num_cols), dtype=torch.float32, device=device)
    s[0] = eps
    s[2] = eps
    return s


def _mean_scale(summary: torch.Tensor):
    return summary[1] / summary[0], torch.sqrt(summary[0] / summary[2])


def data_norm(x: torch.Tensor, summary: torch.Tensor) -> torch.Tensor:
    """x (B, C) normalised by the running summary (3, C)."""
    mean, scale = _mean_scale(summary)
    return (x - mean) * scale


def summary_update(summary: torch.Tensor, x: torch.Tensor,
                   decay: float = 0.9999999,
                   axis_name=None) -> torch.Tensor:
    """Accumulate a batch into the summary with exponential decay.

    ``axis_name`` (the JAX package's psum of the batch contribution
    across data-parallel replicas) needs the multi-GPU port."""
    if axis_name is not None:
        raise NotImplementedError(
            "summary_update(axis_name=...) sums across replicas, which "
            "needs the multi-GPU port (ROADMAP queue 1)")
    b = x.shape[0]
    batch = torch.stack([
        torch.full((x.shape[-1],), float(b), dtype=x.dtype,
                   device=x.device),
        x.sum(dim=0),
        (x * x).sum(dim=0),
    ])
    return summary * decay + batch


def cross_norm_raw(x: torch.Tensor, fields_num: int, embed_dim: int
                   ) -> torch.Tensor:
    """The un-normalised [a, b, a⊙b, <a,b>] features, (B, fields_num *
    (3*embed_dim+1)) (what summary_update accumulates)."""
    B = x.shape[0]
    xr = x.reshape(B, fields_num, 2, embed_dim)
    a, b = xr[:, :, 0], xr[:, :, 1]
    had = a * b
    dot = torch.sum(had, dim=-1, keepdim=True)
    return torch.cat([a, b, had, dot], dim=-1).reshape(B, -1)


def cross_norm_hadamard(x: torch.Tensor, summary: torch.Tensor,
                        fields_num: int, embed_dim: int) -> torch.Tensor:
    """x (B, 2*embed_dim*fields_num) → (B, fields_num*(3*embed_dim+1)):
    per field pair [a, b, a⊙b, <a,b>], summary-normalised."""
    return data_norm(cross_norm_raw(x, fields_num, embed_dim), summary)
