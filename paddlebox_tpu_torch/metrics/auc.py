"""Bucketed AUC / bucket-error / MAE / RMSE — the port of
``metrics/auc.py``.

Predictions are histogrammed into ``n_buckets`` buckets split by label
into positive/negative tables. The histogram and the error sums are
float32 tensors on the device, updated with ``index_add_``; every
``drain_every`` batches they drain into a float64 host sink (a float32
bucket stops counting past 2^24), and ``auc_compute`` runs the float64
sweep on the host, unchanged from the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_BUCKETS = 1 << 20

_KEYS = ("pos", "neg", "abserr", "sqrerr", "pred")


def new_state(n_buckets: int = DEFAULT_BUCKETS,
              device="cpu") -> dict[str, torch.Tensor]:
    return {
        "pos": torch.zeros(n_buckets, dtype=torch.float32, device=device),
        "neg": torch.zeros(n_buckets, dtype=torch.float32, device=device),
        "abserr": torch.zeros((), dtype=torch.float32, device=device),
        "sqrerr": torch.zeros((), dtype=torch.float32, device=device),
        "pred": torch.zeros((), dtype=torch.float32, device=device),
    }


def auc_update(state: dict[str, torch.Tensor], preds: torch.Tensor,
               labels: torch.Tensor, mask: torch.Tensor | None = None,
               sample_scale: torch.Tensor | None = None) -> None:
    """Accumulate one batch into ``state`` in place (no host sync).

    ``mask``: bool per example, the mask / cmatch-rank metric filter;
    ``sample_scale``: a per-example weight (the sample-scale metric)."""
    n_buckets = state["pos"].shape[0]
    p = preds.reshape(-1).to(torch.float32)
    y = labels.reshape(-1).to(torch.float32)
    bucket = torch.clamp((p * n_buckets).to(torch.int32), 0,
                         n_buckets - 1).long()
    if mask is None and sample_scale is None:
        state["pos"].index_add_(0, bucket, y)
        state["neg"].index_add_(0, bucket, 1.0 - y)
        state["abserr"] += torch.sum(torch.abs(p - y))
        state["sqrerr"] += torch.sum((p - y) ** 2)
        state["pred"] += torch.sum(p)
        return
    w = torch.ones_like(p)
    if sample_scale is not None:
        w = w * sample_scale.reshape(-1).to(torch.float32)
    if mask is not None:
        w = w * mask.reshape(-1).to(torch.float32)
    state["pos"].index_add_(0, bucket, y * w)
    state["neg"].index_add_(0, bucket, (1.0 - y) * w)
    state["abserr"] += torch.sum(w * torch.abs(p - y))
    state["sqrerr"] += torch.sum(w * (p - y) ** 2)
    state["pred"] += torch.sum(w * p)


class AucAccumulator:
    """Device float32 state updated per batch, drained into a host
    float64 sink every ``drain_every`` batches."""

    def __init__(self, n_buckets: int = DEFAULT_BUCKETS,
                 drain_every: int = 256, device="cpu"):
        self.n_buckets = n_buckets
        self.drain_every = drain_every
        self.device = torch.device(device)
        self.host = {k: np.zeros(n_buckets if k in ("pos", "neg") else (),
                                 dtype=np.float64) for k in _KEYS}
        self.dev = new_state(n_buckets, self.device)
        self._updates = 0

    def update(self, preds: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor | None = None) -> None:
        auc_update(self.dev, preds, labels, mask=mask)
        self._updates += 1
        if self._updates >= self.drain_every:
            self.drain()

    def drain(self) -> None:
        for k, v in self.dev.items():
            self.host[k] = self.host[k] + v.cpu().numpy().astype(np.float64)
            v.zero_()
        self._updates = 0

    def compute(self, **kw) -> dict[str, float]:
        self.drain()
        return auc_compute(self.host, **kw)


def auc_compute(state: dict,
                max_span: float = 0.01,
                relative_error_bound: float = 0.05) -> dict[str, float]:
    """Host-side sweep (float64), mirroring compute() +
    calculate_bucket_error() exactly (box_wrapper.cc:321-370, 542-574)."""
    pos = np.asarray(state["pos"], dtype=np.float64)
    neg = np.asarray(state["neg"], dtype=np.float64)
    n = len(pos)
    # trapezoid sweep from the top bucket down (cc:339-346)
    tp_cum = np.cumsum(pos[::-1])
    fp_cum = np.cumsum(neg[::-1])
    tp_prev = np.concatenate([[0.0], tp_cum[:-1]])
    fp_prev = np.concatenate([[0.0], fp_cum[:-1]])
    area = np.sum((fp_cum - fp_prev) * (tp_prev + tp_cum) / 2.0)
    fp, tp = float(fp_cum[-1]), float(tp_cum[-1])
    if fp < 1e-3 or tp < 1e-3:
        auc = -0.5  # all nonclick or all click (cc:348-350)
    else:
        auc = float(area / (fp * tp))
    total = fp + tp
    abserr = float(np.asarray(state["abserr"], dtype=np.float64))
    sqrerr = float(np.asarray(state["sqrerr"], dtype=np.float64))
    pred = float(np.asarray(state["pred"], dtype=np.float64))
    out: dict[str, float] = {
        "auc": auc,
        "mae": abserr / total if total else 0.0,
        "rmse": float(np.sqrt(sqrerr / total)) if total else 0.0,
        "predicted_ctr": pred / total if total else 0.0,
        "actual_ctr": tp / total if total else 0.0,
        "size": total,
    }
    out["bucket_error"] = _bucket_error(pos, neg, n, max_span,
                                        relative_error_bound)
    return out


def _bucket_error(pos: np.ndarray, neg: np.ndarray, n: int,
                  max_span: float, rel_bound: float) -> float:
    """Faithful port of the adaptive-span calibration sweep (cc:542-574).

    The reference iterates ALL buckets; empty buckets contribute nothing to
    the sums but can still become the reset anchor (``last_ctr``) when the
    span overflows inside an empty run, which changes where later resets
    land. Iterating 1M buckets per call in Python is too slow, so this walks
    only nonzero buckets and advances the anchor through each empty run
    arithmetically — bit-for-bit the same anchor the full loop would reach
    (each anchor hop advances > max_span, so total hops <= 1/max_span + nnz).
    """
    last_ctr = -1.0
    impression_sum = 0.0
    ctr_sum = 0.0
    click_sum = 0.0
    error_sum = 0.0
    error_count = 0.0
    nz = np.nonzero((pos + neg) > 0)[0]
    prev = -1  # index of the previously processed (nonzero) bucket
    for i in nz:
        # advance the anchor through empty buckets (prev, i) exactly as the
        # full loop would: reset at each bucket whose ctr exceeds the
        # current anchor by more than max_span
        j = prev + 1
        while j < i:
            cj = float(j) / n
            if abs(cj - last_ctr) > max_span:
                last_ctr = cj
                impression_sum = ctr_sum = click_sum = 0.0
                # next possible reset is the first bucket > n*(last+span)
                nxt = int(np.floor(n * (last_ctr + max_span))) + 1
                j = max(j + 1, nxt)
            else:
                nxt = int(np.floor(n * (last_ctr + max_span))) + 1
                j = max(j + 1, nxt)
        click = pos[i]
        show = pos[i] + neg[i]
        ctr = float(i) / n
        if abs(ctr - last_ctr) > max_span:
            last_ctr = ctr
            impression_sum = ctr_sum = click_sum = 0.0
        impression_sum += show
        ctr_sum += ctr * show
        click_sum += click
        adjust_ctr = ctr_sum / impression_sum
        if adjust_ctr <= 0 or adjust_ctr >= 1:
            prev = i
            continue
        relative_error = np.sqrt((1 - adjust_ctr) /
                                 (adjust_ctr * impression_sum))
        if relative_error < rel_bound:
            actual_ctr = click_sum / impression_sum
            error_sum += abs(actual_ctr / adjust_ctr - 1) * impression_sum
            error_count += impression_sum
            last_ctr = -1.0
        prev = i
    return error_sum / error_count if error_count > 0 else 0.0
