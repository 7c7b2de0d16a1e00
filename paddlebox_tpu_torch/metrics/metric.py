"""Metric registry — the port of ``paddlebox_tpu/metrics/metric.py``
(``MetricRegistry`` :62, ``parse_cmatch_rank`` :30).

Metrics are registered by name with a method selector — ``plain`` AUC,
``cmatch_rank`` (only examples whose (cmatch, rank) pair is listed),
``mask`` (only examples whose mask var equals 1) and ``sample_scale``
(a per-example weight) — and an optional phase: a metric registered for
a phase only accumulates while that phase is current (the join/update
flip).

Each metric's state is the reference's AUC state: ``pos`` and ``neg`` of
shape (n_buckets,) and the scalars ``abserr``, ``sqrerr`` and ``pred``,
float32. It accumulates where the batches are (on the card in training:
it moves to the first batch's device) and ``get_state`` / ``set_state``
carry it to and from the pass snapshot's ``metrics.npz``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import numpy as np
import torch

from paddlebox_tpu_torch.metrics import auc as auc_lib


def parse_cmatch_rank(spec: str) -> list[tuple[int, int]]:
    """"223:0,224:1" → [(223,0),(224,1)]; bare "223,224" → rank wildcard -1."""
    out: list[tuple[int, int]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            c, r = part.split(":")
            out.append((int(c), int(r)))
        else:
            out.append((int(part), -1))
    return out


@dataclasses.dataclass
class _Metric:
    name: str
    method: str                       # plain | cmatch_rank | mask | sample_scale
    label_var: str = "label"
    pred_var: str = "pred"
    cmatch_rank: list[tuple[int, int]] = dataclasses.field(default_factory=list)
    mask_var: str = ""
    scale_var: str = ""
    n_buckets: int = auc_lib.DEFAULT_BUCKETS
    state: Any = None

    def __post_init__(self):
        if self.state is None:
            self.state = auc_lib.new_state(self.n_buckets)


def _on(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           device=device)


class MetricRegistry:
    """init_metric / add_data / get_metric_msg / flip_phase surface."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._phases: dict[str, int] = {}
        self._starved_warned: set[str] = set()
        self.phase = 1  # the reference starts in the join phase

    def init_metric(self, name: str, method: str = "plain",
                    label_var: str = "label", pred_var: str = "pred",
                    cmatch_rank_spec: str = "", mask_var: str = "",
                    scale_var: str = "", phase: int = -1,
                    n_buckets: int = auc_lib.DEFAULT_BUCKETS) -> None:
        self._metrics[name] = _Metric(
            name=name, method=method, label_var=label_var, pred_var=pred_var,
            cmatch_rank=parse_cmatch_rank(cmatch_rank_spec),
            mask_var=mask_var, scale_var=scale_var, n_buckets=n_buckets)
        self._phases[name] = phase

    def flip_phase(self) -> None:
        self.phase = 1 - self.phase

    def names(self) -> list[str]:
        return list(self._metrics)

    def add_data(self, name: str, preds, labels, cmatch=None, rank=None,
                 mask=None, sample_scale=None) -> None:
        """Accumulate one batch into metric ``name`` (no host sync for a
        plain metric)."""
        m = self._metrics[name]
        ph = self._phases[name]
        if ph >= 0 and ph != self.phase:
            return
        preds = preds if torch.is_tensor(preds) else torch.as_tensor(
            np.asarray(preds))
        dev = preds.device
        if m.state["pos"].device != dev:
            m.state = {k: v.to(dev) for k, v in m.state.items()}
        eff_mask = None
        if m.method == "cmatch_rank":
            if cmatch is None:
                raise ValueError(f"metric {name} needs cmatch input")
            cm = np.asarray(cmatch).reshape(-1)
            rk = (np.asarray(rank).reshape(-1) if rank is not None
                  else np.zeros_like(cm))
            sel = np.zeros(cm.shape, dtype=bool)
            for c, r in m.cmatch_rank:
                sel |= (cm == c) if r < 0 else ((cm == c) & (rk == r))
            eff_mask = _on(sel, dev)
        elif m.method == "mask":
            if mask is None:
                raise ValueError(f"metric {name} needs mask input")
            eff_mask = _on(mask, dev).reshape(-1) == 1
        scale = None
        if m.method == "sample_scale" or m.scale_var:
            if sample_scale is None:
                raise ValueError(f"metric {name} needs sample_scale input")
            scale = _on(sample_scale, dev)
        auc_lib.auc_update(m.state, preds, _on(labels, dev), mask=eff_mask,
                           sample_scale=scale)

    def add_batch(self, preds, labels, cmatch=None, rank=None, mask=None,
                  sample_scale=None) -> None:
        """Feed one batch to every phase-active metric whose inputs are
        available; warn once per metric starved of a required input
        (instead of silently reporting size=0)."""
        for name, m in self._metrics.items():
            ph = self._phases[name]
            if ph >= 0 and ph != self.phase:
                continue
            needs = {"cmatch_rank": cmatch, "mask": mask,
                     "sample_scale": sample_scale}.get(m.method, True)
            if m.scale_var and sample_scale is None:
                needs = None
            if needs is None:
                if name not in self._starved_warned:
                    self._starved_warned.add(name)
                    warnings.warn(
                        f"metric {name!r} ({m.method}) got no "
                        f"{m.method}/scale input this pass; it will not "
                        f"accumulate", stacklevel=2)
                continue
            self.add_data(name, preds, labels, cmatch=cmatch, rank=rank,
                          mask=mask, sample_scale=sample_scale)

    def set_state(self, name: str, state) -> None:
        """Install a state (numpy arrays or tensors, the reference's
        layout) on the device the metric's current state lives on."""
        m = self._metrics[name]
        dev = m.state["pos"].device
        m.state = {k: torch.as_tensor(np.asarray(state[k], np.float32)
                                      if not torch.is_tensor(state[k])
                                      else state[k],
                                      dtype=torch.float32, device=dev).clone()
                   for k in m.state}

    def get_state(self, name: str) -> dict[str, torch.Tensor]:
        return self._metrics[name].state

    def get_metric_msg(self, name: str) -> dict[str, float]:
        return auc_lib.auc_compute({k: v.cpu().numpy() for k, v in
                                    self._metrics[name].state.items()})

    def reset(self, name: str | None = None) -> None:
        targets = [name] if name else list(self._metrics)
        for t in targets:
            m = self._metrics[t]
            m.state = auc_lib.new_state(m.n_buckets, m.state["pos"].device)
