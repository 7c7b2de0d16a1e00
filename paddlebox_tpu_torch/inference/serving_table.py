"""Read-optimized serving embedding table — the port of
``paddlebox_tpu/inference/serving_table.py`` (``ServingTable`` :23-171).

The serving side's sparse plane (the reference's "xbox" key → pull-value
map, updated online by deltas): a sorted uint64 key array and a dense
(N, pull_width) float32 value matrix on the host, so a batched lookup is
one ``np.searchsorted`` and a gather. Unknown keys pull zeros, then the
presence gate (``GateSpec``) masks below-threshold planes as training
pulls do, then the mask zeroes padded tokens. ``serving.npz`` is written
uncompressed (stored zip members: plain .npy bytes that non-Python
clients memory-map) with the reference's member names and
``serving_meta.json``, so either package loads the other's table.
"""

from __future__ import annotations

import json
import os

import numpy as np

from paddlebox_tpu_torch.embedding.gating import GateSpec, gate_pull_np


class ServingTable:
    def __init__(self, keys: np.ndarray, vals: np.ndarray,
                 gate: GateSpec | None = None):
        keys = np.asarray(keys, dtype=np.uint64)
        vals = np.asarray(vals, dtype=np.float32)
        if keys.ndim != 1 or vals.ndim != 2 or len(keys) != len(vals):
            raise ValueError("keys (N,) and vals (N, P) must align")
        order = np.argsort(keys, kind="stable")
        self.keys = keys[order]
        self.vals = vals[order]
        self.gate = gate
        if len(self.keys) and (self.keys[1:] == self.keys[:-1]).any():
            dup = np.unique(self.keys[1:][self.keys[1:] == self.keys[:-1]])
            shown = ", ".join(str(int(k)) for k in dup[:8])
            more = f", … +{len(dup) - 8} more" if len(dup) > 8 else ""
            raise ValueError(
                f"duplicate keys in serving table: {len(dup)} key(s) "
                f"appear more than once ({shown}{more})")

    @property
    def pull_width(self) -> int:
        return self.vals.shape[1]

    def __len__(self) -> int:
        return len(self.keys)

    @classmethod
    def from_store(cls, store) -> "ServingTable":
        """Freeze a HostEmbeddingStore's pull plane for serving."""
        keys, vals = store.export_serving()
        return cls(keys, vals, gate=GateSpec.from_cfg(store.cfg))

    def copy(self) -> "ServingTable":
        """Deep copy for copy-on-write delta application: the hot-swap
        server merges a delta into a copy while the live table keeps
        serving in-flight requests."""
        t = object.__new__(ServingTable)   # keys already sorted + unique
        t.keys = self.keys.copy()
        t.vals = self.vals.copy()
        t.gate = self.gate
        return t

    def _probe(self, keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Sorted-array probe: → (clamped positions, hit mask)."""
        pos = np.searchsorted(self.keys, keys)
        pos_c = np.minimum(pos, max(len(self.keys) - 1, 0))
        hit = (self.keys[pos_c] == keys) if len(self.keys) else \
            np.zeros(len(keys), bool)
        return pos_c, hit

    def lookup(self, ids: np.ndarray, mask: np.ndarray | None = None
               ) -> np.ndarray:
        """ids uint64 (...,) → pull values (..., P) float32; misses and
        masked tokens pull zeros."""
        ids = np.asarray(ids, dtype=np.uint64)
        flat = ids.reshape(-1)
        pos_c, hit = self._probe(flat)
        if len(self.keys):
            out = np.where(hit[:, None], self.vals[pos_c], 0.0)
        else:
            out = np.zeros((len(flat), self.pull_width), np.float32)
        out = out.reshape(*ids.shape, self.pull_width)
        if self.gate is not None:
            out = gate_pull_np(out, self.gate)
        if mask is not None:
            out = out * np.asarray(mask, np.float32)[..., None]
        return out.astype(np.float32)

    def _merge(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Upsert rows (delta application; within a delta the last
        occurrence of a key wins)."""
        keys = np.asarray(keys, dtype=np.uint64)
        vals = np.asarray(vals, dtype=np.float32)[:, :self.pull_width]
        _, last = np.unique(keys[::-1], return_index=True)
        keep = len(keys) - 1 - last
        keys, vals = keys[keep], vals[keep]
        pos_c, exists = self._probe(keys)
        if exists.any():
            self.vals[pos_c[exists]] = vals[exists]
        if (~exists).any():
            all_keys = np.concatenate([self.keys, keys[~exists]])
            all_vals = np.concatenate([self.vals, vals[~exists]])
            order = np.argsort(all_keys, kind="stable")
            self.keys, self.vals = all_keys[order], all_vals[order]

    def _drop(self, keys: np.ndarray) -> None:
        keys = np.asarray(keys, dtype=np.uint64)
        if not len(keys) or not len(self.keys):
            return
        pos_c, hit = self._probe(keys)
        hits = pos_c[hit]
        if len(hits):
            keep = np.ones(len(self.keys), bool)
            keep[hits] = False
            self.keys, self.vals = self.keys[keep], self.vals[keep]

    def apply_delta_file(self, fname: str) -> None:
        """Apply one delta-*.npz of HostEmbeddingStore.save_delta (rows at
        full row width: the pull columns are kept) or a serving.npz."""
        with np.load(fname) as z:
            self._merge(z["keys"], z["rows"])
            if "removed" in z and len(z["removed"]):
                self._drop(z["removed"])

    def apply_delta_dir(self, path: str) -> int:
        """Apply every delta-*.npz under ``path`` in sequence order."""
        names = sorted(f for f in os.listdir(path) if f.startswith("delta-"))
        for f in names:
            self.apply_delta_file(os.path.join(path, f))
        return len(names)

    def save(self, path: str) -> str:
        os.makedirs(path, exist_ok=True)
        fname = os.path.join(path, "serving.npz")
        # uncompressed on purpose: stored members at fixed offsets, which
        # any-language clients memory-map
        np.savez(fname, keys=self.keys, rows=self.vals)
        meta = {"num_keys": int(len(self.keys)),
                "pull_width": int(self.pull_width)}
        if self.gate is not None:
            meta["gate"] = list(self.gate)
        with open(os.path.join(path, "serving_meta.json"), "w") as f:
            json.dump(meta, f)
        return fname

    @classmethod
    def load(cls, path: str) -> "ServingTable":
        gate = None
        meta_path = os.path.join(path, "serving_meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                g = json.load(f).get("gate")
            if g is not None:
                gate = GateSpec(int(g[0]), int(g[1]), float(g[2]),
                                float(g[3]))
        with np.load(os.path.join(path, "serving.npz")) as z:
            return cls(z["keys"], z["rows"], gate=gate)
