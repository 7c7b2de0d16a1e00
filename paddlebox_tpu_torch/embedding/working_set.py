"""Per-pass embedding working set — the port of ``PassWorkingSet``.

The device never holds the whole table, only the keys seen in the
current pass:

- ``begin_pass(store, keys, device)`` dedups the pass's keys, assigns
  dense indices 1..K in sorted-key order (0 = the all-zero NULL_INDEX row
  that padding tokens point at), fetches their rows from the host store
  and lays them out as one (n_rows, W) float32 tensor on the device.
  ``test_mode=True`` (eval, JAX ``working_set.py:331-357``) reads with
  ``peek_rows``, so an eval pass never grows or dirties the store.
- ``translate(ids, mask)`` maps uint64 feature signs to int32 working-set
  indices on the host (one KeyIndex batch probe), so the device only ever
  sees dense int32 indices; it also records which rows a batch touched.
- ``end_pass(store)`` gathers the touched rows on the device and writes
  them back to the host store: the eager write-back, kept for stores
  that forbid resident reuse (``supports_resident_reuse``). The trainer's
  default path is ``FeedPassManager`` (``feed_pass.py``), which keeps the
  table resident across passes and writes back lazily through
  ``fetch_rows``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.device import resolve_device
from paddlebox_tpu_torch.embedding.config import EmbeddingConfig
from paddlebox_tpu_torch.embedding.store import HostEmbeddingStore
from paddlebox_tpu_torch.native.key_index import KeyIndex, sorted_unique


def device_width(cfg: EmbeddingConfig) -> int:
    """Physical column count of the f32 device table
    (flags.table_pad_width): the logical row width unless padding is
    asked for; pad columns are zeros that pass through every update and
    never reach the host."""
    rw = cfg.row_width
    pad = flags.table_pad_width
    if not pad:
        return rw
    if pad == "auto":
        return 64 if 14 <= rw < 64 else rw
    return max(rw, int(pad))


def transfer_bytes(cfg: EmbeddingConfig, n_rows: int) -> int:
    """Host<->device bytes for ``n_rows`` full rows (f32 storage only:
    quantized planes and the bf16 transfer compression are not ported)."""
    if cfg.storage != "f32":
        raise NotImplementedError(
            f"storage={cfg.storage!r}: quantized transfers are not ported "
            f"yet (ROADMAP, queue 1 item 9)")
    return int(n_rows) * cfg.row_width * 4


def bucket_size(x: int) -> int:
    """Round up to quarter-power-of-two buckets (4 sizes per octave; at
    most ~25% waste). The feed manager sizes its staged H2D plane with it,
    as the reference does."""
    if x <= 16:
        return int(x)
    p = 1 << (int(x).bit_length() - 1)
    step = p >> 2
    return -(-int(x) // step) * step


def fetch_rows(table: torch.Tensor, row_idx: np.ndarray,
               cfg: EmbeddingConfig) -> tuple[np.ndarray, int]:
    """Gather ``row_idx`` rows on the table's device, then move only
    those rows (their logical columns) to the host. Returns (rows
    float32 (k, row_width), bytes moved device -> host)."""
    k = len(row_idx)
    if k == 0:
        return np.zeros((0, cfg.row_width), np.float32), 0
    sel = torch.from_numpy(np.asarray(row_idx, np.int64)).to(table.device)
    rows = table.index_select(0, sel)[:, :cfg.row_width].cpu().numpy()
    return rows, rows.nbytes


class PassWorkingSet:
    def __init__(self, cfg: EmbeddingConfig, sorted_keys: np.ndarray,
                 table: torch.Tensor):
        self.cfg = cfg
        self.sorted_keys = sorted_keys      # uint64 (K,), ascending
        self.table = table                  # (n_rows, W) float32
        self._tindex = KeyIndex(len(sorted_keys) or 1)
        self._tindex.rebuild(sorted_keys)
        # rows any batch referenced: end_pass ships only these (push never
        # modifies a row that no batch indexed)
        self.touched = np.zeros(self.padded_rows, dtype=bool)

    @property
    def num_keys(self) -> int:
        return len(self.sorted_keys)

    @property
    def padded_rows(self) -> int:
        return int(self.table.shape[0])

    @classmethod
    def begin_pass(cls, store: HostEmbeddingStore, keys: np.ndarray,
                   device: str | torch.device | None = None,
                   min_rows: int = 8,
                   test_mode: bool = False,
                   timing_out: dict | None = None) -> "PassWorkingSet":
        """Build the pass working set on ``device`` (the card unless
        ``device="cpu"``), inserting unseen keys into the store — or, with
        ``test_mode``, reading them without inserting (unseen keys get
        their deterministic init row). ``timing_out`` (updated in place)
        receives the boundary split: ``build`` = key dedup + store fetch
        + table assembly seconds, ``h2d`` = the copy to the device, waited
        for."""
        dev = resolve_device(device)
        cfg = store.cfg
        if cfg.storage != "f32":
            raise NotImplementedError(
                f"storage={cfg.storage!r}: quantized device tables are not "
                f"ported yet (ROADMAP, storage variants)")
        t0 = time.perf_counter()
        keys = sorted_unique(np.asarray(keys).astype(np.uint64))
        rows = (store.peek_rows(keys) if test_mode
                else store.lookup_or_init(keys))
        n_rows = max(min_rows, len(keys) + 1)      # +1: the null row
        host = np.zeros((n_rows, device_width(cfg)), dtype=np.float32)
        host[1:1 + len(keys), :cfg.row_width] = rows
        t1 = time.perf_counter()
        table = torch.from_numpy(host).to(dev)
        if timing_out is not None:
            # the copy is done when the clock stops, so the h2d share
            # carries the transfer and not its dispatch (the stream it
            # ran on only: a staged build must not wait for training)
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
            t2 = time.perf_counter()
            timing_out["build"] = timing_out.get("build", 0.0) + (t1 - t0)
            timing_out["h2d"] = timing_out.get("h2d", 0.0) + (t2 - t1)
        return cls(cfg, keys, table)

    def translate(self, ids: np.ndarray, mask: np.ndarray | None = None
                  ) -> np.ndarray:
        """uint64 feature signs → dense int32 working-set indices.

        Keys not in this pass and masked positions map to the null
        index 0."""
        ids_arr = np.asarray(ids)
        if len(self.sorted_keys) == 0:
            return np.zeros(ids_arr.shape, dtype=np.int32)
        flat = ids_arr.astype(np.uint64).reshape(-1)
        if self._tindex.is_native:
            pos = self._tindex.lookup(flat)      # -1 = not in this pass
        else:
            pos = np.searchsorted(self.sorted_keys, flat)
            pos[pos >= len(self.sorted_keys)] = 0
            pos = np.where(self.sorted_keys[pos] == flat, pos, -1)
        idx = (pos + 1).astype(np.int32).reshape(ids_arr.shape)
        if mask is not None:
            idx = np.where(mask, idx, 0).astype(np.int32)
        self.touched[idx.reshape(-1)] = True
        self.touched[0] = False          # the null row is never persisted
        return idx

    def end_pass(self, store: HostEmbeddingStore) -> int:
        """Write the touched rows back to the host store; returns the
        bytes moved device → host."""
        dirty = np.flatnonzero(self.touched[1:1 + self.num_keys]) + 1
        if len(dirty) == 0:
            return 0
        rows, nbytes = fetch_rows(self.table, dirty, self.cfg)
        store.write_back(self.sorted_keys[dirty - 1], rows)
        return nbytes
