"""Per-pass embedding working set — the port of ``PassWorkingSet``.

The device never holds the whole table, only the keys seen in the
current pass:

- ``begin_pass(store, keys, device)`` dedups the pass's keys, assigns
  dense indices 1..K in sorted-key order (0 = the all-zero NULL_INDEX row
  that padding tokens point at), fetches their rows from the host store
  and lays them out on the device: one (n_rows, W) float32 tensor, or
  for ``storage="int8" | "int16"`` a two-plane ``quant.QuantTable``.
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

Transfers (``upload_rows`` H2D, ``fetch_rows`` D2H) carry logical
columns only: the pad columns of ``device_width`` are added and dropped
on the device. A quantized table crosses as its planes; under
``flags.transfer_compress_embedx`` an f32 table's embedx columns cross
as bfloat16 (``_put_compressed`` / ``_get_compressed``; counters, w and
optimizer state stay f32), converted on the host with ``torch.bfloat16``
(round to nearest even, as the reference's ``ml_dtypes`` cast). The
byte counts returned are those of the arrays that crossed, which equal
``transfer_bytes``.

``PushOperandStager`` holds the deferred sparse push's operands
(``flags.push_overlap``, JAX ``working_set.py:231``) between a step and
its apply.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.device import resolve_device
from paddlebox_tpu_torch.embedding import quant
from paddlebox_tpu_torch.embedding.config import EmbeddingConfig
from paddlebox_tpu_torch.embedding.store import HostEmbeddingStore
from paddlebox_tpu_torch.native.key_index import KeyIndex, sorted_unique


def device_width(cfg: EmbeddingConfig) -> int:
    """Physical column count of the f32 device table
    (flags.table_pad_width): the logical row width unless padding is
    asked for; pad columns are zeros that pass through every update and
    never reach the host. Quantized tables keep their plane layout."""
    rw = cfg.row_width
    pad = flags.table_pad_width
    if not pad or cfg.storage != "f32":
        return rw
    if pad == "auto":
        return 64 if 14 <= rw < 64 else rw
    return max(rw, int(pad))


def embedx_compressed(cfg: EmbeddingConfig) -> bool:
    """Whether embedx crosses as bfloat16 (an f32 table with embedx
    columns under flags.transfer_compress_embedx)."""
    return bool(flags.transfer_compress_embedx and cfg.storage == "f32"
                and cfg.total_dim)


def transfer_bytes(cfg: EmbeddingConfig, n_rows: int) -> int:
    """Host<->device bytes for ``n_rows`` full rows under the storage and
    compression settings: quantized embedx crosses as int8/int16 beside
    the f32 fp plane; the bf16 transfer halves an f32 table's embedx."""
    n_rows = int(n_rows)
    if cfg.storage != "f32":
        qbytes = 1 if cfg.storage == "int8" else 2
        return n_rows * (4 * quant.fp_width(cfg) + qbytes * cfg.total_dim)
    if embedx_compressed(cfg):
        e = cfg.total_dim
        return n_rows * (4 * (cfg.row_width - e) + 2 * e)
    return n_rows * cfg.row_width * 4


def bucket_size(x: int) -> int:
    """Round up to quarter-power-of-two buckets (4 sizes per octave; at
    most ~25% waste). The feed manager sizes its staged H2D plane with it,
    as the reference does."""
    if x <= 16:
        return int(x)
    p = 1 << (int(x).bit_length() - 1)
    step = p >> 2
    return -(-int(x) // step) * step


def _put_compressed(host: np.ndarray, cfg: EmbeddingConfig, put
                    ) -> tuple[torch.Tensor, int]:
    """f32 rows → device rows with embedx through bfloat16: the embedx
    block is rounded to bf16 on the host and crosses as its 16-bit
    pattern (numpy has no bfloat16), the rest crosses f32, and the rows
    are put back together in f32 on the device."""
    e = cfg.embedx_cols
    rest = np.ascontiguousarray(
        np.concatenate([host[:, :e.start], host[:, e.stop:]], axis=1))
    emb = torch.from_numpy(np.ascontiguousarray(host[:, e])).to(
        torch.bfloat16).view(torch.int16).numpy()
    rest_d = put(rest)
    emb_d = put(emb).view(torch.bfloat16).to(torch.float32)
    table = torch.cat([rest_d[:, :e.start], emb_d, rest_d[:, e.start:]],
                      dim=1)
    return table, rest.nbytes + emb.nbytes


def _get_compressed(rows: torch.Tensor, cfg: EmbeddingConfig
                    ) -> tuple[np.ndarray, int]:
    """Device f32 rows (logical columns) → host f32 rows with embedx
    through bfloat16: rounded on the device, crossed as 16-bit patterns,
    widened on the host."""
    e = cfg.embedx_cols
    rest = torch.cat([rows[:, :e.start], rows[:, e.stop:]], dim=1).cpu()
    emb = rows[:, e].to(torch.bfloat16).view(torch.int16).cpu()
    out = np.empty((rows.shape[0], cfg.row_width), np.float32)
    out[:, :e.start] = rest[:, :e.start].numpy()
    out[:, e] = emb.view(torch.bfloat16).to(torch.float32).numpy()
    out[:, e.stop:] = rest[:, e.start:].numpy()
    return out, rest.numel() * 4 + emb.numel() * 2


def upload_rows(host: np.ndarray, cfg: EmbeddingConfig, put):
    """f32 host rows (n, row_width) → the device table under cfg.storage
    and flags.transfer_compress_embedx: an f32 tensor at logical width,
    or a QuantTable. ``put`` moves one numpy array to the device (the
    feed manager's copies it on its own stream). Returns (table, bytes
    that crossed)."""
    if cfg.storage != "f32":
        if flags.transfer_compress_embedx:
            raise ValueError(
                "transfer_compress_embedx is redundant with quantized "
                "storage: the embedx plane already crosses as "
                f"{cfg.storage}")
        fp, qx = quant.encode_rows_np(host, cfg)
        return quant.QuantTable(put(fp), put(qx)), fp.nbytes + qx.nbytes
    if embedx_compressed(cfg):
        return _put_compressed(host, cfg, put)
    host = np.ascontiguousarray(host, np.float32)
    return put(host), host.nbytes


def fetch_rows(table, row_idx: np.ndarray,
               cfg: EmbeddingConfig) -> tuple[np.ndarray, int]:
    """Gather ``row_idx`` rows on the table's device, then move only
    those rows (their logical columns; both planes of a quantized table,
    decoded on the host; embedx as bfloat16 under the transfer
    compression) to the host. Returns (rows float32 (k, row_width),
    bytes moved device -> host)."""
    k = len(row_idx)
    if k == 0:
        return np.zeros((0, cfg.row_width), np.float32), 0
    planes = [table.fp, table.qx] if quant.is_quant(table) else [table]
    sel = torch.from_numpy(np.asarray(row_idx, np.int64)).to(
        planes[0].device)
    if quant.is_quant(table):
        fp, qx = (p.index_select(0, sel).cpu().numpy() for p in planes)
        return quant.decode_rows_np(fp, qx, cfg), fp.nbytes + qx.nbytes
    rows = table.index_select(0, sel)[:, :cfg.row_width]
    if embedx_compressed(cfg):
        return _get_compressed(rows, cfg)
    rows = rows.cpu().numpy()
    return rows, rows.nbytes


class PushOperandStager:
    """Double-buffered staging for the deferred sparse push
    (``flags.push_overlap``).

    Two slots rotate: the pending slot holds step N's push operands (its
    staged batch tensors and the step's premerged or per-token grads)
    until the trainer launches the apply; the retired slot keeps step
    N-1's referenced for one more rotation, while its apply may still be
    queued on the card. The pending slot is also the staleness bound: a
    second ``put`` before the pending apply was taken would let the
    table lag more than one step, and raises instead of queueing."""

    __slots__ = ("_pending", "_retired")

    def __init__(self):
        self._pending = None
        self._retired = None

    def put(self, item) -> None:
        if self._pending is not None:
            raise RuntimeError(
                "deferred push staleness bound exceeded: a second step's "
                "operands were queued while one apply is still pending — "
                "launch the pending apply first (one-step bound)")
        self._pending = item

    def take(self):
        """Pop the pending operands (None if none); they move to the
        retired slot for one more rotation."""
        item, self._pending = self._pending, None
        if item is not None:
            self._retired = item
        return item

    def pending(self) -> int:
        return int(self._pending is not None)

    def live(self) -> int:
        """Slots holding operands (<= 2 by construction)."""
        return (int(self._pending is not None)
                + int(self._retired is not None))

    def clear(self) -> None:
        self._pending = None
        self._retired = None


class PassWorkingSet:
    def __init__(self, cfg: EmbeddingConfig, sorted_keys: np.ndarray,
                 table: torch.Tensor):
        self.cfg = cfg
        self.sorted_keys = sorted_keys      # uint64 (K,), ascending
        self.table = table        # (n_rows, W) float32, or a QuantTable
        self._tindex = KeyIndex(len(sorted_keys) or 1)
        self._tindex.rebuild(sorted_keys)
        # rows any batch referenced: end_pass ships only these (push never
        # modifies a row that no batch indexed)
        self.touched = np.zeros(self.padded_rows, dtype=bool)
        # bytes the build moved host -> device (begin_pass sets it)
        self.h2d_bytes = 0

    @property
    def num_keys(self) -> int:
        return len(self.sorted_keys)

    @property
    def padded_rows(self) -> int:
        return quant.table_rows(self.table)

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
        t0 = time.perf_counter()
        keys = sorted_unique(np.asarray(keys).astype(np.uint64))
        if flags.spill_prefetch:
            # readahead of the disk-tier rows about to fault in (spill
            # stores): the kernel pages them in while the fetch below runs
            prefetch = getattr(store, "prefetch_rows", None)
            if prefetch is not None:
                prefetch(keys)
        rows = (store.peek_rows(keys) if test_mode
                else store.lookup_or_init(keys))
        n_rows = max(min_rows, len(keys) + 1)      # +1: the null row
        host = np.zeros((n_rows, cfg.row_width), dtype=np.float32)
        host[1:1 + len(keys)] = rows
        t1 = time.perf_counter()
        table, nbytes = upload_rows(
            host, cfg, lambda a: torch.from_numpy(a).to(dev))
        W = device_width(cfg)
        if W > cfg.row_width:
            # pad columns are added on the device: H2D carries none
            table = torch.nn.functional.pad(table, (0, W - cfg.row_width))
        if timing_out is not None:
            # the copy is done when the clock stops, so the h2d share
            # carries the transfer and not its dispatch (the stream it
            # ran on only: a staged build must not wait for training)
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
            t2 = time.perf_counter()
            timing_out["build"] = timing_out.get("build", 0.0) + (t1 - t0)
            timing_out["h2d"] = timing_out.get("h2d", 0.0) + (t2 - t1)
        ws = cls(cfg, keys, table)
        ws.h2d_bytes = nbytes
        return ws

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
