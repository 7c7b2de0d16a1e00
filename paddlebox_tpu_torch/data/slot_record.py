"""Columnar slot-record batches.

The reference stores each example as a malloc'd ``SlotRecord`` holding CSR-style
``SlotValues<uint64_t>`` + ``SlotValues<float>`` (values + per-slot offsets,
reference: paddle/fluid/framework/data_feed.h:778-862), pools them in a
``SlotObjPool`` and packs minibatches to GPU with ``MiniBatchGpuPack``
(data_feed.h:1372-1535, kernels in data_feed.cu).

TPU-native redesign: records are *columnar from the start* — one CSR block per
slot for a whole shard of examples (numpy host-side), so "packing a minibatch"
is pure vectorized slicing + padding, and the device-facing ``PackedBatch`` has
the static shapes XLA requires (ids ``(B, S, L)`` int32-indexed into the pass
working set or int64 raw keys, mask, floats, metadata columns).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np

from paddlebox_tpu_torch.data.schema import DataFeedSchema, SlotType
from paddlebox_tpu_torch.native.key_index import sorted_unique


@dataclasses.dataclass
class SlotRecordBatch:
    """A set of N examples, columnar CSR per slot (host side, ragged).

    sparse_values[s] : int64[nnz_s]   feature signs for sparse slot s
    sparse_offsets[s]: int64[N+1]     CSR offsets (example i owns
                                      values[offsets[i]:offsets[i+1]])
    float_values[f]  : float32[N * max_len_f]  fixed-width dense floats
    ins_id, search_id, rank, cmatch   metadata columns (reference
                                      data_feed.h:828-841)
    """

    schema: DataFeedSchema
    num: int
    sparse_values: list[np.ndarray]
    sparse_offsets: list[np.ndarray]
    float_values: list[np.ndarray]
    ins_id: np.ndarray          # uint64 hash of the instance id string
    search_id: np.ndarray       # uint64
    rank: np.ndarray            # int32
    cmatch: np.ndarray          # int32

    @classmethod
    def empty(cls, schema: DataFeedSchema) -> "SlotRecordBatch":
        ns = len(schema.sparse_slots)
        nf = len(schema.float_slots)
        return cls(
            schema=schema,
            num=0,
            sparse_values=[np.zeros(0, dtype=np.int64) for _ in range(ns)],
            sparse_offsets=[np.zeros(1, dtype=np.int64) for _ in range(ns)],
            float_values=[np.zeros(0, dtype=np.float32) for _ in range(nf)],
            ins_id=np.zeros(0, dtype=np.uint64),
            search_id=np.zeros(0, dtype=np.uint64),
            rank=np.zeros(0, dtype=np.int32),
            cmatch=np.zeros(0, dtype=np.int32),
        )

    # ---- combinators (the SlotObjPool merge path) ----

    @staticmethod
    def concat(batches: Sequence["SlotRecordBatch"]) -> "SlotRecordBatch":
        batches = [b for b in batches if b.num > 0]
        if not batches:
            raise ValueError("concat of empty batch list")
        first = batches[0]
        ns = len(first.sparse_values)
        nf = len(first.float_values)
        sparse_values, sparse_offsets = [], []
        for s in range(ns):
            sparse_values.append(np.concatenate([b.sparse_values[s] for b in batches]))
            offs = [first.sparse_offsets[s]]
            base = first.sparse_offsets[s][-1]
            for b in batches[1:]:
                offs.append(b.sparse_offsets[s][1:] + base)
                base += b.sparse_offsets[s][-1]
            sparse_offsets.append(np.concatenate(offs))
        return SlotRecordBatch(
            schema=first.schema,
            num=sum(b.num for b in batches),
            sparse_values=sparse_values,
            sparse_offsets=sparse_offsets,
            float_values=[np.concatenate([b.float_values[f] for b in batches])
                          for f in range(nf)],
            ins_id=np.concatenate([b.ins_id for b in batches]),
            search_id=np.concatenate([b.search_id for b in batches]),
            rank=np.concatenate([b.rank for b in batches]),
            cmatch=np.concatenate([b.cmatch for b in batches]),
        )

    def select(self, idx: np.ndarray) -> "SlotRecordBatch":
        """Row-subset (used by shuffle routing and per-device sharding)."""
        idx = np.asarray(idx, dtype=np.int64)
        sparse_values, sparse_offsets = [], []
        for vals, offs in zip(self.sparse_values, self.sparse_offsets):
            lens = offs[1:] - offs[:-1]
            sel_lens = lens[idx]
            new_offs = np.zeros(len(idx) + 1, dtype=np.int64)
            np.cumsum(sel_lens, out=new_offs[1:])
            # gather the ragged rows in one vectorized take
            src = np.repeat(offs[idx], sel_lens) + _ranges(sel_lens)
            sparse_values.append(vals[src].astype(np.int64, copy=False))
            sparse_offsets.append(new_offs)
        float_values = []
        for f, slot in enumerate(self.schema.float_slots):
            w = slot.max_len
            fv = self.float_values[f].reshape(self.num, w)[idx].reshape(-1)
            float_values.append(fv)
        return SlotRecordBatch(
            schema=self.schema, num=len(idx),
            sparse_values=sparse_values, sparse_offsets=sparse_offsets,
            float_values=float_values,
            ins_id=self.ins_id[idx], search_id=self.search_id[idx],
            rank=self.rank[idx], cmatch=self.cmatch[idx],
        )

    def shuffle(self, rng: np.random.Generator) -> "SlotRecordBatch":
        return self.select(rng.permutation(self.num))

    def unique_keys(self) -> np.ndarray:
        """All distinct feature signs in this batch — the FeedPass key
        extraction (reference MergeInsKeys data_set.cc:1786)."""
        if not self.sparse_values:
            return np.zeros(0, dtype=np.int64)
        return sorted_unique(np.concatenate(self.sparse_values))

    # ---- device packing (the MiniBatchGpuPack equivalent) ----

    def pack(self, start: int, end: int) -> "PackedBatch":
        """Pack examples [start, end) into fixed-shape arrays.

        Mirrors MiniBatchGpuPack::pack_instance + CopyForTensorKernel
        (reference data_feed.h:1379, data_feed.cu:35-206) but is a single
        vectorized numpy pass: per sparse slot, rows are truncated to the
        slot's max_len and padded with 0; mask records validity.
        """
        n = end - start
        schema = self.schema
        sslots = schema.sparse_slots
        ids_cols, mask_cols = [], []
        for s, slot in enumerate(sslots):
            offs = self.sparse_offsets[s]
            vals = self.sparse_values[s]
            lens = (offs[start + 1:end + 1] - offs[start:end])
            L = slot.max_len
            ids = np.zeros((n, L), dtype=np.int64)
            clip = np.minimum(lens, L)
            # vectorized ragged→padded: gather indices offs[i] + j for j < clip[i]
            row_idx = np.repeat(np.arange(n), clip)
            col_idx = _ranges(clip)
            src_idx = np.repeat(offs[start:end], clip) + col_idx
            ids[row_idx, col_idx] = vals[src_idx]
            mask = (col_idx_matrix(n, L) < clip[:, None])
            ids_cols.append(ids)
            mask_cols.append(mask)
        floats = []
        for f, slot in enumerate(schema.float_slots):
            w = slot.max_len
            floats.append(self.float_values[f].reshape(self.num, w)[start:end])
        # Flat (B, T) layout: slots with different max_len concatenate along
        # the token axis; static slot boundaries live in SparseLayout. One
        # device gather + one segment-sum covers all slots at once.
        return PackedBatch(
            schema=schema,
            num=n,
            ids=np.concatenate(ids_cols, axis=1) if ids_cols
                else np.zeros((n, 0), dtype=np.int64),
            mask=np.concatenate(mask_cols, axis=1) if mask_cols
                else np.zeros((n, 0), dtype=bool),
            floats=np.concatenate(floats, axis=1) if floats
                else np.zeros((n, 0), dtype=np.float32),
            rank=self.rank[start:end],
            cmatch=self.cmatch[start:end],
            ins_id=self.ins_id[start:end],
            search_id=self.search_id[start:end],
        )


def _ranges(lens: np.ndarray) -> np.ndarray:
    """[0..lens[0]), [0..lens[1]), ... concatenated."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.cumsum(lens) - lens
    return np.arange(total, dtype=np.int64) - np.repeat(starts, lens)


def col_idx_matrix(n: int, L: int) -> np.ndarray:
    return np.broadcast_to(np.arange(L, dtype=np.int64), (n, L))


@dataclasses.dataclass(frozen=True)
class SparseLayout:
    """Static geometry of the flat (B, T) sparse-token axis.

    T = sum of max_len over sparse slots. ``segment_ids[t]`` maps token
    column t to its slot index — precomputed once per schema so pooling is a
    single ``segment_sum`` on device.
    """

    num_slots: int
    total_len: int
    slot_starts: np.ndarray    # int32 (S,)   first column of each slot
    slot_lens: np.ndarray      # int32 (S,)   = max_len per slot
    segment_ids: np.ndarray    # int32 (T,)   token column -> slot index

    @staticmethod
    def from_schema(schema: DataFeedSchema) -> "SparseLayout":
        lens = np.asarray([s.max_len for s in schema.sparse_slots], dtype=np.int32)
        starts = np.zeros_like(lens)
        if len(lens):
            starts[1:] = np.cumsum(lens)[:-1]
        return SparseLayout(
            num_slots=len(lens),
            total_len=int(lens.sum()),
            slot_starts=starts,
            slot_lens=lens,
            segment_ids=np.repeat(np.arange(len(lens), dtype=np.int32), lens),
        )


@dataclasses.dataclass
class PackedBatch:
    """Fixed-shape, device-ready minibatch.

    ids   : int64 (B, T) — raw feature signs, all sparse slots concatenated
            along the token axis (T = Σ max_len; see SparseLayout); the pass
            working set translates these to dense int32 indices before jit.
    mask  : bool  (B, T)
    floats: float32 (B, F_total) — concatenated fixed-width float slots,
            including the label column (schema order).
    """

    schema: DataFeedSchema
    num: int
    ids: np.ndarray
    mask: np.ndarray
    floats: np.ndarray
    rank: np.ndarray
    cmatch: np.ndarray
    ins_id: np.ndarray | None = None   # uint64 (B,) — DumpField's ins_id
    # uint64 (B,) PV group id — rank_attention models build rank_offset
    # from (rank, search_id); batches from merge_by_search_id keep a
    # PV's examples adjacent
    search_id: np.ndarray | None = None

    def layout(self) -> SparseLayout:
        return SparseLayout.from_schema(self.schema)

    def slot_ids(self, name: str) -> tuple[np.ndarray, np.ndarray]:
        """(ids, mask) view of one sparse slot, shape (B, max_len)."""
        lay = self.layout()
        for i, slot in enumerate(self.schema.sparse_slots):
            if slot.name == name:
                a = lay.slot_starts[i]
                b = a + lay.slot_lens[i]
                return self.ids[:, a:b], self.mask[:, a:b]
        raise KeyError(name)

    def float_slot(self, name: str) -> np.ndarray:
        """One float slot's columns, shape (B, max_len)."""
        col = 0
        for slot in self.schema.float_slots:
            if slot.name == name:
                return self.floats[:, col:col + slot.max_len]
            col += slot.max_len
        raise KeyError(name)

    def pad_to(self, batch_size: int) -> "PackedBatch":
        """Pad to ``batch_size`` rows with masked-out examples (a tail
        batch keeps the step's shape; padded rows carry mask=False
        everywhere, so pulls resolve to the null row and metrics exclude
        them; ``num`` keeps the valid count)."""
        n = len(self.floats)
        if n >= batch_size:
            return self
        pad = batch_size - n

        def _pad(a, fill=0):
            shape = (pad,) + a.shape[1:]
            return np.concatenate([a, np.full(shape, fill, dtype=a.dtype)])

        return PackedBatch(
            schema=self.schema, num=self.num,
            ids=_pad(self.ids), mask=_pad(self.mask, False),
            floats=_pad(self.floats), rank=_pad(self.rank),
            cmatch=_pad(self.cmatch),
            ins_id=None if self.ins_id is None else _pad(self.ins_id),
            search_id=(None if self.search_id is None
                       else _pad(self.search_id)))


def batch_iterator(records: SlotRecordBatch, batch_size: int,
                   drop_last: bool = False) -> Iterator[PackedBatch]:
    n = records.num
    end = (n // batch_size) * batch_size if drop_last else n
    for start in range(0, end, batch_size):
        yield records.pack(start, min(start + batch_size, end))
