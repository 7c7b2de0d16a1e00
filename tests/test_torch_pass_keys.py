"""The pass's key set on the card: ``SlotRecordBatch.unique_keys(device=)``
against the host path, ``sorted_unique(np.concatenate(columns))``, in
values, order and dtype.

- On a CUDA card (``cuda`` marker; skips without one): int64 ids and
  uint64 ids at and above 2^63, one-hot and ragged multi-hot slots, one
  slot, one id, an already strictly increasing pass, heavy duplicates,
  passes of many chunks, and the columns the card declines (a dtype mix
  that np.concatenate would promote, int32), each with its counter
  (``pass_keys.device`` / ``pass_keys.host``); the sort's transient card
  memory; and a ``train_pass`` whose preloaded staging the card's key
  set must still match, one ``pass_keys.device`` a pass.
- On the CPU: the same cases through ``device_sorted_unique`` on the
  CPU (the chunking, the merge and the uint64 order), which path
  ``sorts_on_card`` picks, the host path and its counter for a CPU
  trainer, and the same ``train_pass`` on the CPU.

The file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_pass_keys.py
"""

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch import monitor
from paddlebox_tpu_torch.data import DataFeedSchema, SlotDataset
from paddlebox_tpu_torch.data import slot_record
from paddlebox_tpu_torch.data.slot_record import (SlotRecordBatch,
                                                  device_sorted_unique,
                                                  sorts_on_card)
from paddlebox_tpu_torch.embedding import EmbeddingConfig, HostEmbeddingStore
from paddlebox_tpu_torch.models import DeepFMModel
from paddlebox_tpu_torch.native.key_index import sorted_unique
from paddlebox_tpu_torch.train import Trainer, TrainerConfig

CUDA = torch.device("cuda")
COUNTERS = ("pass_keys.device", "pass_keys.host")
EDGES = np.array([0, 1, (1 << 63) - 1, 1 << 63, (1 << 63) + 1,
                  (1 << 64) - 1], np.uint64)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return CUDA


def _pool(rng, dtype, n):
    """n distinct-ish ids of ``dtype``: uint64 over the whole range plus
    the ids either side of 2^63, int64 of both signs."""
    if dtype == np.uint64:
        return np.concatenate([EDGES, rng.integers(
            0, 1 << 64, n, dtype=np.uint64, endpoint=False)])
    return rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)


def _onehot(rng, dtype, slots=26, n=4096, distinct=20000):
    pool = _pool(rng, dtype, distinct)
    return [rng.choice(pool, n) for _ in range(slots)]


def _multihot(rng, dtype, slots=8, n=2048, max_len=5):
    """Ragged slots of 0 to max_len ids an example; slot 3 holds none."""
    pool = _pool(rng, dtype, 5000)
    lens = [rng.integers(0, max_len + 1, n) for _ in range(slots)]
    lens[3][:] = 0
    return [rng.choice(pool, int(ln.sum())) for ln in lens]


CASES = {
    "int64_onehot": lambda rng: _onehot(rng, np.int64),
    "uint64_onehot": lambda rng: _onehot(rng, np.uint64),
    "int64_multihot": lambda rng: _multihot(rng, np.int64),
    "uint64_multihot": lambda rng: _multihot(rng, np.uint64),
    "one_slot": lambda rng: _onehot(rng, np.uint64, slots=1),
    "one_id_int64": lambda rng: [np.array([-7], np.int64)],
    "one_id_uint64": lambda rng: [EDGES[-1:].copy()],
    "increasing": lambda rng: np.split(
        np.cumsum(rng.integers(1, 1 << 40, 3000)).astype(np.int64), 3),
    "increasing_uint64": lambda rng: [np.sort(_pool(rng, np.uint64, 3000))],
    "duplicates": lambda rng: [rng.choice(EDGES[1:5], 4096)
                               for _ in range(26)],
}
# (case, chunk): a pass larger than one chunk, the chunk edges falling
# inside columns
CHUNKED = [("int64_onehot", 1000), ("uint64_onehot", 1000),
           ("uint64_multihot", 777), ("duplicates", 4096)]
ALL = [(c, None) for c in CASES] + CHUNKED


def _records(cols):
    """A SlotRecordBatch around ``cols`` (unique_keys reads the columns
    alone; one id an example where the columns allow)."""
    n = max(len(c) for c in cols)
    schema = DataFeedSchema.ctr(num_sparse=len(cols), num_float=1,
                                batch_size=max(n, 1), max_len=1)
    offs = [np.minimum(np.arange(n + 1), len(c)).astype(np.int64)
            for c in cols]
    z64, z32 = np.zeros(n, np.uint64), np.zeros(n, np.int32)
    return SlotRecordBatch(schema, n, list(cols), offs,
                           [np.zeros(n, np.float32)], z64, z64, z32, z32)


def _counts():
    snap = monitor.STATS.snapshot()
    return np.array([snap.get(k, 0.0) for k in COUNTERS])


def _same(got, cols):
    want = sorted_unique(np.concatenate(cols))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _cols(case, seed=0):
    return CASES[case](np.random.default_rng(seed))


@pytest.mark.cuda
@pytest.mark.parametrize("case,chunk", ALL)
def test_card_key_set_is_the_host_key_set(card, monkeypatch, case, chunk):
    """The card's key set: the host path's values, order and dtype, one
    ``pass_keys.device`` a call."""
    if chunk is not None:
        monkeypatch.setattr(slot_record, "CARD_CHUNK_IDS", chunk)
    cols = _cols(case)
    c0 = _counts()
    got = _records(cols).unique_keys(device=card)
    np.testing.assert_array_equal(_counts() - c0, [1, 0])
    _same(got, cols)


@pytest.mark.parametrize("case,chunk", ALL)
def test_device_sort_on_the_cpu(monkeypatch, case, chunk):
    """The card path's arithmetic (chunks, merge, uint64 order) run on
    the CPU: the host path's values, order and dtype."""
    if chunk is not None:
        monkeypatch.setattr(slot_record, "CARD_CHUNK_IDS", chunk)
    cols = _cols(case)
    assert sorts_on_card(cols, CUDA)
    _same(device_sorted_unique(cols, "cpu"), cols)


DECLINED = {
    "mixed": lambda rng: [_onehot(rng, np.int64, 1)[0],
                          _onehot(rng, np.uint64, 1)[0]],
    "int32": lambda rng: [rng.integers(0, 1 << 30, 100, dtype=np.int32)],
    "big_endian": lambda rng: [_onehot(rng, np.int64, 1)[0]
                               .astype(">i8")],
    "empty": lambda rng: [np.zeros(0, np.int64), np.zeros(0, np.int64)],
}


@pytest.mark.parametrize("case", list(DECLINED))
def test_declined_columns_take_the_host_path(case):
    """Columns the card declines sort on the host even for a CUDA device
    (the choice reads the dtypes alone, so the CPU can hold it)."""
    cols = DECLINED[case](np.random.default_rng(1))
    assert not sorts_on_card(cols, CUDA)
    c0 = _counts()
    got = _records(cols).unique_keys(device=CUDA)
    np.testing.assert_array_equal(_counts() - c0, [0, 1])
    _same(got, cols)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(DECLINED))
def test_declined_columns_on_the_card(card, case):
    cols = DECLINED[case](np.random.default_rng(1))
    c0 = _counts()
    got = _records(cols).unique_keys(device=card)
    np.testing.assert_array_equal(_counts() - c0, [0, 1])
    _same(got, cols)


@pytest.mark.parametrize("device", [None, "cpu"])
def test_a_cpu_device_takes_the_host_path(device):
    cols = _cols("uint64_onehot")
    dev = None if device is None else torch.device(device)
    assert not sorts_on_card(cols, dev)
    c0 = _counts()
    got = _records(cols).unique_keys(device=dev)
    np.testing.assert_array_equal(_counts() - c0, [0, 1])
    _same(got, cols)


def test_no_columns_take_the_host_path():
    rec = _records([np.zeros(1, np.int64)])
    rec.sparse_values = []
    got = rec.unique_keys(device=CUDA)
    assert got.dtype == np.int64 and len(got) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [None, 1 << 20])
def test_card_key_set_memory_is_bounded(card, monkeypatch, chunk):
    """The sort's transient card memory: under 4x the ids' bytes in one
    chunk; in chunks, under 4x a chunk's bytes plus 4x the distinct
    keys' bytes (the merge)."""
    if chunk is not None:
        monkeypatch.setattr(slot_record, "CARD_CHUNK_IDS", chunk)
    rng = np.random.default_rng(2)
    n, slots = 1 << 17, 32                       # 2^22 ids, 32 MiB
    pool = rng.integers(0, 1 << 62, 1 << 20, dtype=np.int64)
    cols = [rng.choice(pool, n) for _ in range(slots)]
    distinct = len(np.unique(np.concatenate(cols)))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(card)
    torch.cuda.reset_peak_memory_stats(card)
    got = _records(cols).unique_keys(device=card)
    peak = torch.cuda.max_memory_allocated(card) - base
    _same(got, cols)
    ids = n * slots
    bound = (4 * 8 * ids if chunk is None
             else 4 * 8 * chunk + 4 * 8 * distinct)
    assert peak <= bound, (peak, bound)
    assert torch.cuda.memory_allocated(card) == base


S, DENSE, BATCH, STEPS = 6, 3, 128, 3


def _pass_records(schema, seed, dtype):
    """One-hot passes over one pool of ids (uint64 ones at and above
    2^63), so the next pass reuses rows of this one."""
    rng = np.random.default_rng(seed)
    pool = _pool(np.random.default_rng(99), dtype, 2000)
    n = STEPS * BATCH
    vals = [rng.choice(pool, n) for _ in range(S)]
    offs = [np.arange(n + 1, dtype=np.int64)] * S
    floats = [(rng.random(n) < 0.25).astype(np.float32)]
    floats += [rng.normal(size=n).astype(np.float32) for _ in range(DENSE)]
    z64, z32 = np.zeros(n, np.uint64), np.zeros(n, np.int32)
    return SlotRecordBatch(schema, n, vals, offs, floats, z64, z64, z32, z32)


def _staged_passes(device, dtype):
    """Three passes, each preloading the next pass's host-path keys;
    returns each pass's staging as ``_take_staging`` gave it, each
    pass's counter deltas, and the trainer."""
    store = HostEmbeddingStore(EmbeddingConfig(dim=4, optimizer="adagrad",
                                               learning_rate=0.05))
    schema = DataFeedSchema.ctr(num_sparse=S, num_float=DENSE,
                                batch_size=BATCH, max_len=1)
    tr = Trainer(DeepFMModel(S, 4, DENSE, hidden=(16,)), store, schema,
                 TrainerConfig(global_batch_size=BATCH, auc_buckets=1 << 10),
                 seed=0, device=device)
    dss = []
    for p in range(3):
        ds = SlotDataset(schema)
        ds.records = _pass_records(schema, p, dtype)
        dss.append(ds)
    fm = tr.feed_mgr
    taken, counts = [], []
    take = fm._take_staging

    def spy(*a, **kw):
        taken.append(take(*a, **kw))
        return taken[-1]

    fm._take_staging = spy
    for p, ds in enumerate(dss):
        nxt = dss[p + 1].unique_keys() if p < 2 else None
        c0 = _counts()
        out = tr.train_pass(ds, preload_keys=nxt)
        counts.append(_counts() - c0)
        assert out["steps"] == STEPS
    tr.wait_feed_pass_done()
    return taken, counts, tr


def _check_staged(device, dtype, path):
    taken, counts, tr = _staged_passes(device, dtype)
    # pass 1 has no staging; passes 2 and 3 consume the preloaded one:
    # the pass's own key set matched the preloaded keys
    assert taken[0] is None
    assert taken[1] is not None and taken[2] is not None
    assert tr.feed_mgr.last_reused_rows > 0
    for c in counts:
        np.testing.assert_array_equal(c, path)


@pytest.mark.parametrize("dtype", [np.int64, np.uint64])
def test_cpu_train_pass_consumes_the_staging(dtype):
    _check_staged(torch.device("cpu"), dtype, [0, 1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int64, np.uint64])
def test_card_train_pass_consumes_the_staging(card, dtype):
    """The card's key set of a pass matches the keys the pass before
    preloaded (host path), so the boundary consumes the staging and
    builds nothing in full; one ``pass_keys.device`` a pass."""
    _check_staged(card, dtype, [1, 0])
