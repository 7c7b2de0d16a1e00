"""The port's HeterTrainer (host table, dense stage on the device) against
the JAX package's, on the CPU; and QueueDataset streaming into it.

Parity: the same MultiSlot data (numpy seed) and the JAX trainer's
initial DeepFM params carried into the port (weights.py); 4 steps at
prefetch_depth=1, so every pull reads the rows the previous push wrote.
The JAX side trains one batch per pass, which makes its pulls serial
too (its queue-bounded prefetch can race a pull with the previous push).
Losses are held at golden_deepfm's LOSS_TOL, every store row at
TABLE_TOL.
"""

import threading

import numpy as np
import pytest
import torch

from paddlebox_tpu.data import DataFeedSchema as JaxSchema
from paddlebox_tpu.data import parser as jax_parser
from paddlebox_tpu.embedding import EmbeddingConfig as JaxCfg
from paddlebox_tpu.embedding import HostEmbeddingStore as JaxStore
from paddlebox_tpu.models import DeepFMModel as JaxDeepFM
from paddlebox_tpu.train import HeterConfig as JaxHeterConfig
from paddlebox_tpu.train import HeterTrainer as JaxHeter

from paddlebox_tpu_torch import weights
from paddlebox_tpu_torch.data import (DataFeedSchema, QueueDataset,
                                      SlotDataset, parser)
from paddlebox_tpu_torch.embedding import EmbeddingConfig, HostEmbeddingStore
from paddlebox_tpu_torch.models import DeepFMModel
from paddlebox_tpu_torch.train import (HeterConfig, HeterTrainer, Trainer,
                                       TrainerConfig)

# several test workers share the cores; one intra-op thread each
torch.set_num_threads(1)

NUM_SLOTS, DENSE, MAX_LEN, DIM = 4, 3, 2, 4
HIDDEN = (16, 8)
BATCH, STEPS, N_KEYS = 32, 4, 60
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
TABLE_TOL = dict(rtol=1e-3, atol=2e-5)


def make_lines(n, seed=0):
    """CTR lines over a small key pool, so batches share keys and each
    pull depends on the pushes before it."""
    rng = np.random.default_rng(seed)
    keys = rng.choice(1 << 62, N_KEYS, replace=False)
    lines = []
    for _ in range(n):
        parts = [f"1 {int(rng.random() < 0.3)}"]
        parts += [f"1 {rng.normal():.6f}" for _ in range(DENSE)]
        for _ in range(NUM_SLOTS):
            ids = rng.choice(keys, int(rng.integers(1, MAX_LEN + 2)))
            parts.append(f"{len(ids)} " + " ".join(str(int(k)) for k in ids))
        lines.append(" ".join(parts))
    return lines


def _schemas():
    kw = dict(num_sparse=NUM_SLOTS, num_float=DENSE, batch_size=BATCH,
              max_len=MAX_LEN)
    return DataFeedSchema.ctr(**kw), JaxSchema.ctr(**kw)


class _OneBatch:
    """Batch k of ``records`` as a dataset of one batch."""

    def __init__(self, records, k):
        self.records, self.k = records, k

    def batches(self, batch_size, drop_last=True):
        yield self.records.pack(self.k * batch_size,
                                (self.k + 1) * batch_size)


def _emb_kw(optimizer, threshold):
    return dict(dim=DIM, optimizer=optimizer, learning_rate=0.1,
                mf_create_threshold=threshold)


def _jax_run(lines, optimizer, threshold):
    _, jschema = _schemas()
    store = JaxStore(JaxCfg(**_emb_kw(optimizer, threshold)))
    tr = JaxHeter(JaxDeepFM(num_slots=NUM_SLOTS, emb_dim=DIM,
                            dense_dim=DENSE, hidden=HIDDEN),
                  store, jschema,
                  JaxHeterConfig(global_batch_size=BATCH, dense_lr=3e-3,
                                 auc_buckets=1 << 10, prefetch_depth=1))
    params = {"mlp": [{k: np.asarray(v) for k, v in layer.items()}
                      for layer in tr.params["mlp"]],
              "bias": np.asarray(tr.params["bias"]),
              "wide_dense": np.asarray(tr.params["wide_dense"])}
    records = jax_parser.parse_multislot_lines(lines, jschema)
    losses = [tr.train_pass(_OneBatch(records, k))["loss_first"]
              for k in range(STEPS)]
    return params, losses, store


def _port_trainer(optimizer, threshold, depth=1, store=None):
    schema, _ = _schemas()
    if store is None:
        store = HostEmbeddingStore(
            EmbeddingConfig(**_emb_kw(optimizer, threshold)))
    tr = HeterTrainer(DeepFMModel(NUM_SLOTS, DIM, DENSE, hidden=HIDDEN),
                      store, schema,
                      HeterConfig(global_batch_size=BATCH, dense_lr=3e-3,
                                  auc_buckets=1 << 10,
                                  prefetch_depth=depth),
                      device="cpu")
    return store, schema, tr


def _dataset(schema, lines):
    ds = SlotDataset(schema)
    ds.records = parser.parse_multislot_lines(lines, schema)
    return ds


@pytest.mark.parametrize("optimizer,threshold", [("adagrad", 0.0),
                                                 ("adam", 0.0),
                                                 ("adagrad", 2.0)])
def test_heter_matches_jax(optimizer, threshold):
    lines = make_lines(BATCH * STEPS, seed=1)
    params, jlosses, jstore = _jax_run(lines, optimizer, threshold)
    store, schema, tr = _port_trainer(optimizer, threshold)
    weights.load_deepfm_params(tr.model, params)
    out = tr.train_pass(_dataset(schema, lines))
    assert out["steps"] == STEPS
    np.testing.assert_allclose(
        [out["loss_first"], out["loss_last"], out["loss_mean"]],
        [jlosses[0], jlosses[-1], np.mean(jlosses)], **LOSS_TOL)
    keys = store.keys()
    assert len(keys) == len(jstore) > 0
    np.testing.assert_allclose(store.get_rows(keys), jstore.get_rows(keys),
                               **TABLE_TOL)
    assert set(out["split"]) == {"pull", "device", "push"}


def test_depth_one_is_serial():
    """prefetch_depth=1: one 4-step pass equals 4 one-batch passes bit for
    bit (each pull sees the previous push)."""
    lines = make_lines(BATCH * STEPS, seed=2)
    store_a, schema, a = _port_trainer("adagrad", 0.0)
    out = a.train_pass(_dataset(schema, lines))
    store_b, _, b = _port_trainer("adagrad", 0.0)
    records = _dataset(schema, lines).records
    losses = [b.train_pass(_OneBatch(records, k))["loss_first"]
              for k in range(STEPS)]
    assert out["loss_first"] == losses[0] and out["loss_last"] == losses[-1]
    keys = store_a.keys()
    assert np.array_equal(store_a.get_rows(keys), store_b.get_rows(keys))


def test_heter_refuses_a_store_a_feed_manager_holds():
    schema, _ = _schemas()
    store = HostEmbeddingStore(EmbeddingConfig(dim=DIM))
    tr = Trainer(DeepFMModel(NUM_SLOTS, DIM, DENSE, hidden=HIDDEN), store,
                 schema, TrainerConfig(global_batch_size=BATCH),
                 device="cpu")
    with pytest.raises(RuntimeError, match="FeedPassManager"):
        _port_trainer("adagrad", 0.0, store=store)
    tr.feed_mgr.close()                  # flush and detach
    _, _, heter = _port_trainer("adagrad", 0.0, store=store)
    assert heter.train_pass(_dataset(schema, make_lines(BATCH)))["steps"] == 1


def test_heter_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("needs a host without CUDA")
    schema, _ = _schemas()
    with pytest.raises(RuntimeError, match="CUDA"):
        HeterTrainer(DeepFMModel(NUM_SLOTS, DIM, DENSE, hidden=HIDDEN),
                     HostEmbeddingStore(EmbeddingConfig(dim=DIM)), schema)


def _write_files(tmp_path, n_files, lines_per, seed=0):
    paths = []
    for f in range(n_files):
        p = tmp_path / f"part-{f:03d}"
        p.write_text("\n".join(make_lines(lines_per, seed=seed + f)) + "\n")
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("depth", [1, 3])
def test_queue_dataset_feeds_heter_trainer(tmp_path, depth):
    schema, _ = _schemas()
    files = _write_files(tmp_path, 4, 40)
    q = QueueDataset(schema, num_threads=2, queue_capacity=2)
    q.set_filelist(files)
    store, _, tr = _port_trainer("adagrad", 0.0, depth=depth)
    out = tr.train_pass(q)
    assert out["steps"] == 160 // BATCH and np.isfinite(out["loss_mean"])
    # every streamed token counted once in the store's show column
    n_tokens = 0
    for f in files:
        with open(f) as fh:
            recs = parser.parse_multislot_lines(fh.read().splitlines(),
                                                schema)
        lens = [np.minimum(np.diff(o), MAX_LEN) for o in recs.sparse_offsets]
        n_tokens += int(sum(ln.sum() for ln in lens))
    assert float(store.get_rows(store.keys())[:, 0].sum()) == n_tokens
    assert q.last_stream_stats["records"] == 160


def test_heter_surfaces_reader_errors(tmp_path):
    schema, _ = _schemas()
    q = QueueDataset(schema, num_threads=1)
    q.set_filelist(_write_files(tmp_path, 2, 40)
                   + [str(tmp_path / "missing.txt")])
    _, _, tr = _port_trainer("adagrad", 0.0)
    with pytest.raises(OSError):
        tr.train_pass(q)


@pytest.mark.parametrize("state", ["unloaded", "released"])
def test_heter_raises_on_a_dataset_without_records(state):
    """SlotDataset.batches raises at once when nothing is loaded: the pass
    raises it too (as the JAX trainer does) and does not hang."""
    schema, _ = _schemas()
    ds = SlotDataset(schema)
    if state == "released":
        ds.records = parser.parse_multislot_lines(make_lines(BATCH), schema)
        ds.release_memory()
    _, _, tr = _port_trainer("adagrad", 0.0)
    raised: list[BaseException] = []

    def run():
        try:
            tr.train_pass(ds)
        except BaseException as e:      # handed to the test thread
            raised.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "train_pass hung on a dataset with no records"
    assert len(raised) == 1 and isinstance(raised[0], RuntimeError)
    assert "load_into_memory" in str(raised[0])
