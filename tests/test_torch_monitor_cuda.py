"""The monitor's read side on the card: the step probe's stage
attribution and its launch accounting, the ablated step against the CPU,
the push floor at the card's peaks, and the world trace's per-pass
device capture holding the step's kernels. Every test carries the
``cuda`` marker and skips without a CUDA card. The file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_monitor_cuda.py

Small jobs (26 one-hot or multi-hot slots, dim 8 / 16, batch 256, 6
steps a pass).
"""

import json
import os

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch import monitor
from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.data import DataFeedSchema, SlotDataset
from paddlebox_tpu_torch.data.slot_record import SlotRecordBatch
from paddlebox_tpu_torch.embedding import (EmbeddingConfig,
                                           HostEmbeddingStore, PassWorkingSet)
from paddlebox_tpu_torch.fleet import BoxPS
from paddlebox_tpu_torch.models import DeepFMModel
from paddlebox_tpu_torch.monitor import trace as trace_lib
from paddlebox_tpu_torch.ops import kernels
from paddlebox_tpu_torch.train import Trainer, TrainerConfig
from paddlebox_tpu_torch.utils import step_probe

pytestmark = pytest.mark.cuda

S, DENSE, BATCH, STEPS = 26, 13, 256, 6
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
TABLE_TOL = dict(rtol=1e-3, atol=2e-5)
MLP_TOL = dict(rtol=2e-3, atol=2e-5)
LAYOUTS = {"onehot": (1, 8, ("binned_merge_acc", "merge_update")),
           "multihot": (4, 16, ("gather_pool", "scatter_accumulate"))}
KERNELS = ("gather_pool", "scatter_accumulate", "binned_merge_acc",
           "merge_update")
READ_FLAGS = ("trace", "trace_device", "trace_device_dir", "doctor_live")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in READ_FLAGS:
        monkeypatch.setattr(flags, k, getattr(flags, k))
    h = monitor.hub()
    h.disable()
    h.abort_pass(reason="test setup")
    yield
    h.abort_pass(reason="test teardown")
    h.disable()
    trace_lib.on_end_pass()


def _records(schema, max_len, seed):
    n = STEPS * BATCH
    rng = np.random.default_rng(seed)
    keys = rng.choice(1 << 40, 20000, replace=False).astype(np.int64)
    lens = [rng.integers(1, max_len + 1, n) for _ in range(S)]
    vals = [rng.choice(keys, int(l.sum())) for l in lens]
    offs = [np.concatenate([[0], np.cumsum(l)]).astype(np.int64)
            for l in lens]
    floats = [(rng.random(n) < 0.25).astype(np.float32)]
    floats += [rng.normal(size=n).astype(np.float32) for _ in range(DENSE)]
    z64, z32 = np.zeros(n, np.uint64), np.zeros(n, np.int32)
    return SlotRecordBatch(schema, n, vals, offs, floats, z64, z64, z32, z32)


def _job(layout, device):
    max_len, dim, _ = LAYOUTS[layout]
    store = HostEmbeddingStore(EmbeddingConfig(dim=dim, optimizer="adagrad",
                                               learning_rate=0.05))
    schema = DataFeedSchema.ctr(num_sparse=S, num_float=DENSE,
                                batch_size=BATCH, max_len=max_len)
    tr = Trainer(DeepFMModel(S, dim, DENSE, hidden=(64, 64)), store, schema,
                 TrainerConfig(global_batch_size=BATCH, auc_buckets=1 << 12),
                 seed=0, device=device)
    ds = SlotDataset(schema)
    ds.records = _records(schema, max_len, 1)
    return store, tr, ds


def _staged(tr, ds):
    ws = tr.last_ws
    pb = next(iter(ds.batches(BATCH)))
    idx = ws.translate(pb.ids, pb.mask)
    labels, dense = tr.split_floats(pb.floats)
    return ws, idx, tr.stage(tr.pack_arrays(ws, idx, pb.mask, dense,
                                            labels))


def _reset():
    for name in KERNELS:
        getattr(kernels, name).launches = 0


def _launches():
    return {n: getattr(kernels, n).launches for n in KERNELS}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_attribution_launches_what_its_calls_predict(card, layout):
    _, tr, ds = _job(layout, card)
    out = tr.train_pass(ds)
    ws, _, staged = _staged(tr, ds)
    torch.cuda.synchronize()
    _reset()
    att = step_probe.attribute_step(tr, ws, staged,
                                    out["step_seconds"] / out["steps"],
                                    windows=2)
    got = _launches()
    c = att["calls"]
    push = c["step"] + c["overlap_applies"] + c["isolated_push"]
    if layout == "multihot":
        want = {"gather_pool": c["step"] + c["ablate_push"]
                + c["overlap_pair"] + c["overlap_loss_path"]
                + c["isolated_lookup"],
                "scatter_accumulate": push, "binned_merge_acc": 0,
                "merge_update": 0}
    else:
        want = {"gather_pool": 0, "scatter_accumulate": 0,
                "binned_merge_acc": push, "merge_update": push}
    assert got == want
    assert att["coverage"] == pytest.approx(1.0, abs=0.01)
    assert att["single_step_seconds"] > 0
    assert all(v >= 0 for v in att["isolated"].values())


@pytest.mark.parametrize("ablate", [("push",), ("lookup",), ("fwdbwd",),
                                    ("push", "lookup", "fwdbwd")])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_ablated_step_card_matches_cpu(card, layout, ablate):
    """One ablated step on the card (the kernels) and on the CPU (the
    plain versions) from the same weights and table."""
    res = {}
    for dev in (card, "cpu"):
        store, tr, ds = _job(layout, dev)
        tr.last_ws = ws = PassWorkingSet.begin_pass(
            store, np.unique(ds.unique_keys()), device=dev)
        _, _, staged = _staged(tr, ds)
        loss, preds = tr.train_step(ws.table, *staged, ablate=ablate)
        res[str(dev)] = (float(loss), preds.cpu().numpy(),
                         ws.table.cpu().numpy(),
                         [p.detach().cpu().numpy() for p in tr.params])
    a, b = res[str(card)], res["cpu"]
    np.testing.assert_allclose(a[0], b[0], **LOSS_TOL)
    np.testing.assert_allclose(a[1], b[1], **MLP_TOL)
    np.testing.assert_allclose(a[2], b[2], **TABLE_TOL)
    for x, y in zip(a[3], b[3]):
        np.testing.assert_allclose(x, y, **MLP_TOL)


def test_push_floor_at_the_cards_peaks(card):
    peaks = step_probe.device_peaks()
    name = torch.cuda.get_device_name()
    if name not in step_probe.PEAKS:
        assert peaks is None
        pytest.skip(f"no peak table entry for {name}")
    assert peaks == step_probe.PEAKS[name]
    c = EmbeddingConfig(dim=8, optimizer="adagrad", learning_rate=0.05)
    fl = step_probe.push_floor_analysis(c, 1 << 19, 212_992, peaks=peaks,
                                        unique_lanes=175_000)
    assert fl["engine"] == "binned_kernel"
    assert 1e-5 < fl["floor_seconds"] < 1e-4
    step_probe.finalize_push_floor(fl, 1.0)
    assert fl["closed"].startswith("measured")


def test_device_capture_holds_the_kernels(card, tmp_path):
    """A traced one-hot pass with trace_device: the pass's Chrome trace
    holds its binned_merge_acc and merge_update launches, no capture
    error is counted."""
    flags.trace = True
    flags.trace_device = True
    flags.trace_device_dir = str(tmp_path / "dev")
    store, tr, ds = _job("onehot", card)
    box = BoxPS(store)
    errs0 = monitor.STATS.get("trace.device_capture_errors")
    h = monitor.hub()
    ms = monitor.MemorySink()
    h.enable(ms)
    box.begin_pass()
    _reset()
    tr.train_pass(ds)
    assert _launches()["binned_merge_acc"] == STEPS
    box.end_pass(trainer=tr)
    path = trace_lib.last_device_trace
    assert path == str(tmp_path / "dev" / "pass-00001" / "trace.json")
    with open(path) as f:
        names = [str(e.get("name", "")) for e in json.load(f)["traceEvents"]]
    assert sum("binned_merge_acc_kernel" in n for n in names) >= STEPS
    assert sum("merge_update_kernel" in n for n in names) >= STEPS
    assert monitor.STATS.get("trace.device_capture_errors") == errs0
    assert [e["fields"]["state"] for e in ms.find("trace.device_capture")] \
        == ["started", "stopped"]
    assert os.path.getsize(path) > 0
