"""The port's trainer options against the JAX Trainer's (make_mesh(1)).

- ``check_nan_inf``: a NaN put into one dense parameter trips the guard
  at the same step in both packages, with the same message, the same
  non-finite leaf paths and the same dumped npz member names
  (``nan_dump_dir``); ``flags.check_nan_inf`` turns it on too;
- with the option off the step loop reads nothing back from the device:
  the guard's loss read-back runs once a step with it on and never with
  it off;
- ``dump_fields_path`` with ``dump_fields`` (ins_id, a float slot, a
  sparse slot) and ``dump_param``: the same lines and columns as the JAX
  trainer's file, preds within the loss tolerance (rtol 2e-4 / atol
  2e-5) and params within the MLP tolerance (rtol 2e-3 / atol 2e-5);
  ``DumpStream.write_fields`` on identical inputs writes the same bytes
  as the JAX package's; a writer failure is raised at close.
"""

import ast
import re

import numpy as np
import pytest
import torch

import jax

from paddlebox_tpu import models as jmodels
from paddlebox_tpu.data import DataFeedSchema as JaxSchema
from paddlebox_tpu.data import SlotDataset as JaxDataset
from paddlebox_tpu.embedding import EmbeddingConfig as JaxCfg
from paddlebox_tpu.embedding import HostEmbeddingStore as JaxStore
from paddlebox_tpu.parallel import make_mesh
from paddlebox_tpu.train import Trainer as JaxTrainer
from paddlebox_tpu.train import TrainerConfig as JaxTrainerConfig
from paddlebox_tpu.utils.profiler import DumpStream as JaxDumpStream
from paddlebox_tpu.utils.profiler import find_nonfinite as jax_nonfinite

from paddlebox_tpu_torch import models
from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.data import DataFeedSchema, SlotDataset
from paddlebox_tpu_torch.embedding import EmbeddingConfig, HostEmbeddingStore
from paddlebox_tpu_torch.train import Trainer, TrainerConfig
from paddlebox_tpu_torch.utils.profiler import DumpStream, find_nonfinite

from tests.test_torch_zoo import _records

torch.set_num_threads(1)

S, DENSE, DIM, BATCH, STEPS = 3, 2, 4, 16, 3
HIDDEN = (8, 8)
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
MLP_TOL = dict(rtol=2e-3, atol=2e-5)


def _pair(**opts):
    kw = dict(global_batch_size=BATCH, auc_buckets=1 << 10, **opts)
    ecfg = dict(dim=DIM, optimizer="adagrad", learning_rate=0.05)
    jschema = JaxSchema.ctr(num_sparse=S, num_float=DENSE, batch_size=BATCH,
                            max_len=2)
    jtr = JaxTrainer(jmodels.DeepFMModel(S, DIM, DENSE, hidden=HIDDEN),
                     JaxStore(JaxCfg(**ecfg)), jschema, make_mesh(1),
                     JaxTrainerConfig(**kw))
    schema = DataFeedSchema.ctr(num_sparse=S, num_float=DENSE,
                                batch_size=BATCH, max_len=2)
    tr = Trainer(models.DeepFMModel(S, DIM, DENSE, hidden=HIDDEN),
                 HostEmbeddingStore(EmbeddingConfig(**ecfg)), schema,
                 TrainerConfig(**kw), device="cpu")
    tr.restore_dense(jax.tree.map(np.asarray, jtr.params))
    return jtr, tr


def _data(jtr, tr, seed, n=STEPS * BATCH):
    jds = JaxDataset(jtr.schema)
    jds.records = _records("jax", jtr.schema, n, seed, 2)
    ds = SlotDataset(tr.schema)
    ds.records = _records("port", tr.schema, n, seed, 2)
    return jds, ds


# ---------------------------------------------------------------------------
# the non-finite guard
# ---------------------------------------------------------------------------

def _trip(tr, ds):
    with pytest.raises(FloatingPointError) as e:
        tr.train_pass(ds)
    msg = str(e.value)
    step = int(re.search(r"at step (\d+)", msg).group(1))
    m = re.search(r"leaves: (\[.*\])(?: \(scope dumped to (\S+)\))?$", msg)
    return step, ast.literal_eval(m.group(1)), m.group(2)


def test_nan_guard_trips_as_the_reference_does(tmp_path):
    jtr, tr = _pair(check_nan_inf=True)
    jtr.cfg.nan_dump_dir = str(tmp_path / "jax")
    tr.cfg.nan_dump_dir = str(tmp_path / "port")
    jds, ds = _data(jtr, tr, 1)
    jtr.train_pass(jds)                      # a clean pass: 3 steps
    tr.train_pass(ds)
    # a NaN in one dense parameter: the next step's loss is NaN
    jp = jax.tree.map(np.array, jtr.params)
    jp["mlp"][1]["w"][2, 3] = np.nan
    jtr.params = jax.tree.map(jax.numpy.asarray, jp)
    with torch.no_grad():
        tr.model.mlp[1].w[2, 3] = float("nan")
    jds, ds = _data(jtr, tr, 2)
    jstep, jleaves, jdump = _trip(jtr, jds)
    step, leaves, dump = _trip(tr, ds)
    assert step == jstep == STEPS
    assert leaves == jleaves
    assert "['loss']" in leaves and "['params']['mlp'][1]['w']" in leaves
    assert dump == str(tmp_path / "port" / f"nan_step{STEPS}.npz")
    with np.load(dump) as got, np.load(jdump) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got["['labels']"],
                                      want["['labels']"])
        assert np.isnan(got["['loss']"]) and np.isnan(want["['loss']"])
    assert tr.global_step == STEPS        # the tripped step is not counted


def test_find_nonfinite_names_paths_as_the_reference():
    tree = {"params": {"mlp": [{"w": np.array([1.0, np.inf], np.float32),
                                "b": np.zeros(2, np.float32)}],
                       "bias": np.array([np.nan], np.float32)},
            "loss": np.float32(1.0), "ids": np.arange(3)}
    assert find_nonfinite(tree) == jax_nonfinite(tree)
    assert find_nonfinite({"t": torch.tensor([float("nan")])}) == ["['t']"]


def _count_reads(monkeypatch):
    calls = []
    read = Trainer._read_loss

    def counted(loss):
        calls.append(1)
        return read(loss)

    monkeypatch.setattr(Trainer, "_read_loss", staticmethod(counted))
    return calls


def test_guard_off_reads_nothing_back(monkeypatch):
    """The loss read-back (the one host sync of a step) happens once a
    step with the guard on, by the option or by the flag, and never with
    it off."""
    calls = _count_reads(monkeypatch)
    jtr, tr = _pair()
    _, ds = _data(jtr, tr, 3)
    tr.train_pass(ds)
    assert calls == []
    tr.cfg.check_nan_inf = True
    tr.train_pass(ds)
    assert len(calls) == STEPS
    tr.cfg.check_nan_inf = False
    monkeypatch.setattr(flags, "check_nan_inf", True)
    tr.train_pass(ds)
    assert len(calls) == 2 * STEPS


# ---------------------------------------------------------------------------
# dump streams
# ---------------------------------------------------------------------------

DUMP_FIELDS = ("ins_id", "dense_1", "slot_2")


def _parse(path):
    fields, params = [], {}
    for line in open(path).read().splitlines():
        if line.startswith("param "):
            _, name, vals = line.split(" ")
            params[name] = np.array([float(v) for v in vals.split(",")])
        else:
            fields.append(line.split(" "))
    return fields, params


def test_dump_fields_and_params_match_reference(tmp_path):
    opts = dict(dump_fields=DUMP_FIELDS, dump_param=("mlp/1", "bias"))
    jtr, tr = _pair(dump_fields_path=str(tmp_path / "jax.txt"), **opts)
    tr.cfg.dump_fields_path = str(tmp_path / "port.txt")
    jds, ds = _data(jtr, tr, 4)
    jtr.train_pass(jds)
    tr.train_pass(ds)
    got, got_p = _parse(tmp_path / "port.txt")
    want, want_p = _parse(tmp_path / "jax.txt")
    assert len(got) == len(want) == STEPS * BATCH
    for g, w in zip(got, want):
        assert len(g) == len(w) == 4 + len(DUMP_FIELDS)
        assert g[:2] == w[:2] and g[3:] == w[3:]      # step, i, label, fields
        np.testing.assert_allclose(float(g[2]), float(w[2]), **LOSS_TOL)
    assert [c.split(":")[0] for c in got[0][4:]] == list(DUMP_FIELDS)
    assert sorted(got_p) == sorted(want_p) == [
        "bias", "mlp/1/b", "mlp/1/w"]
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], **MLP_TOL)
    # the stream appends, as the reference's does: a second pass adds
    # its lines after the first's
    tr.train_pass(ds)
    assert len(_parse(tmp_path / "port.txt")[0]) == 2 * STEPS * BATCH


def test_write_fields_bytes_match_reference(tmp_path):
    rng = np.random.default_rng(5)
    n = 7
    preds = rng.random(n).astype(np.float32)
    labels = (rng.random(n) < 0.5).astype(np.float32)
    ids = rng.integers(0, 1 << 40, (n, 3))
    extra = {"ins_id": rng.integers(0, 1 << 60, n).astype(np.uint64),
             "dense_1": rng.normal(size=n).astype(np.float32),
             "multi": rng.normal(size=(n, 2)).astype(np.float32),
             "slot_2": (ids, rng.random((n, 3)) < 0.6)}
    for cls, name in ((DumpStream, "port"), (JaxDumpStream, "jax")):
        with cls(str(tmp_path / name)) as ds:
            ds.write_fields(3, preds, labels, extra)
            ds.write("param mlp/0/b 0.5,1")
    got = (tmp_path / "port").read_bytes()
    assert got == (tmp_path / "jax").read_bytes()
    assert got.count(b"\n") == n + 1
    # torch tensors go through the same formatting
    with DumpStream(str(tmp_path / "t")) as ds:
        ds.write_fields(3, torch.from_numpy(preds), torch.from_numpy(labels),
                        extra)
        ds.write("param mlp/0/b 0.5,1")
    assert (tmp_path / "t").read_bytes() == got


def test_dump_writer_failure_is_raised_at_close(tmp_path):
    class Broken:
        def write(self, _):
            raise OSError("disk full")

        def close(self):
            pass

    ds = DumpStream(str(tmp_path / "d"))
    ds._f.close()
    ds._f = Broken()
    ds.write("a line")
    ds.write_fields(0, np.zeros(2), np.zeros(2))
    with pytest.raises(RuntimeError, match="DumpStream writer failed") as e:
        ds.close()
    assert isinstance(e.value.__cause__, OSError)
