"""The port's day/pass loop persists and resumes as the JAX package's
does, across packages:

- a 3-pass lifecycle (``BoxPS.end_pass(checkpointer=...)``, base_every 2:
  a base, a delta, a new chain's base) in both packages from the same
  params and data; the port resumes pass 2 from its own snapshot root
  and from the JAX package's, and the JAX package from the port's. The
  restored store, dense params, adam state, metric state and cursor are
  bit-equal to what the live run held after pass 2, and pass 3 trained
  from the resumed state matches the uninterrupted JAX pass 3 at
  tests/golden_deepfm.py's tolerances (loss rtol 2e-4 / atol 2e-5, table
  rtol 1e-3 / atol 2e-5, mlp rtol 2e-3 / atol 2e-5);
- a torn newest snapshot falls back to the previous one, and a save
  killed at ``pass_ckpt.pre_manifest`` is invisible to resume;
- a JAX mid-pass snapshot resumes in the port through ``skip_steps``
  (tests/test_torch_midpass.py covers the port's own mid-pass saves);
- ``eval_pass`` against the JAX package's, the store neither grown nor
  dirtied;
- a foreign save on the store makes the next snapshot a base;
- the shuffle cursor carries the same permutations across packages.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from paddlebox_tpu.data import DataFeedSchema as JaxSchema
from paddlebox_tpu.data import SlotDataset as JaxDataset
from paddlebox_tpu.data.slot_record import SlotRecordBatch as JaxRecords
from paddlebox_tpu.embedding import EmbeddingConfig as JaxCfg
from paddlebox_tpu.embedding import HostEmbeddingStore as JaxStore
from paddlebox_tpu.fleet.boxps import BoxPS as JaxBoxPS
from paddlebox_tpu.models import DeepFMModel as JaxDeepFM
from paddlebox_tpu.parallel import make_mesh
from paddlebox_tpu.train import Trainer as JaxTrainer
from paddlebox_tpu.train import TrainerConfig as JaxTrainerConfig
from paddlebox_tpu.utils.checkpoint import _path_str
from paddlebox_tpu.utils.pass_ckpt import PassCheckpointer as JaxCkpt

from paddlebox_tpu_torch import weights
from paddlebox_tpu_torch.data import DataFeedSchema, SlotDataset
from paddlebox_tpu_torch.data.slot_record import SlotRecordBatch
from paddlebox_tpu_torch.embedding import EmbeddingConfig, HostEmbeddingStore
from paddlebox_tpu_torch.fleet import BoxPS, FleetUtil
from paddlebox_tpu_torch.models import DeepFMModel
from paddlebox_tpu_torch.train import Trainer, TrainerConfig
from paddlebox_tpu_torch.utils.checkpoint import flatten_tree
from paddlebox_tpu_torch.utils.pass_ckpt import PassCheckpointer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_SLOTS, DENSE_DIM, EMB_DIM = 4, 3, 8
HIDDEN = (16, 16)
BATCH, STEPS = 32, 6
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
TABLE_TOL = dict(rtol=1e-3, atol=2e-5)
MLP_TOL = dict(rtol=2e-3, atol=2e-5)
AUC_BUCKETS = 1 << 12


# ---------------------------------------------------------------------------
# both packages' loops
# ---------------------------------------------------------------------------

def _records(pkg, schema, n, seed, max_len):
    """``n`` examples whose keys come from a pool that shifts with the
    seed, so each pass both updates earlier keys and brings new ones."""
    records_cls = SlotRecordBatch if pkg == "port" else JaxRecords
    rng = np.random.default_rng(seed)
    pool = np.random.default_rng(0).choice(1 << 50, 1200, replace=False)
    keys = pool[seed * 150:seed * 150 + 400].astype(np.int64)
    lens = [rng.integers(1, max_len + 1, n) for _ in range(NUM_SLOTS)]
    vals = [rng.choice(keys, int(l.sum())) for l in lens]
    offs = [np.concatenate([[0], np.cumsum(l)]).astype(np.int64)
            for l in lens]
    floats = [(rng.random(n) < 0.3).astype(np.float32)]
    floats += [rng.normal(size=n).astype(np.float32)
               for _ in range(DENSE_DIM)]
    z64, z32 = np.zeros(n, np.uint64), np.zeros(n, np.int32)
    return records_cls(schema, n, vals, offs, floats, z64, z64, z32, z32)


def _dataset(pkg, tr, seed, max_len=4, n=STEPS * BATCH):
    ds = (SlotDataset if pkg == "port" else JaxDataset)(tr.schema)
    ds.records = _records(pkg, tr.schema, n, seed, max_len)
    return ds


_INIT_PARAMS = {}


def _init_params(max_len):
    """The JAX trainer's initial params (the port starts from them)."""
    if max_len not in _INIT_PARAMS:
        _, tr, _ = _make("jax", max_len, carry=False)
        _INIT_PARAMS[max_len] = jax.tree.map(np.asarray, tr.params)
    return _INIT_PARAMS[max_len]


def _make(pkg, max_len=4, seed=0, carry=True):
    """(store, trainer, box) of one package, the box with an "auc"
    metric; the port's params are the JAX trainer's initial ones."""
    if pkg == "jax":
        store = JaxStore(JaxCfg(dim=EMB_DIM, optimizer="adagrad",
                                learning_rate=0.05))
        schema = JaxSchema.ctr(num_sparse=NUM_SLOTS, num_float=DENSE_DIM,
                               batch_size=BATCH, max_len=max_len)
        tr = JaxTrainer(JaxDeepFM(num_slots=NUM_SLOTS, emb_dim=EMB_DIM,
                                  dense_dim=DENSE_DIM, hidden=HIDDEN),
                        store, schema, make_mesh(1),
                        JaxTrainerConfig(global_batch_size=BATCH,
                                         auc_buckets=AUC_BUCKETS),
                        seed=seed)
        box = JaxBoxPS(store)
    else:
        store = HostEmbeddingStore(EmbeddingConfig(
            dim=EMB_DIM, optimizer="adagrad", learning_rate=0.05))
        schema = DataFeedSchema.ctr(num_sparse=NUM_SLOTS,
                                    num_float=DENSE_DIM, batch_size=BATCH,
                                    max_len=max_len)
        tr = Trainer(DeepFMModel(NUM_SLOTS, EMB_DIM, DENSE_DIM,
                                 hidden=HIDDEN), store, schema,
                     TrainerConfig(global_batch_size=BATCH,
                                   auc_buckets=AUC_BUCKETS),
                     seed=seed, device="cpu")
        if carry:
            weights.load_deepfm_params(tr.model, _init_params(max_len))
        box = BoxPS(store)
    box.init_metric("auc", n_buckets=AUC_BUCKETS)
    return store, tr, box


def _ckpt(pkg, root):
    return (PassCheckpointer if pkg == "port" else JaxCkpt)(
        root, keep_last_n=3, base_every=2)


def _store_state(store):
    keys = store._keys[:store._n].copy()
    return keys, store.get_rows(keys)


def _dense_state(pkg, tr) -> dict:
    """{tree path: array} of the dense params and optimizer state."""
    if pkg == "port":
        return {p: np.asarray(x) for p, x in flatten_tree(tr.dense_state())}
    tree = {"params": tr.params, "opt_state": tr.opt_state}
    return {_path_str(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _metric_state(box) -> dict:
    return {k: np.array(v.cpu() if torch.is_tensor(v) else v)
            for k, v in box.metrics.get_state("auc").items()}


def _params(pkg, tr):
    if pkg == "port":
        return weights.deepfm_params(tr.model)
    return jax.tree.map(np.asarray, tr.params)


def _state(pkg, store, tr, box) -> dict:
    return {"store": _store_state(store), "dense": _dense_state(pkg, tr),
            "metrics": _metric_state(box), "global_step": tr.global_step,
            "params": _params(pkg, tr)}


def _train(pkg, store, tr, box, ckpt, p, **kw):
    ds = _dataset(pkg, tr, p)
    box.set_date(20261016)
    box.begin_pass()
    out = tr.train_pass(ds, metrics=box.metrics, **kw)
    box.end_pass(checkpointer=ckpt, trainer=tr, dataset=ds)
    return out


@pytest.fixture(scope="module")
def lives(tmp_path_factory):
    """Three checkpointed passes in each package; the state after pass 2
    and after pass 3, the pass stats, and the snapshot root."""
    out = {}
    for pkg in ("jax", "port"):
        root = str(tmp_path_factory.mktemp(f"live_{pkg}"))
        store, tr, box = _make(pkg)
        ckpt = _ckpt(pkg, root)
        run = {"root": root, "stats": []}
        for p in (1, 2, 3):
            run["stats"].append(_train(pkg, store, tr, box, ckpt, p))
            run[p] = _state(pkg, store, tr, box)
        out[pkg] = run
    return out


def _assert_params(got, want):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, **MLP_TOL)


def test_lifecycle_matches_reference(lives):
    """Both packages' live runs agree pass by pass, and each wrote a
    base, a delta, then a new chain's base."""
    for pkg in ("port", "jax"):
        names = sorted(os.listdir(lives[pkg]["root"]))
        assert names == ["chain-0001", "chain-0002", "pass-00001",
                         "pass-00002", "pass-00003"], (pkg, names)
        assert sorted(os.listdir(os.path.join(lives[pkg]["root"],
                                              "chain-0001"))) == [
            "MANIFEST.json", "base.npz", "delta-00001.npz", "meta.json"]
    for sp, sj in zip(lives["port"]["stats"], lives["jax"]["stats"]):
        assert sp["steps"] == sj["steps"] == STEPS
        np.testing.assert_allclose(sp["loss_mean"], sj["loss_mean"],
                                   **LOSS_TOL)
    kp, rp = lives["port"][3]["store"]
    kj, rj = lives["jax"][3]["store"]
    np.testing.assert_array_equal(kp, kj)
    np.testing.assert_allclose(rp, rj, **TABLE_TOL)
    _assert_params(lives["port"][3]["params"], lives["jax"][3]["params"])
    # the metric registry accumulated the same three passes: the same
    # label totals, bucketed alike up to preds on a bucket edge
    mp, mj = lives["port"][3]["metrics"], lives["jax"][3]["metrics"]
    for k in ("pos", "neg"):
        assert mp[k].sum() == mj[k].sum()
        assert np.abs(mp[k] - mj[k]).sum() <= 0.01 * mj[k].sum()


@pytest.mark.parametrize("writer,resumer", [("port", "port"),
                                            ("jax", "port"),
                                            ("port", "jax")])
def test_resume_then_continue(lives, tmp_path, writer, resumer):
    """Resume pass 2 from ``writer``'s root in a fresh ``resumer`` job:
    every plane bit-equal to the writer's live state after pass 2; then
    pass 3 matches the uninterrupted JAX pass 3."""
    root = str(tmp_path / "root")
    shutil.copytree(lives[writer]["root"], root)
    shutil.rmtree(os.path.join(root, "pass-00003"))   # died before it
    store, tr, box = _make(resumer, seed=123)
    ckpt = _ckpt(resumer, root)
    cursor = tr.resume(ckpt, box=box)
    live2 = lives[writer][2]
    assert cursor["pass_id"] == 2 and box.pass_id == 2
    assert cursor["global_step"] == live2["global_step"] == 2 * STEPS
    assert cursor["date"] == 20261016 and cursor["mid_steps"] == 0
    assert cursor["shuffle_state"]["bit_generator"] == "PCG64"
    assert tr.global_step == 2 * STEPS
    got = _state(resumer, store, tr, box)
    np.testing.assert_array_equal(got["store"][0], live2["store"][0])
    np.testing.assert_array_equal(got["store"][1], live2["store"][1])
    assert sorted(got["dense"]) == sorted(live2["dense"])
    for k, v in live2["dense"].items():
        assert got["dense"][k].dtype == v.dtype, k
        np.testing.assert_array_equal(got["dense"][k], v, err_msg=k)
    for k, v in live2["metrics"].items():
        np.testing.assert_array_equal(got["metrics"][k], v, err_msg=k)
    # pass 3 from the resumed state against the uninterrupted JAX run
    out = _train(resumer, store, tr, box, ckpt, 3)
    ref = lives["jax"]
    np.testing.assert_allclose(out["loss_mean"],
                               ref["stats"][2]["loss_mean"], **LOSS_TOL)
    keys, rows = _store_state(store)
    np.testing.assert_array_equal(keys, ref[3]["store"][0])
    np.testing.assert_allclose(rows, ref[3]["store"][1], **TABLE_TOL)
    _assert_params(_params(resumer, tr), ref[3]["params"])
    # the resumed job's pass-3 save continues the snapshot sequence
    assert box.pass_id == 3
    assert ckpt.intact_cursors() == [(1, 0), (2, 0), (3, 0)]


@pytest.mark.parametrize("resumer", ["port", "jax"])
def test_torn_newest_snapshot_falls_back(lives, tmp_path, resumer):
    root = str(tmp_path / "root")
    shutil.copytree(lives["port"]["root"], root)
    dense = os.path.join(root, "pass-00003", "dense.npz")
    raw = open(dense, "rb").read()
    open(dense, "wb").write(raw[:len(raw) // 2])
    store, tr, box = _make(resumer, seed=7)
    with pytest.warns(UserWarning, match="pass-00003.*falling back"):
        cursor = tr.resume(_ckpt(resumer, root), box=box)
    assert cursor["pass_id"] == 2
    np.testing.assert_array_equal(_store_state(store)[1],
                                  lives["port"][2]["store"][1])


_KILLED = """
import sys
import numpy as np
sys.path.insert(0, {repo!r})
from tests.test_torch_resume import _make, _ckpt, _train
store, tr, box = _make("port", carry=False)
ckpt = _ckpt("port", {root!r})
for p in (1, 2):
    _train("port", store, tr, box, ckpt, p)
print("not reached")
"""


def test_save_killed_before_manifest_is_invisible(tmp_path):
    """A process killed at pass_ckpt.pre_manifest during its second save:
    the torn snapshot is skipped and resume lands on pass 1."""
    root = str(tmp_path / "root")
    env = dict(os.environ, PBTPU_FAULTPOINT="pass_ckpt.pre_manifest",
               PBTPU_FAULTPOINT_AFTER="1", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c",
                        _KILLED.format(repo=REPO, root=root)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 137, r.stderr[-2000:]
    assert "FAULTPOINT KILL pass_ckpt.pre_manifest" in r.stderr
    assert os.path.isdir(os.path.join(root, "pass-00002"))
    assert not os.path.exists(os.path.join(root, "pass-00002",
                                           "MANIFEST.json"))
    store, tr, box = _make("port", carry=False, seed=5)
    with pytest.warns(UserWarning, match="pass-00002"):
        cursor = tr.resume(_ckpt("port", root), box=box)
    assert cursor["pass_id"] == 1 and tr.global_step == STEPS


def test_port_resumes_a_jax_midpass_snapshot(tmp_path):
    """A JAX snapshot taken mid-pass (mid_steps 3 of pass 2) resumes in
    the port through train_pass(skip_steps=3); the rest of the pass
    matches the uninterrupted JAX pass at the golden tolerances."""
    root = str(tmp_path / "root")
    jstore, jtr, jbox = _make("jax")
    jck = _ckpt("jax", root)
    jtr.enable_midpass_snapshots(jck, 3, jbox, metrics=jbox.metrics)
    _train("jax", jstore, jtr, jbox, jck, 1)
    jout = _train("jax", jstore, jtr, jbox, jck, 2)
    assert os.path.isdir(os.path.join(root, "pass-00001.mid00003"))
    # died in pass 2 after its 3rd step: drop every later snapshot
    for n in os.listdir(root):
        if n.startswith("pass-") and n > "pass-00001.mid00003":
            shutil.rmtree(os.path.join(root, n))
    store, tr, box = _make("port", seed=9)
    cursor = tr.resume(_ckpt("port", root), box=box)
    assert cursor["pass_id"] == 1 and cursor["mid_steps"] == 3
    assert tr.global_step == STEPS + 3
    # the port writes mid-pass snapshots too: the resumed state saved
    # again lands under the same name and cursor
    again = PassCheckpointer(str(tmp_path / "x")).save(tr, box=box,
                                                       mid_steps=3)
    assert os.path.basename(again) == "pass-00001.mid00003"
    with open(os.path.join(again, "MANIFEST.json")) as f:
        again_cursor = json.load(f)["cursor"]
    assert again_cursor["pass_id"] == 1 and again_cursor["mid_steps"] == 3
    assert again_cursor["global_step"] == STEPS + 3
    ds = _dataset("port", tr, 2)
    box.begin_pass()
    out = tr.train_pass(ds, metrics=box.metrics,
                        skip_steps=cursor["mid_steps"])
    assert out["steps"] == STEPS - 3 and tr.global_step == 2 * STEPS
    keys, rows = _store_state(store)
    jkeys, jrows = _store_state(jstore)
    order = np.argsort(jkeys)
    pos = np.searchsorted(jkeys[order], keys)
    np.testing.assert_array_equal(jkeys[order][pos], keys)
    np.testing.assert_allclose(rows, jrows[order][pos], **TABLE_TOL)
    _assert_params(_params("port", tr), _params("jax", jtr))
    assert np.isfinite(jout["loss_mean"])


@pytest.mark.parametrize("max_len", [1, 4])
def test_eval_pass_matches_reference(max_len):
    """eval_pass after one training pass in both packages: the same AUC
    over every example (the tail batch padded and masked), and the store
    neither grown nor dirtied."""
    outs, trainers = {}, {}
    for pkg in ("jax", "port"):
        store, tr, box = _make(pkg, max_len=max_len)
        trainers[pkg] = tr
        tr.train_pass(_dataset(pkg, tr, 1, max_len))
        n_keys, dirty = len(store), store._dirty[:store._n].copy()
        # 5 full batches and a tail of 7, keys partly unseen in training
        ev = tr.eval_pass(_dataset(pkg, tr, 3, max_len, n=5 * BATCH + 7))
        assert len(store) == n_keys, pkg
        np.testing.assert_array_equal(store._dirty[:store._n], dirty)
        outs[pkg] = ev
    # the multi-hot eval pulls through gather_pool, as training does
    assert trainers["port"].pull_engine == trainers["jax"].pull_engine == (
        "fused_gather_pool" if max_len > 1 else "gather_seqpool")
    assert outs["port"]["size"] == outs["jax"]["size"] == 5 * BATCH + 7
    assert outs["port"]["examples"] == 5 * BATCH + 7
    assert outs["port"]["steps"] == 6
    assert abs(outs["port"]["auc"] - outs["jax"]["auc"]) < 1e-3
    for k in ("mae", "rmse", "predicted_ctr", "actual_ctr"):
        np.testing.assert_allclose(outs["port"][k], outs["jax"][k],
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_foreign_save_forces_a_base(tmp_path):
    """A FleetUtil delta on the checkpointed store consumes its dirty
    rows: the checkpointer's next snapshot must be a base."""
    store, tr, box = _make("port", carry=False)
    ckpt = _ckpt("port", str(tmp_path / "snap"))
    ckpt.base_every = 8
    _train("port", store, tr, box, ckpt, 1)
    _train("port", store, tr, box, ckpt, 2)
    assert ckpt.last_save["rotated"] is False
    FleetUtil(str(tmp_path / "fleet")).save_delta_model(
        store, tr.eval_params(), 20261016, 2)
    _train("port", store, tr, box, ckpt, 3)
    assert ckpt.last_save["rotated"] is True
    assert ckpt.last_save["sparse_member"] == "base.npz"


def test_end_pass_refuses_publisher_and_remote_resume(tmp_path):
    """The remote resume half is parity, not a refusal: the name stays
    from when the port refused it. Publishing is ported: end_pass
    refuses a publisher without the trainer whose dense params it
    publishes, and a publisher that fails degrades to {"error": ...}
    with a warning instead of raising. ``resume(collectives=)`` on a
    world of one is the plain resume, as in the JAX package
    (tests/test_torch_resilience.py runs the coordinated one)."""
    store, tr, box = _make("port", carry=False)
    box.begin_pass()
    with pytest.raises(ValueError, match="needs trainer"):
        box.end_pass(publisher=object())
    box.begin_pass()
    with pytest.warns(UserWarning, match="publish failed"):
        out = box.end_pass(publisher=object(), trainer=tr)
    assert "error" in out["publish"]
    from paddlebox_tpu_torch.distributed import FileStore, HostCollectives
    col = HostCollectives(FileStore(str(tmp_path / "store")), 0, 1)
    assert tr.resume(_ckpt("port", str(tmp_path / "none")),
                     collectives=col) is None
    jstore, jtr, jbox = _make("jax", carry=False)
    assert jtr.resume(_ckpt("jax", str(tmp_path / "jnone")),
                      collectives=col) is None


def test_shuffle_state_replays_the_same_permutations():
    """The shuffle cursor is the same JSON dict in both packages: a port
    dataset seeded otherwise, set to the reference's recorded state,
    draws the reference's permutations from then on."""
    kw = dict(num_sparse=NUM_SLOTS, num_float=DENSE_DIM, max_len=4)
    schema, jschema = DataFeedSchema.ctr(**kw), JaxSchema.ctr(**kw)
    port = SlotDataset(schema, seed=5)
    port.records = _records("port", schema, 64, 1, 4)
    ref = JaxDataset(jschema)
    ref.records = _records("jax", jschema, 64, 1, 4)
    assert port.shuffle_state() != ref.shuffle_state()
    port.set_shuffle_state(json.loads(json.dumps(ref.shuffle_state())))
    assert port.shuffle_state() == ref.shuffle_state()
    for _ in range(2):
        port.local_shuffle()
        ref.local_shuffle()
        for a, b in zip(port.records.sparse_values,
                        ref.records.sparse_values):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(port.records.float_values[0],
                                      ref.records.float_values[0])
