"""The slice as a whole: ``Trainer(mesh=...)`` at world 2 and world 4.

A world of port ranks (tests/torch_multirank_worker.py, no JAX) is
started through the port's own launcher over gloo on the CPU, once per
module and world. Each rank iterates the same global batches and trains
its slice; the JAX Trainer runs the same recipe on a same-shape mesh in
this process (``make_mesh(2)``; ``make_mesh(4, num_nodes=2)`` for world
4, whose sharded push is the two-stage hier exchange), from the same
initial dense parameters and data. Held at
the JAX multi-host test's bars (tests/test_multihost_train.py): loss
``rel=2e-5``, AUC ``abs=2e-4``; the flushed host stores of all ranks
together agree with the JAX store row for row.

Recipes: the "single" and "sharded" table layouts on a multi-hot DeepFM
(push overlap on, as by default; the sharded one pools through
``gather_pool`` on the received lanes), the sharded layout over a
4-shard ``ShardedEmbeddingStore`` whose shards the two ranks own
(``Trainer.set_shard_ownership``: a rank builds and holds only its
shards' keys; its second pass consumes rows staged by
``train_pass(preload_keys=)``), and kstep dense sync
(``param_sync_step`` 2) on a one-hot DeepFM. World 4: a skewed pass at
capacity factor 1.0 must drop tokens, count them in
``exchange.overflow_dropped``, warn, double the factor and train the
next pass losslessly; a fresh trainer's eval pass must retry in place
and return a lossless run (tests/test_exchange.py's
test_overflow_never_silent_and_retry; the factor starts at 1.0 because
the port's shards are hash-balanced, where the JAX layout's contiguous
ranges overflow at 2.0).
"""

import numpy as np
import pytest
import torch

import jax

import torch_multirank_common as common
from torch_multirank_spawn import run_world
from paddlebox_tpu.config import set_flags
from paddlebox_tpu.data import DataFeedSchema as JaxSchema
from paddlebox_tpu.data import SlotDataset as JaxDataset
from paddlebox_tpu.data import slot_record as jax_slot_record
from paddlebox_tpu.embedding import EmbeddingConfig as JaxCfg
from paddlebox_tpu.embedding import HostEmbeddingStore as JaxStore
from paddlebox_tpu.models import DeepFMModel as JaxDeepFM
from paddlebox_tpu.parallel import make_mesh
from paddlebox_tpu.train import Trainer as JaxTrainer
from paddlebox_tpu.train import TrainerConfig as JaxTrainerConfig

from paddlebox_tpu_torch.utils import checkpoint as ckpt_lib

torch.set_num_threads(1)

RECIPES4 = [
    {"name": "single4", "layout": "single", "max_len": 2},
    {"name": "sharded4", "layout": "sharded", "max_len": 2},
]
RECIPES = [
    {"name": "single", "layout": "single", "max_len": 2},
    {"name": "sharded", "layout": "sharded", "max_len": 2},
    {"name": "owned", "layout": "sharded", "max_len": 2, "n_shards": 4,
     "preload": True},
    {"name": "kstep", "layout": "single", "max_len": 1,
     "dense_sync_mode": "kstep", "param_sync_step": 2},
]


def _jax_trainer(rc: dict, world: int = 2):
    schema = JaxSchema.ctr(num_sparse=common.NUM_SLOTS,
                           num_float=common.DENSE_DIM,
                           batch_size=common.BATCH, max_len=rc["max_len"])
    ds = JaxDataset(schema)
    ds.records = common.make_records(jax_slot_record, schema,
                                     common.dataset_arrays(rc["max_len"]))
    store = JaxStore(JaxCfg(dim=common.DIM, learning_rate=common.SPARSE_LR))
    cfg = JaxTrainerConfig(
        global_batch_size=common.BATCH, dense_lr=common.DENSE_LR,
        auc_buckets=common.AUC_BUCKETS,
        dense_sync_mode=rc.get("dense_sync_mode", "allreduce"),
        param_sync_step=rc.get("param_sync_step", 1))
    set_flags(table_layout=rc["layout"], exchange_wire="f32")
    try:
        tr = JaxTrainer(JaxDeepFM(num_slots=common.NUM_SLOTS,
                                  emb_dim=common.DIM,
                                  dense_dim=common.DENSE_DIM,
                                  hidden=common.HIDDEN),
                        store, schema,
                        make_mesh(world, num_nodes=1 if world == 2 else 2),
                        cfg, seed=0)
    finally:
        set_flags(table_layout="auto", exchange_wire="auto")
    return tr, ds, store


def _jax_run(tr, ds, store) -> dict:
    res = {}
    for p in range(common.PASSES):
        r = tr.train_pass(ds)
        for k in ("loss_first", "loss_mean", "auc", "steps",
                  "routed_dropped"):
            res[f"pass{p}_{k}"] = r[k]
    ev = tr.eval_pass(ds)
    res["eval_auc"] = ev["auc"]
    tr.flush_sparse()
    return res


def _world(work, world: int, recipes: list, phases: list):
    """The JAX trainers of ``recipes`` on a same-shape mesh (their initial
    dense parameters written for the ranks), the world of port ranks,
    then the JAX runs."""
    jax_side = {}
    for rc in recipes:
        tr, ds, store = _jax_trainer(rc, world)
        params = jax.tree.map(np.asarray, tr.eval_params())
        ckpt_lib.save_tree(params, str(work / f"params_{rc['name']}.npz"))
        jax_side[rc["name"]] = (tr, ds, store)
    infos, arrays = run_world(str(work), world, phases,
                              num_nodes=1 if world == 2 else 2,
                              recipes=recipes)
    ref = {name: (_jax_run(*t), t[2]) for name, t in jax_side.items()}
    return infos, arrays, ref


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _world(tmp_path_factory.mktemp("world2"), 2, RECIPES, ["train"])


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """World 4 on a (2, 2) mesh: the recipes (the sharded layout's push
    is the two-stage hier exchange there), then the overflow case."""
    return _world(tmp_path_factory.mktemp("world4"), 4, RECIPES4,
                  ["train", "overflow"])


def _run(world2, world4, name):
    return world4 if name.endswith("4") else world2


@pytest.mark.parametrize("name", [rc["name"] for rc in RECIPES + RECIPES4])
def test_matches_jax_mesh(world2, world4, name):
    infos, arrays, ref = _run(world2, world4, name)
    want, jstore = ref[name]
    got = infos[0][name]
    rc = next(r for r in RECIPES + RECIPES4 if r["name"] == name)
    assert got["table_layout"] == rc["layout"]
    # every rank reduced the same world numbers
    for other in infos[1:]:
        assert other[name] == got
    for p in range(common.PASSES):
        assert got[f"pass{p}_steps"] == want[f"pass{p}_steps"] == \
            common.N_EXAMPLES // common.BATCH
        assert got[f"pass{p}_routed_dropped"] == 0
        for k in ("loss_first", "loss_mean"):
            assert got[f"pass{p}_{k}"] == pytest.approx(
                want[f"pass{p}_{k}"], rel=common.LOSS_REL), (p, k)
        assert got[f"pass{p}_auc"] == pytest.approx(
            want[f"pass{p}_auc"], abs=common.AUC_ABS)
    assert got["eval_auc"] == pytest.approx(want["eval_auc"],
                                            abs=common.AUC_ABS)
    assert got["eval_examples"] == common.N_EXAMPLES
    assert got["eval_dropped"] == 0
    # training moved
    assert got["pass1_loss_mean"] < got["pass0_loss_mean"]
    assert got["pass1_auc"] > 0.6


@pytest.mark.parametrize("name", [rc["name"] for rc in RECIPES + RECIPES4])
def test_stores_match_jax_store(world2, world4, name):
    """The ranks' stores are disjoint (each holds the keys it owns) and
    together hold the JAX store's keys and rows."""
    infos, arrays, ref = _run(world2, world4, name)
    _, jstore = ref[name]
    keys = [a[f"{name}_keys"] for a in arrays]
    allk = np.concatenate(keys)
    assert len(np.unique(allk)) == len(allk)
    if name == "owned":
        # each rank's store holds exactly its own shards' keys
        from paddlebox_tpu_torch.embedding.store import splitmix_shard
        for rank, k in enumerate(keys):
            assert (splitmix_shard(k, 4) % 2 == rank).all()
    rows = np.concatenate([a[f"{name}_rows"] for a in arrays])
    assert len(allk) == len(jstore)
    np.testing.assert_allclose(rows, jstore.get_rows(allk),
                               **common.TABLE_TOL)


def test_ranks_import_no_jax(world2, world4):
    for (infos, _, _), w in ((world2, 2), (world4, 4)):
        assert all(not i["jax_loaded"] for i in infos)
        assert [i["world"] for i in infos] == [w] * w
    assert world4[0][0]["shape"] == [2, 2]


def test_world2_kstep_ends_synced(world2):
    """kstep's end-of-pass sync leaves every rank with the same dense
    parameters; allreduce keeps them equal every step."""
    _, arrays, _ = world2
    for name in ("kstep", "single", "sharded", "owned"):
        np.testing.assert_array_equal(arrays[0][f"{name}_dense"],
                                      arrays[1][f"{name}_dense"])


def test_world4_overflow_never_silent_and_retry(world4):
    infos, _, _ = world4
    for info in infos:
        o = info["overflow"]
        assert o["pass0_dropped"] > 0 and o["pass0_warned"]
        # every rank counts the world's drops
        assert o["counter_dropped"] == o["pass0_dropped"]
        assert o["factor_after"] == 2.0
        assert o["pass1_dropped"] == 0
        assert o["eval_dropped"] == 0 and o["eval_retries"] > 0
        assert o["eval_examples"] == 4 * common.BATCH
    assert len({i["overflow"]["pass0_dropped"] for i in infos}) == 1
