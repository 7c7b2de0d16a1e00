"""The port's six dense optimizers against the JAX package's, and their
state across the packages.

- adam, sgd, momentum, adagrad, rmsprop and ftrl, each with its default
  and with non-default keywords (``TrainerConfig.dense_optimizer_kwargs``),
  over 5 steps on a DCNv2 parameter tree against the transforms the JAX
  package's ``train.optimizers.make`` builds (optax, and its own ftrl):
  params and every optimizer-state leaf, named as ``save_pytree`` names
  them, at rtol 1e-6 / atol 1e-7;
- a ``PassCheckpointer`` snapshot written by one package's Trainer
  (DCNv2 + momentum, MMoE + ftrl) resumes in the other's to bit-equal
  dense params and optimizer state, both ways.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from paddlebox_tpu import models as jmodels
from paddlebox_tpu.data import DataFeedSchema as JaxSchema
from paddlebox_tpu.data import SlotDataset as JaxDataset
from paddlebox_tpu.embedding import EmbeddingConfig as JaxCfg
from paddlebox_tpu.embedding import HostEmbeddingStore as JaxStore
from paddlebox_tpu.fleet.boxps import BoxPS as JaxBoxPS
from paddlebox_tpu.parallel import make_mesh
from paddlebox_tpu.train import Trainer as JaxTrainer
from paddlebox_tpu.train import TrainerConfig as JaxTrainerConfig
from paddlebox_tpu.train import optimizers as jax_optimizers
from paddlebox_tpu.utils.checkpoint import _path_str
from paddlebox_tpu.utils.pass_ckpt import PassCheckpointer as JaxCkpt

from paddlebox_tpu_torch import models, weights
from paddlebox_tpu_torch.data import DataFeedSchema, SlotDataset
from paddlebox_tpu_torch.embedding import EmbeddingConfig, HostEmbeddingStore
from paddlebox_tpu_torch.fleet import BoxPS
from paddlebox_tpu_torch.train import Trainer, TrainerConfig, optimizers
from paddlebox_tpu_torch.utils.checkpoint import flatten_tree
from paddlebox_tpu_torch.utils.pass_ckpt import PassCheckpointer

from tests.test_torch_zoo import WIDTHS, _records

torch.set_num_threads(1)

OPT_TOL = dict(rtol=1e-6, atol=1e-7)
S, DENSE, DIM = 3, 2, 4

KWARGS = {
    "adam": [{}, dict(b1=0.8, b2=0.99, eps=1e-6, eps_root=1e-9),
             dict(nesterov=True)],
    "sgd": [{}, dict(momentum=0.5, nesterov=True)],
    "momentum": [{}, dict(momentum=0.7, nesterov=True)],
    "adagrad": [{}, dict(initial_accumulator_value=0.5, eps=1e-5)],
    "rmsprop": [{}, dict(decay=0.95, eps=1e-6, initial_scale=0.1,
                         eps_in_sqrt=False),
                dict(momentum=0.9, nesterov=True)],
    "ftrl": [{}, dict(l1=0.01, l2=0.1, beta=0.5)],
}
CASES = [(n, i) for n, kws in KWARGS.items() for i in range(len(kws))]


def _as_dicts(t):
    """optax's state tree with its namedtuples as dicts of their fields
    (flatten_tree names dict keys as save_pytree names namedtuple
    fields)."""
    if hasattr(t, "_asdict"):
        return {k: _as_dicts(v) for k, v in t._asdict().items()}
    if isinstance(t, (tuple, list)):
        return type(t)(_as_dicts(v) for v in t)
    if isinstance(t, dict):
        return {k: _as_dicts(v) for k, v in t.items()}
    return np.asarray(t)


def _flat(t) -> dict:
    return {p: np.asarray(v) for p, v in flatten_tree(t)}


@pytest.mark.parametrize("name,which", CASES,
                         ids=[f"{n}-{i}" for n, i in CASES])
def test_dense_optimizer_matches_reference(name, which):
    kw = KWARGS[name][which]
    jm = jmodels.DCNv2Model(S, DIM, DENSE, **WIDTHS["dcn_v2"])
    pm = models.DCNv2Model(S, DIM, DENSE, **WIDTHS["dcn_v2"])
    params = jm.init(jax.random.PRNGKey(0))
    weights.load_model_params(pm, jax.tree.map(np.asarray, params))
    lr = 0.02
    tx = jax_optimizers.make(name, lr, **dict(kw))
    state = tx.init(params)
    opt = optimizers.make(name, lr, list(pm.parameters()), **dict(kw))
    rng = np.random.default_rng(len(name) + which)
    for _ in range(5):
        g = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(
            np.float32), params)
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, upd)
        opt.step([torch.from_numpy(a) for a in weights.leaves(pm, g)])
    got = _flat(weights.dense_state(pm, opt))
    want = _flat({"params": jax.tree.map(np.asarray, params),
                  "opt_state": _as_dicts(state)})
    assert sorted(got) == sorted(want)
    for p in want:
        assert got[p].dtype == want[p].dtype, p
        np.testing.assert_allclose(got[p], want[p], err_msg=p, **OPT_TOL)


def test_unported_options_raise():
    p = [torch.zeros(3)]
    with pytest.raises(NotImplementedError, match="centered"):
        optimizers.make("rmsprop", 0.1, p, centered=True)
    with pytest.raises(ValueError, match="adam\\|sgd\\|momentum"):
        optimizers.make("lamb", 0.1, p)
    with pytest.raises(TypeError):
        optimizers.make("adagrad", 0.1, p, momentum=0.9)


# ---------------------------------------------------------------------------
# PassCheckpointer snapshots across the packages
# ---------------------------------------------------------------------------

BATCH, STEPS = 16, 3


def _make(pkg, name, optimizer):
    kw = dict(global_batch_size=BATCH, auc_buckets=1 << 10,
              dense_optimizer=optimizer, dense_lr=0.01)
    ecfg = dict(dim=DIM, optimizer="adagrad", learning_rate=0.05)
    if pkg == "jax":
        store = JaxStore(JaxCfg(**ecfg))
        schema = JaxSchema.ctr(num_sparse=S, num_float=DENSE,
                               batch_size=BATCH, max_len=2)
        tr = JaxTrainer(jmodels.MODEL_REGISTRY[name](S, DIM, DENSE,
                                                     **WIDTHS[name]),
                        store, schema, make_mesh(1), JaxTrainerConfig(**kw))
        return store, tr, JaxBoxPS(store)
    store = HostEmbeddingStore(EmbeddingConfig(**ecfg))
    schema = DataFeedSchema.ctr(num_sparse=S, num_float=DENSE,
                                batch_size=BATCH, max_len=2)
    tr = Trainer(models.MODEL_REGISTRY[name](S, DIM, DENSE, **WIDTHS[name]),
                 store, schema, TrainerConfig(**kw), device="cpu")
    return store, tr, BoxPS(store)


def _dense(pkg, tr) -> dict:
    if pkg == "port":
        return _flat(tr.dense_state())
    tree = {"params": tr.params, "opt_state": tr.opt_state}
    return {_path_str(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("name,optimizer", [("dcn_v2", "momentum"),
                                            ("mmoe", "ftrl")])
def test_pass_checkpoint_resumes_across_packages(tmp_path, name, optimizer,
                                                 writer):
    """Two checkpointed passes in ``writer``; a fresh trainer of the other
    package resumes the snapshot root to the writer's dense params and
    optimizer state, bit for bit, and its store to the writer's rows."""
    resumer = "port" if writer == "jax" else "jax"
    root = str(tmp_path / "root")
    store, tr, box = _make(writer, name, optimizer)
    ckpt = (PassCheckpointer if writer == "port" else JaxCkpt)(root)
    ds_cls = SlotDataset if writer == "port" else JaxDataset
    for p in (1, 2):
        ds = ds_cls(tr.schema)
        ds.records = _records(writer, tr.schema, STEPS * BATCH, p, 2)
        box.set_date(20261017)
        box.begin_pass()
        tr.train_pass(ds)
        box.end_pass(checkpointer=ckpt, trainer=tr, dataset=ds)
    live = _dense(writer, tr)
    keys = np.sort(store._keys[:store._n].copy())
    rows = store.get_rows(keys)
    assert any(k.startswith("opt_state/") for k in live)

    copy = str(tmp_path / "copy")
    shutil.copytree(root, copy)
    assert sorted(os.listdir(copy))[-1] == "pass-00002"
    rstore, rtr, rbox = _make(resumer, name, optimizer)
    cursor = rtr.resume((PassCheckpointer if resumer == "port"
                         else JaxCkpt)(copy), box=rbox)
    assert cursor["pass_id"] == 2
    got = _dense(resumer, rtr)
    assert sorted(got) == sorted(live)
    for k, v in live.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    np.testing.assert_array_equal(rstore.get_rows(keys), rows)
