"""The port's persistence formats against the JAX package's, both ways:

- ``atomic_file``: an injected fault before the rename leaves the old
  file whole; a flipped byte is named by both packages' manifest
  verifiers;
- the store chain (a base, two deltas, a shrink with tombstones and a
  re-add): the same operations give the same arrays in every file, and
  ``load`` in the other package gives the same key → row map exactly;
- the dense (params + adam state) and metrics npz written by one package
  load in the other bit-exactly, adam's ``count`` a 0-d int32;
- ``MetricRegistry``'s four methods and the phase gate;
- a ``FleetUtil`` root written by one package ``load_model``-ed by the
  other; ``BoxPS``'s delta save, shrink and phase flip;
- remote roots raise the named not-ported error.

Small sizes (a few hundred keys, dim 4-8); no trainer is built here
(tests/test_torch_resume.py drives the trainers).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import optax

from paddlebox_tpu.embedding import EmbeddingConfig as JaxCfg
from paddlebox_tpu.embedding import HostEmbeddingStore as JaxStore
from paddlebox_tpu.fleet.fleet_util import FleetUtil as JaxFleetUtil
from paddlebox_tpu.metrics.metric import MetricRegistry as JaxRegistry
from paddlebox_tpu.models import DeepFMModel as JaxDeepFM
from paddlebox_tpu.utils import checkpoint as jax_ckpt
from paddlebox_tpu.utils import faultpoint as jax_faultpoint

from paddlebox_tpu_torch import weights
from paddlebox_tpu_torch.embedding import EmbeddingConfig, HostEmbeddingStore
from paddlebox_tpu_torch.fleet import FleetUtil
from paddlebox_tpu_torch.metrics import MetricRegistry
from paddlebox_tpu_torch.models import DeepFMModel
from paddlebox_tpu_torch.train import optimizers
from paddlebox_tpu_torch.utils import checkpoint as ckpt
from paddlebox_tpu_torch.utils import faultpoint
from paddlebox_tpu_torch.utils.fs import RemoteFSNotPorted
from paddlebox_tpu_torch.utils.pass_ckpt import PassCheckpointer

torch.set_num_threads(1)

S, D, DENSE = 4, 8, 3
HIDDEN = (16, 16)
PKGS = {"port": (HostEmbeddingStore, EmbeddingConfig, ckpt, faultpoint,
                 FleetUtil),
        "jax": (JaxStore, JaxCfg, jax_ckpt, jax_faultpoint, JaxFleetUtil)}
BOTH_WAYS = [("port", "jax"), ("jax", "port")]


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faultpoint.disarm()
    jax_faultpoint.disarm()


def _store(pkg, dim=D):
    store_cls, cfg_cls = PKGS[pkg][:2]
    return store_cls(cfg_cls(dim=dim, optimizer="adagrad",
                             learning_rate=0.05))


def _rows(rng, n, width):
    r = rng.normal(size=(n, width)).astype(np.float32)
    r[:, 0] = rng.integers(0, 10, n)          # show counters 0..9
    return r


def _drive(store, d, stop_after=3):
    """The same operations on either package's store: a base, a delta of
    updates and new keys, then a shrink (decay + eviction) followed by
    re-adding some evicted keys and a second delta. Returns what the
    live store held after each save as {key: row}."""
    rng = np.random.default_rng(3)
    W = store.cfg.row_width
    seen = []

    def snap():
        keys = store._keys[:store._n].copy()
        seen.append(dict(zip(keys.tolist(), store.get_rows(keys))))

    k1 = rng.choice(1 << 40, 200, replace=False).astype(np.uint64)
    store.lookup_or_init(k1)
    upd = k1[rng.random(len(k1)) < 0.6]
    store.write_back(upd, _rows(rng, len(upd), W))
    store.save_base(d, pass_id=1)
    snap()
    if stop_after == 1:
        return seen
    k2 = np.concatenate([k1[:50],
                         rng.choice(1 << 40, 100).astype(np.uint64) | 1])
    store.lookup_or_init(k2)
    upd = k2[rng.random(len(k2)) < 0.5]
    store.write_back(upd, _rows(rng, len(upd), W))
    store.save_delta(d, pass_id=2)
    snap()
    if stop_after == 2:
        return seen
    evicted = store.shrink(min_show=3.0, decay=0.9)
    assert evicted > 0
    k3 = np.concatenate([k1[:120],
                         rng.choice(1 << 40, 30).astype(np.uint64) | 3])
    store.lookup_or_init(k3)              # re-adds evicted keys of k1
    upd = k3[rng.random(len(k3)) < 0.3]
    store.write_back(upd, _rows(rng, len(upd), W))
    store.save_delta(d, pass_id=3)
    snap()
    return seen


def _members(d):
    out = {}
    for name in ("base.npz", "delta-00001.npz", "delta-00002.npz"):
        with np.load(os.path.join(d, name)) as z:
            out[name] = {k: z[k] for k in z.files}
    return out


def _store_map(store):
    keys = store._keys[:store._n].copy()
    return keys, store.get_rows(keys)


def _assert_same_map(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _assert_persisted(got: dict, live: dict, store):
    """What a chain replays against what the live store held: every
    replayed key with its live row exactly; a live key missing from the
    chain is one never written back since it was created, so its row is
    still its deterministic init (fresh keys are not dirty)."""
    assert set(got) <= set(live)
    for k in got:
        np.testing.assert_array_equal(got[k], live[k])
    missing = np.array(sorted(set(live) - set(got)), np.uint64)
    if len(missing):
        np.testing.assert_array_equal(
            np.stack([live[int(k)] for k in missing]),
            store._init_rows(missing))


# ---------------------------------------------------------------------------
# atomic writes and manifests
# ---------------------------------------------------------------------------

def _save_dense(pkg, tree, fname):
    if pkg == "port":
        return ckpt.save_tree(tree, fname)
    return jax_ckpt.save_pytree(tree, fname)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_faultpoint_before_rename_leaves_old_file(tmp_path, pkg):
    fp = PKGS[pkg][3]
    f = str(tmp_path / "dense.npz")
    old = {"a": np.arange(6, dtype=np.float32).reshape(2, 3)}
    _save_dense(pkg, old, f)
    before = open(f, "rb").read()
    fp.arm("ckpt.dense.pre_replace", action="ioerror")
    with pytest.raises(fp.FaultInjected):
        _save_dense(pkg, {"a": np.ones((2, 3), np.float32)}, f)
    assert fp.hit_count("ckpt.dense.pre_replace") >= 1
    assert open(f, "rb").read() == before
    assert os.listdir(tmp_path) == ["dense.npz"]       # no tmp left over


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_delta_killed_before_manifest_replays_previous_save(tmp_path, pkg):
    """A delta file landed but its chain manifest did not: load replays
    the previous save, in both packages, whoever loads."""
    store = _store(pkg)
    d = str(tmp_path / "chain")
    live = _drive(store, d, stop_after=1)
    fp = PKGS[pkg][3]
    fp.arm("store.save_delta.pre_manifest", action="ioerror")
    k = np.array([7, 8, 9], np.uint64)
    store.lookup_or_init(k)
    store.write_back(k, np.ones((3, store.cfg.row_width), np.float32))
    with pytest.raises(fp.FaultInjected):
        store.save_delta(d)
    assert os.path.exists(os.path.join(d, "delta-00001.npz"))
    for loader in ("port", "jax"):
        got = PKGS[loader][0].load(d)
        keys, rows = _store_map(got)
        _assert_persisted(dict(zip(keys.tolist(), rows)), live[0], got)
        assert got.save_seq == 0


@pytest.mark.parametrize("writer,verifier", [(w, v) for w in PKGS
                                             for v in PKGS])
def test_flipped_byte_is_named_by_both_verifiers(tmp_path, writer,
                                                 verifier):
    d = str(tmp_path / "chain")
    _drive(_store(writer), d, stop_after=2)
    lib = PKGS[verifier][2]
    lib.verify_manifest(d)                        # clean before the flip
    f = os.path.join(d, "delta-00001.npz")
    raw = bytearray(open(f, "rb").read())
    raw[len(raw) // 2] ^= 0x40
    open(f, "wb").write(bytes(raw))
    with pytest.raises(lib.CheckpointCorruptError) as e:
        lib.verify_manifest(d)
    assert e.value.fname == f and "crc32" in str(e.value)
    with pytest.raises(lib.CheckpointCorruptError, match="delta-00001"):
        PKGS[verifier][0].load(d)


# ---------------------------------------------------------------------------
# the store chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim", [4, 8])
def test_store_chain_same_arrays_in_both_packages(tmp_path, dim):
    dirs, lives = {}, {}
    for pkg in PKGS:
        dirs[pkg] = str(tmp_path / pkg)
        lives[pkg] = _drive(_store(pkg, dim), dirs[pkg])
    port, ref = _members(dirs["port"]), _members(dirs["jax"])
    for name, arrays in ref.items():
        assert sorted(port[name]) == sorted(arrays), name
        for k, want in arrays.items():
            got = port[name][k]
            assert got.dtype == want.dtype and got.shape == want.shape, \
                (name, k)
            np.testing.assert_array_equal(got, want, err_msg=f"{name}/{k}")
    # the shrink evicted keys and the re-add revived some of them
    assert len(ref["delta-00002.npz"]["removed"]) > 0
    revived = np.isin(ref["delta-00002.npz"]["keys"],
                      ref["base.npz"]["keys"])
    assert revived.any()
    for name in ("meta.json",):
        assert (json.load(open(os.path.join(dirs["port"], name)))
                == json.load(open(os.path.join(dirs["jax"], name))))
    mp = json.load(open(os.path.join(dirs["port"], "MANIFEST.json")))
    mj = json.load(open(os.path.join(dirs["jax"], "MANIFEST.json")))
    for key in ("chain", "save_seq", "num_keys", "pass_id"):
        assert mp[key] == mj[key], key
    assert sorted(mp["files"]) == sorted(mj["files"])
    for pkg in PKGS:
        for i, want in enumerate(lives[pkg]):
            assert sorted(want) == sorted(lives["jax"][i])


@pytest.mark.parametrize("writer,loader", BOTH_WAYS)
def test_store_chain_loads_in_the_other_package(tmp_path, writer, loader):
    d = str(tmp_path / "chain")
    live = _drive(_store(writer), d)
    own = PKGS[writer][0].load(d)
    other = PKGS[loader][0].load(d)
    ko, ro = _store_map(own)
    kx, rx = _store_map(other)
    np.testing.assert_array_equal(kx, ko)          # same replay order
    np.testing.assert_array_equal(rx, ro)
    _assert_persisted(dict(zip(kx.tolist(), rx)), live[-1], other)
    assert other.save_seq == 2 and not other._dirty[:other._n].any()
    # a shorter horizon replays the prefix
    mid = PKGS[loader][0].load(d, upto_seq=1)
    km, rm = _store_map(mid)
    _assert_persisted(dict(zip(km.tolist(), rm)), live[1], mid)


def test_dirty_mask_rules(tmp_path):
    """New keys are not dirty; write_back dirties; a tombstoned key
    re-added is dirty; restore clears the mask — as in the reference."""
    for pkg in PKGS:
        store = _store(pkg)
        k = np.arange(1, 11, dtype=np.uint64)
        store.lookup_or_init(k)
        assert not store._dirty[:store._n].any(), pkg
        rows = store.get_rows(k)
        rows[:, 0] = 5.0
        rows[7:, 0] = 0.0                 # three cold rows
        store.write_back(k[:3], rows[:3])
        assert store._dirty[:store._n].sum() == 3, pkg
        store.write_back(k, rows)
        store.save_base(str(tmp_path / pkg))
        assert not store._dirty[:store._n].any(), pkg
        assert store.shrink(min_show=0.5) == 3
        store.lookup_or_init(k[7:8])                  # revive one
        assert store._dirty[:store._n].sum() == 1, pkg
        store.restore(str(tmp_path / pkg))
        assert len(store) == 10 and not store._dirty[:store._n].any(), pkg


# ---------------------------------------------------------------------------
# dense and metrics npz
# ---------------------------------------------------------------------------

def _jax_dense(seed=0):
    """A JAX-layout dense tree with non-trivial adam state."""
    params = JaxDeepFM(num_slots=S, emb_dim=D, dense_dim=DENSE,
                       hidden=HIDDEN).init(jax.random.PRNGKey(seed))
    opt_state = optax.adam(1e-3).init(params)
    rng = np.random.default_rng(seed)
    mu = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32),
                      params)
    nu = jax.tree.map(lambda p: rng.random(p.shape).astype(np.float32),
                      params)
    adam = opt_state[0]._replace(count=np.asarray(7, np.int32), mu=mu, nu=nu)
    return {"params": jax.tree.map(np.asarray, params),
            "opt_state": (adam, opt_state[1])}


def _port_model():
    model = DeepFMModel(S, D, DENSE, hidden=HIDDEN)
    return model, optimizers.make("adam", 1e-3, list(model.parameters()))


def _to_nested(tree):
    """A JAX dense tree with its adam NamedTuple as a dict, for
    flatten_tree (the member names are the same)."""
    adam, empty = tree["opt_state"]
    return {"params": tree["params"],
            "opt_state": ({"count": adam.count, "mu": adam.mu,
                           "nu": adam.nu}, ())}


def test_jax_dense_npz_loads_in_the_port(tmp_path):
    f = str(tmp_path / "dense.npz")
    want = _jax_dense()
    jax_ckpt.save_pytree(want, f)
    model, opt = _port_model()
    got = ckpt.load_tree(weights.dense_state(model, opt), f)
    weights.load_dense_state(model, opt, got["params"], got["opt_state"])
    back = weights.dense_state(model, opt)
    assert opt.count == 7
    assert back["opt_state"][0]["count"].dtype == np.int32
    assert back["opt_state"][0]["count"].shape == ()
    got_leaves = ckpt.flatten_tree(back)
    want_leaves = ckpt.flatten_tree(_to_nested(want))
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (p, a), (_, b) in zip(got_leaves, want_leaves):
        assert a.dtype == np.asarray(b).dtype, p
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=p)


def test_port_dense_npz_loads_in_jax(tmp_path):
    f = str(tmp_path / "dense.npz")
    want = _jax_dense(seed=1)
    model, opt = _port_model()
    weights.load_dense_state(model, opt, want["params"],
                             _to_nested(want)["opt_state"])
    ckpt.save_tree(weights.dense_state(model, opt), f)
    with np.load(f) as z:
        assert z["opt_state/0/count"].shape == ()
        assert z["opt_state/0/count"].dtype == np.int32
        assert "opt_state/0/mu/mlp/0/w" in z and "params/bias" in z
    template = _jax_dense(seed=2)
    got = jax_ckpt.load_pytree(template, f)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_sgd_dense_state_has_no_optimizer_leaves(tmp_path):
    model = DeepFMModel(S, D, DENSE, hidden=HIDDEN)
    opt = optimizers.make("sgd", 1e-3, list(model.parameters()))
    st = weights.dense_state(model, opt)
    assert [p for p, _ in ckpt.flatten_tree(st)
            if p.startswith("opt_state")] == []
    f = str(tmp_path / "d.npz")
    ckpt.save_tree(st, f)
    params = JaxDeepFM(num_slots=S, emb_dim=D, dense_dim=DENSE,
                       hidden=HIDDEN).init(jax.random.PRNGKey(0))
    jax_ckpt.load_pytree({"params": params,
                          "opt_state": optax.sgd(1e-3).init(params)}, f)


def test_torn_dense_npz_raises_corrupt(tmp_path):
    f = str(tmp_path / "dense.npz")
    model, opt = _port_model()
    ckpt.save_tree(weights.dense_state(model, opt), f)
    raw = open(f, "rb").read()
    open(f, "wb").write(raw[:len(raw) // 2])
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.load_tree(weights.dense_state(model, opt), f)
    ckpt.save_tree({"params": {"bias": np.zeros(2, np.float32)}}, f)
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_tree({"params": {"bias": np.zeros(1, np.float32)}}, f)


def _feed(reg, rng, n_batches=5, bs=64):
    for _ in range(n_batches):
        preds = rng.random(bs).astype(np.float32)
        labels = (rng.random(bs) < 0.3).astype(np.float32)
        cmatch = rng.integers(220, 226, bs).astype(np.int32)
        rank = rng.integers(0, 3, bs).astype(np.int32)
        mask = (rng.random(bs) < 0.5).astype(np.int32)
        scale = rng.random(bs).astype(np.float32) * 2
        if isinstance(reg, MetricRegistry):
            preds, labels = torch.from_numpy(preds), torch.from_numpy(labels)
        reg.add_batch(preds, labels, cmatch=cmatch, rank=rank, mask=mask,
                      sample_scale=scale)


def _registries():
    regs = (MetricRegistry(), JaxRegistry())
    for reg in regs:
        reg.init_metric("plain", n_buckets=1 << 10)
        reg.init_metric("cm", method="cmatch_rank",
                        cmatch_rank_spec="222:1,224", n_buckets=1 << 10)
        reg.init_metric("mask", method="mask", n_buckets=1 << 10)
        reg.init_metric("scale", method="sample_scale", n_buckets=1 << 10)
        reg.init_metric("update_only", phase=0, n_buckets=1 << 10)
    return regs


def test_metric_registry_matches_reference():
    port, ref = _registries()
    for reg in (port, ref):
        _feed(reg, np.random.default_rng(11))
    for name in ref.names():
        want = {k: np.asarray(v) for k, v in ref.get_state(name).items()}
        got = {k: v.numpy() for k, v in port.get_state(name).items()}
        for k in want:
            assert got[k].dtype == np.float32 and got[k].shape == \
                want[k].shape
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-6, err_msg=f"{name}/{k}")
        pm, rm = port.get_metric_msg(name), ref.get_metric_msg(name)
        for k in rm:
            np.testing.assert_allclose(pm[k], rm[k], rtol=1e-5, atol=1e-7,
                                       err_msg=f"{name}: {k}")
    # the phase gate: update_only saw nothing in the join phase
    assert port.get_metric_msg("update_only")["size"] == 0
    port.flip_phase()
    ref.flip_phase()
    for reg in (port, ref):
        _feed(reg, np.random.default_rng(12), n_batches=1)
    assert port.get_metric_msg("update_only")["size"] == \
        ref.get_metric_msg("update_only")["size"] == 64
    port.reset("plain")
    assert port.get_metric_msg("plain")["size"] == 0


@pytest.mark.parametrize("writer,loader", BOTH_WAYS)
def test_metrics_npz_both_ways(tmp_path, writer, loader):
    port, ref = _registries()
    regs = {"port": port, "jax": ref}
    _feed(regs[writer], np.random.default_rng(5))
    f = str(tmp_path / "metrics.npz")
    w = regs[writer]
    tree = {n: w.get_state(n) for n in w.names()}
    if writer == "port":
        ckpt.save_tree(tree, f)
    else:
        jax_ckpt.save_pytree(tree, f)
    r = regs[loader]
    template = {n: r.get_state(n) for n in r.names()}
    got = (ckpt.load_tree(template, f) if loader == "port"
           else jax_ckpt.load_pytree(template, f))
    for n, state in got.items():
        r.set_state(n, state)
        for k, v in tree[n].items():
            a = np.asarray(r.get_state(n)[k])
            b = v.numpy() if torch.is_tensor(v) else np.asarray(v)
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b, err_msg=f"{n}/{k}")
        assert r.get_metric_msg(n) == w.get_metric_msg(n)


# ---------------------------------------------------------------------------
# FleetUtil roots
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,loader", BOTH_WAYS)
def test_fleet_root_both_ways(tmp_path, writer, loader):
    root = str(tmp_path / "fleet")
    store = _store(writer)
    dense = _jax_dense(seed=3)["params"]
    fu = PKGS[writer][4](root)
    rng = np.random.default_rng(9)
    W = store.cfg.row_width
    keys = rng.choice(1 << 40, 150, replace=False).astype(np.uint64)
    store.lookup_or_init(keys)
    store.write_back(keys, _rows(rng, len(keys), W))
    fu.save_model(store, dense, 20261016)
    for p in (1, 2):
        more = rng.choice(1 << 40, 40).astype(np.uint64) | 5
        store.lookup_or_init(more)
        upd = np.concatenate([keys[:20 * p], more])
        store.write_back(upd, _rows(rng, len(upd), W))
        fu.save_delta_model(store, dense, 20261017, p)
    # a torn line in a donefile is skipped with a named warning
    with open(os.path.join(root, "delta_model.donefile"), "a") as f:
        f.write('{"day": 2026\n')
    template = _jax_dense(seed=4)["params"]
    with pytest.warns(UserWarning, match="malformed line"):
        got_store, got_dense, day = PKGS[loader][4](root).load_model(
            template)
    assert day == 20261017
    k, r = _store_map(got_store)
    want_k, want_r = _store_map(store)
    _assert_same_map(dict(zip(k.tolist(), r)),
                     dict(zip(want_k.tolist(), want_r)))
    for a, b in zip(jax.tree.leaves(got_dense), jax.tree.leaves(dense)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert PKGS[loader][4](root).latest()["day"] == 20261016


def test_donefile_append_is_idempotent_and_rewrite_repairs(tmp_path):
    fu = FleetUtil(str(tmp_path))
    e = {"day": 1, "pass": 0, "path": "x"}
    assert fu.append_donefile("d.donefile", e) is True
    assert fu.append_donefile("d.donefile", dict(e, ts=5)) is False
    fu.rewrite_donefile("d.donefile", [e, {"day": 2, "path": "y"}])
    assert [x["day"] for x in fu.entries("d.donefile")] == [1, 2]
    # a rewrite killed between its stage and its replace: the staging copy
    # is read, and the next append repairs the main file first
    main = tmp_path / "d.donefile"
    os.replace(main, str(main) + ".compact")
    assert [x["day"] for x in JaxFleetUtil(str(tmp_path)).entries(
        "d.donefile")] == [1, 2]
    fu.append_donefile("d.donefile", {"day": 3, "path": "z"})
    assert [x["day"] for x in fu.entries("d.donefile")] == [1, 2, 3]
    assert not os.path.exists(str(main) + ".compact")


@pytest.mark.parametrize("root", ["hdfs://ns1/ckpt", "afs://cluster/out"])
def test_remote_roots_raise_not_ported(root):
    with pytest.raises(RemoteFSNotPorted, match="ROADMAP"):
        PassCheckpointer(root)
    with pytest.raises(NotImplementedError, match="not ported"):
        FleetUtil(root)


def test_boxps_delta_shrink_and_phase_match_reference(tmp_path):
    """BoxPS.end_pass(need_save_delta=...) writes the reference's delta,
    shrink_table evicts as the reference does, and flip_phase gates the
    metrics."""
    from paddlebox_tpu.fleet.boxps import BoxPS as JaxBoxPS
    from paddlebox_tpu_torch.fleet import BoxPS
    out = {}
    for pkg, box_cls in (("port", BoxPS), ("jax", JaxBoxPS)):
        store = _store(pkg)
        box = box_cls(store)
        assert box.phase == 1
        box.flip_phase()
        assert box.phase == box.metrics.phase == 0
        rng = np.random.default_rng(4)
        keys = rng.choice(1 << 40, 100, replace=False).astype(np.uint64)
        store.lookup_or_init(keys)
        store.write_back(keys, _rows(rng, len(keys), store.cfg.row_width))
        box.begin_pass()
        d = str(tmp_path / pkg)
        info = box.end_pass(need_save_delta=True, delta_path=d)
        assert info["pass_id"] == 1
        assert os.path.basename(info["delta_file"]) == "delta-00001.npz"
        evicted = box.shrink_table(min_show=4.0, decay=0.5)
        with np.load(info["delta_file"]) as z:
            out[pkg] = (evicted, {k: z[k] for k in z.files})
    assert out["port"][0] == out["jax"][0] > 0
    for k, v in out["jax"][1].items():
        np.testing.assert_array_equal(out["port"][1][k], v, err_msg=k)
