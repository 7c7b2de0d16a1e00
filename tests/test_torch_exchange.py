"""The port's mesh exchange against the JAX package, on the CPU.

- The host functions, case for case against their JAX twins: the
  capacity rule, the routing plan, ``dedup_tokens``,
  ``merge_sorted_runs``, the dedup plan's lanes, wire and topology
  selection, the wire cost model, the ``WireController`` and the
  compressed push's side plane.
- The routed pull, pooled pull and push of both table layouts at world
  2 and at world 4 on a (2, 2) mesh (the hier push): a world of port
  ranks (tests/torch_multirank_worker.py) runs them on its shards of a
  seeded table, and the shards together are held to JAX's single-shard
  ``sharded.lookup`` / ``fused_pull_pool`` / ``push`` on the whole table
  (the bar of tests/test_exchange.py's 2-shard tests, computed outside
  ``shard_map``): bit for bit on the f32 wire (the payloads are exact
  lattice values, so summation order cannot show), within the
  ``test_push_wire_compression_bounded`` rtol 2e-2 on bf16 and int8 with
  the show/clk columns bit-exact.
- ``ShardedEmbeddingStore``: the protocol against the JAX store, a save
  round trip both ways between the packages, the manifest-crash
  rollback and the wrong-shard-count refusal.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_multirank_common as common
from torch_multirank_spawn import run_world
from paddlebox_tpu.config import flags as jax_flags
from paddlebox_tpu.embedding import EmbeddingConfig as JaxCfg
from paddlebox_tpu.embedding import ShardedEmbeddingStore as JaxSharded
from paddlebox_tpu.embedding import exchange as jax_exchange
from paddlebox_tpu.embedding import sharded as jax_sharded
from paddlebox_tpu.native.key_index import dedup_plan as jax_dedup_plan

from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.embedding import exchange, sharded
from paddlebox_tpu_torch.embedding.config import EmbeddingConfig
from paddlebox_tpu_torch.embedding.store import (HostEmbeddingStore,
                                                 ShardedEmbeddingStore)
from paddlebox_tpu_torch.native.key_index import dedup_plan
from paddlebox_tpu_torch.utils import faultpoint
from paddlebox_tpu_torch.utils.checkpoint import CheckpointCorruptError

torch.set_num_threads(1)

WIRE_RTOL = 2e-2


def _cfgs():
    kw = dict(dim=common.DIM, optimizer="sgd", learning_rate=0.0625)
    return EmbeddingConfig(**kw), JaxCfg(**kw)


# ---------------------------------------------------------------------------
# host functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,f", [(1, 2, 2.0), (64, 2, 2.0), (64, 4, 2.0),
                                   (63, 4, 1.25), (1000, 8, 0.75),
                                   (7, 3, 0.1), (128, 4, 4.0)])
def test_capacity_rule(n, d, f):
    assert sharded._capacity(n, d, f) == jax_sharded._capacity(n, d, f)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_route_plan_matches_jax(seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 96, size=80).astype(np.int32)
    idx[rng.random(80) < 0.25] = 0
    idx[:3] = 96 + np.arange(3)           # out-of-range plan pads
    for cap in (4, 20, 80):
        got = sharded._route(torch.from_numpy(idx), 24, 4, cap)
        want = jax_sharded._route(jnp.asarray(idx), 24, 4, cap)
        order, sowner, pos, valid, send = (t.numpy() for t in got)
        jo, js, jp, jv, jsend = (np.asarray(t) for t in want)
        np.testing.assert_array_equal(order, jo)
        np.testing.assert_array_equal(send, jsend)
        np.testing.assert_array_equal(valid, jv)
        # the drop group's positions are never read
        np.testing.assert_array_equal(pos[jv], jp[jv])
        np.testing.assert_array_equal(sowner[jv], js[jv])
        got_d = int(sharded.routed_dropped(torch.from_numpy(idx), 24, 4,
                                           cap / 20.0))
        want_d = int(jax_sharded.routed_dropped(jnp.asarray(idx), 24, 4,
                                                cap / 20.0))
        assert got_d == want_d


def test_dedup_tokens_and_merge_sorted_runs_match_jax():
    rng = np.random.default_rng(17)
    for trial in range(10):
        D = int(rng.integers(2, 6))
        L = int(rng.integers(3, 40))
        runs = np.sort(rng.integers(0, 50, size=(D, L)), axis=1)
        if trial % 2:
            for r in range(D):
                runs[r, int(rng.integers(0, L + 1)):] = 64
        runs = np.ascontiguousarray(runs).astype(np.int32)
        u_m, inv_m = sharded.merge_sorted_runs(torch.from_numpy(runs))
        u_a, inv_a = sharded.dedup_tokens(torch.from_numpy(runs.reshape(-1)))
        ju, jinv = jax_sharded.dedup_tokens(jnp.asarray(runs.reshape(-1)))
        for u, inv in ((u_m, inv_m), (u_a, inv_a)):
            np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
            np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))


def test_plan_dedup_indices_matches_jax():
    idx = np.array([5, 3, 5, 0, 9, 3, 3, 12], np.int32)
    o, u, s, _r, _e = dedup_plan(idx, 16, 16, 1)
    plan = sharded.DedupPlan(*(torch.from_numpy(a) for a in (o, u, s)))
    uniq, inv = exchange.plan_dedup_indices(plan)
    np.testing.assert_array_equal(uniq.numpy()[inv.numpy()], idx)
    jo, ju, js, _, _ = jax_dedup_plan(idx, 16, 16, 1)
    Z = jnp.zeros(0, jnp.int32)
    juniq, jinv = jax_exchange.plan_dedup_indices(
        (jnp.asarray(jo), Z, Z, jnp.asarray(ju), jnp.asarray(js)))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    np.testing.assert_array_equal(uniq.numpy(), np.asarray(juniq))


@pytest.mark.parametrize("wire", ["auto", "f32", "bf16", "int8", "nope"])
@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_select_wire_matches_jax(wire, storage):
    c = EmbeddingConfig(dim=4, storage=storage)
    jc = JaxCfg(dim=4, storage=storage)
    old, jold = flags.exchange_wire, jax_flags.exchange_wire
    flags.exchange_wire = jax_flags.exchange_wire = wire
    try:
        if wire == "nope":
            for fn, cfg in ((exchange.select_wire, c),
                            (jax_exchange.select_wire, jc)):
                with pytest.raises(ValueError, match="exchange_wire"):
                    fn(cfg)
        else:
            assert exchange.select_wire(c) == jax_exchange.select_wire(jc)
    finally:
        flags.exchange_wire, jax_flags.exchange_wire = old, jold


@pytest.mark.parametrize("topo", ["auto", "flat", "hier", "ring"])
@pytest.mark.parametrize("shape", [(2,), (4,), (2, 2), (1, 4)])
def test_select_topology_matches_jax(topo, shape):
    old, jold = flags.exchange_topology, jax_flags.exchange_topology
    flags.exchange_topology = jax_flags.exchange_topology = topo
    try:
        try:
            want = jax_exchange.select_topology(shape)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e).split("=")[0][:20]):
                exchange.select_topology(shape)
            return
        assert exchange.select_topology(shape) == want
    finally:
        flags.exchange_topology, jax_flags.exchange_topology = old, jold


def test_wire_bytes_and_cost_match_jax():
    c, jc = _cfgs()
    for lanes in (1, 100, 4097):
        for wire in exchange.WIRES:
            assert (exchange.push_wire_bytes(c, lanes, wire)
                    == jax_exchange.push_wire_bytes(jc, lanes, wire))
            for tokens in (lanes, 8 * lanes, 40 * lanes):
                assert (exchange.wire_cost(c, tokens, lanes, wire)
                        == jax_exchange.wire_cost(jc, tokens, lanes, wire))
        assert (exchange.pull_wire_bytes(c, lanes)
                == jax_exchange.pull_wire_bytes(jc, lanes))
    for storage in ("int8", "int16"):
        q = EmbeddingConfig(dim=8, storage=storage)
        jq = JaxCfg(dim=8, storage=storage)
        assert (exchange.pull_wire_bytes(q, 10)
                == jax_exchange.pull_wire_bytes(jq, 10))
    with pytest.raises(ValueError, match="wire"):
        exchange.wire_cost(c, 1, 1, "fp8")


def test_wire_controller_decisions_match_jax():
    c, jc = _cfgs()
    seq = ([(3200, 100, 0, None, None)] * 3 + [(100, 100, 0, None, None)]
           + [(3200, 100, 0, None, None)] + [(100, 100, 0, None, None)] * 3
           + [(0, 0, 0, None, None), (100, 100, 1, None, None),
              (100, 100, 0,
               {"edges": 4, "by_kind": {"exchange": {"max_latency_s": 0.01}}},
               10.0),
              (100, 100, 0, {"edges": 4, "by_kind": {}}, 10.0),
              (3200, 100, 0,
               {"edges": 4, "by_kind": {"exchange": {"max_latency_s": 5.0}}},
               10.0)] * 2)
    for hyst in (1, 2, 3):
        ctl = exchange.WireController(c, "f32", hysteresis=hyst)
        jctl = jax_exchange.WireController(jc, "f32", hysteresis=hyst)
        for tok, uniq, retr, flow, wall in seq:
            kw = dict(overflow_retries=retr, flow=flow, wall_seconds=wall)
            assert ctl.observe(tok, uniq, **kw) == \
                jctl.observe(tok, uniq, **kw)
        assert ctl.switches == jctl.switches


def test_compress_push_matches_jax_and_side_plane_exact():
    rng = np.random.default_rng(29)
    gw = 5
    pay = rng.normal(size=(2, 16, gw + 3)).astype(np.float32)
    for wire in exchange.WIRES:
        planes = exchange._compress_push(torch.from_numpy(pay), gw, wire)
        jplanes = jax_exchange._compress_push(jnp.asarray(pay), gw, wire)
        for p, jp in zip(planes, jplanes):
            if p.dtype == torch.bfloat16:
                np.testing.assert_array_equal(
                    p.to(torch.float32).numpy(),
                    np.asarray(jp.astype(jnp.float32)))
            else:
                np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
        back = exchange._decompress_push(planes, wire).numpy()
        np.testing.assert_array_equal(
            back, np.asarray(jax_exchange._decompress_push(jplanes, wire)))
        np.testing.assert_array_equal(back[..., gw:], pay[..., gw:])


# ---------------------------------------------------------------------------
# routed ops at world 2 and world 4 (2, 2), against one JAX shard
# ---------------------------------------------------------------------------

def _gather(arrays, key):
    return np.concatenate([a[key] for a in arrays])


def _reference(world: int):
    c, jc = _cfgs()
    case = common.ops_case(world, c.row_width, c.grad_width)
    table = jnp.asarray(case["table"])
    idx = jnp.asarray(case["idx"])
    args = tuple(jnp.asarray(case[k]) for k in ("idx", "grads", "shows",
                                                "clks"))
    return {
        "pull": np.asarray(jax_sharded.lookup(table, idx, jc)),
        "pooled": np.asarray(jax_sharded.fused_pull_pool(
            table, jnp.asarray(case["pidx"]), jc, common.OPS_S,
            common.OPS_L)),
        "push": np.asarray(jax_sharded.push(table, *args, jc)),
    }


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for world, nodes in ((2, 1), (4, 2)):
        work = tmp_path_factory.mktemp(f"ops{world}")
        infos, arrays = run_world(str(work), world, ["ops"],
                                  num_nodes=nodes)
        out[world] = (infos, arrays, _reference(world))
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["pull_single", "pull_single_dedup",
                                  "pull_sharded"])
def test_routed_pull_bit_identical(worlds, world, name):
    infos, arrays, ref = worlds[world]
    assert all(i["ops_dropped"] == 0 for i in infos)
    np.testing.assert_array_equal(_gather(arrays, name), ref["pull"])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["pull_pooled", "pull_pooled_noplan"])
def test_routed_pull_pooled_bit_identical(worlds, world, name):
    _, arrays, ref = worlds[world]
    np.testing.assert_array_equal(_gather(arrays, name), ref["pooled"])


PUSHES = {2: ["push_single", "push_single_dedup", "push_f32_flat",
              "push_noplan_flat", "push_deferred"],
          4: ["push_single", "push_single_dedup", "push_f32_flat",
              "push_noplan_flat", "push_deferred", "push_f32_hier",
              "push_noplan_hier"]}


@pytest.mark.parametrize("world,name",
                         [(w, n) for w, names in PUSHES.items()
                          for n in names])
def test_routed_push_f32_bit_identical(worlds, world, name):
    _, arrays, ref = worlds[world]
    np.testing.assert_array_equal(_gather(arrays, name), ref["push"])


@pytest.mark.parametrize("world,name",
                         [(2, "push_bf16_flat"), (2, "push_int8_flat"),
                          (4, "push_bf16_flat"), (4, "push_int8_flat"),
                          (4, "push_bf16_hier"), (4, "push_int8_hier")])
def test_routed_push_wire_compression_bounded(worlds, world, name):
    _, arrays, ref = worlds[world]
    got = _gather(arrays, name)
    np.testing.assert_allclose(got, ref["push"], rtol=WIRE_RTOL,
                               atol=WIRE_RTOL)
    # the counters cross the f32 side plane: bit-exact show/clk
    np.testing.assert_array_equal(got[:, :2], ref["push"][:, :2])
    assert not np.array_equal(got, ref["push"])     # the wire rounded


def test_ops_ranks_import_no_jax(worlds):
    for world, (infos, _, _) in worlds.items():
        assert [i["world"] for i in infos] == [world] * world
        assert not any(i["jax_loaded"] for i in infos)
    assert worlds[4][0][0]["shape"] == [2, 2]


def test_exchange_counters_registered():
    """Every exchange / routed-drop counter the port adds is in the
    names registry, and the exchange events are registered."""
    import re

    from paddlebox_tpu_torch.monitor import names
    pkg = os.path.dirname(os.path.dirname(exchange.__file__))
    found = set()
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                found |= set(re.findall(
                    r'counter_add\("((?:exchange|trainer\.routed|'
                    r'trainer\.capacity)[^"]*)"',
                    open(os.path.join(root, f)).read()))
    assert found == set(names.EXCHANGE_COUNTERS)
    for ev in ("exchange_overflow", "exchange_overflow_retry",
               "exchange_wire_adapted", "routed_dropped"):
        assert names.is_registered(ev)


# ---------------------------------------------------------------------------
# ShardedEmbeddingStore
# ---------------------------------------------------------------------------

def test_sharded_store_protocol_parity():
    c, jc = _cfgs()
    ss = ShardedEmbeddingStore(c, 4)
    js = JaxSharded(jc, 4)
    href = HostEmbeddingStore(c)
    keys = np.random.default_rng(1).choice(
        1 << 60, size=200, replace=False).astype(np.uint64)
    rows = ss.lookup_or_init(keys)
    np.testing.assert_array_equal(rows, js.lookup_or_init(keys))
    np.testing.assert_array_equal(rows, href.lookup_or_init(keys))
    np.testing.assert_array_equal(ss.shard_of(keys), js.shard_of(keys))
    assert len(ss) == len(js) == 200
    assert len(set(ss.shard_of(keys).tolist())) > 1
    rows[:, 2] = 7.5
    ss.write_back(keys, rows)
    np.testing.assert_array_equal(ss.get_rows(keys)[:, 2], 7.5)
    ss.peek_rows(np.array([123456789], np.uint64))
    assert len(ss) == 200
    k2, v2 = ss.export_serving()
    assert len(k2) == 200 and v2.shape == (200, c.pull_width)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sharded_store_round_trip_across_packages(tmp_path, writer):
    c, jc = _cfgs()
    stores = {"port": ShardedEmbeddingStore(c, 3), "jax": JaxSharded(jc, 3)}
    w = stores[writer]
    keys = np.arange(1, 101, dtype=np.uint64) * 0x1234567890ab
    w.lookup_or_init(keys)
    w.save_base(str(tmp_path))
    rows = w.get_rows(keys)
    rows[:, 2] = 42.0
    w.write_back(keys[:50], rows[:50])
    w.save_delta(str(tmp_path))
    assert w.save_seq == 1
    for loader in (ShardedEmbeddingStore, JaxSharded):
        s2 = loader.load(str(tmp_path))
        assert len(s2) == 100 and s2.n_shards == 3
        np.testing.assert_array_equal(s2.get_rows(keys), w.get_rows(keys))
    assert sorted(n for n in os.listdir(tmp_path)
                  if n.startswith("shard-")) == \
        ["shard-00", "shard-01", "shard-02"]


@pytest.mark.parametrize("point", ["exchange.store.pre_shard_save",
                                   "exchange.store.pre_manifest"])
def test_sharded_store_crash_rolls_whole_save_back(tmp_path, point):
    """A save killed mid shard loop or before the top manifest commit
    restores at the last committed save (the orphaned newer shard files
    are ignored)."""
    c, _ = _cfgs()
    ss = ShardedEmbeddingStore(c, 2)
    keys = np.arange(1, 41, dtype=np.uint64) * 0x9876543210
    ss.lookup_or_init(keys)
    ss.save_base(str(tmp_path))
    committed = ss.get_rows(keys)
    rows = committed.copy()
    rows[:, 2] = -3.0
    ss.write_back(keys, rows)
    faultpoint.arm(point, "ioerror",
                   after=1 if point.endswith("shard_save") else 0)
    try:
        with pytest.raises(faultpoint.FaultInjected):
            ss.save_delta(str(tmp_path))
    finally:
        faultpoint.disarm()
    s2 = ShardedEmbeddingStore.load(str(tmp_path))
    np.testing.assert_array_equal(s2.get_rows(keys), committed)
    assert s2.save_seq == 0


def test_sharded_store_wrong_shard_count_rejected(tmp_path):
    c, _ = _cfgs()
    ss = ShardedEmbeddingStore(c, 2)
    ss.lookup_or_init(np.arange(1, 11, dtype=np.uint64))
    ss.save_base(str(tmp_path))
    with pytest.raises(CheckpointCorruptError, match="shards"):
        ShardedEmbeddingStore(c, 3).restore(str(tmp_path))
