"""The port's cross-host shuffle (``paddlebox_tpu_torch.data.shuffle``)
against the JAX package's ``data/shuffle.py``, on records made from one
NumPy seed:

- ``route_records`` splits a batch into the same per-destination
  sub-batches in each routing mode (random from one generator state,
  ``ins_id`` hash, ``search_id`` modulo);
- ``serialize_batch`` bytes read back through the other package's
  ``deserialize_batch``, both ways, record for record;
- ``elastic_reroute`` draws the same destinations from one bit-generator
  state and leaves the generators in one state;
- ``TcpShuffleService`` at world 2 and 3 (threads as ranks, free ports):
  three rounds back to back, every record on its route's rank, each
  round's union the sent multiset, and an exchange past its deadline
  raises;
- ``SlotDataset.load_into_memory`` over services receives, on every
  rank, the multiset the JAX package's datasets receive over theirs;
- ``member_shards`` splits as the JAX package's does.
"""

import threading

import numpy as np
import pytest

from paddlebox_tpu.data import DataFeedSchema as JaxSchema
from paddlebox_tpu.data import SlotDataset as JaxDataset
from paddlebox_tpu.data import shuffle as jshuffle
from paddlebox_tpu.data.slot_record import SlotRecordBatch as JaxRecords

from paddlebox_tpu_torch.data import DataFeedSchema, SlotDataset
from paddlebox_tpu_torch.data import shuffle
from paddlebox_tpu_torch.data.slot_record import SlotRecordBatch
from paddlebox_tpu_torch.distributed.launch import _free_ports

NUM_SLOTS, DENSE = 3, 2
MODES = ("random", "ins_id", "search_id")


def _arrays(n=97, seed=5):
    rng = np.random.default_rng(seed)
    lens = [rng.integers(0, 4, n) for _ in range(NUM_SLOTS)]
    return {
        "n": n,
        "values": [rng.integers(1, 1 << 40, int(ln.sum())).astype(np.int64)
                   for ln in lens],
        "offsets": [np.concatenate([[0], np.cumsum(ln)]).astype(np.int64)
                    for ln in lens],
        "floats": [(rng.random(n) < 0.3).astype(np.float32)]
        + [rng.normal(size=n).astype(np.float32) for _ in range(DENSE)],
        "ins_id": rng.integers(0, 1 << 62, n).astype(np.uint64),
        "search_id": rng.integers(0, 1 << 40, n).astype(np.uint64),
        "rank": rng.integers(0, 5, n).astype(np.int32),
        "cmatch": rng.integers(0, 300, n).astype(np.int32)}


def _records(pkg, a):
    if pkg == "port":
        schema = DataFeedSchema.ctr(num_sparse=NUM_SLOTS, num_float=DENSE,
                                    batch_size=8, max_len=4)
        cls = SlotRecordBatch
    else:
        schema = JaxSchema.ctr(num_sparse=NUM_SLOTS, num_float=DENSE,
                               batch_size=8, max_len=4)
        cls = JaxRecords
    return cls(schema, a["n"], [v.copy() for v in a["values"]],
               [o.copy() for o in a["offsets"]],
               [f.copy() for f in a["floats"]], a["ins_id"].copy(),
               a["search_id"].copy(), a["rank"].copy(), a["cmatch"].copy())


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert a.num == b.num
    for f in ("sparse_values", "sparse_offsets", "float_values"):
        for x, y in zip(getattr(a, f), getattr(b, f), strict=True):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
    for f in ("ins_id", "search_id", "rank", "cmatch"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


def _rows(batch) -> list[tuple]:
    """Each record as a hashable tuple (for multiset comparisons)."""
    if batch is None or batch.num == 0:
        return []
    out = []
    for i in range(batch.num):
        sv = tuple(tuple(v[o[i]:o[i + 1]].tolist()) for v, o in
                   zip(batch.sparse_values, batch.sparse_offsets))
        fv = tuple(tuple(f.reshape(batch.num, -1)[i].tolist())
                   for f in batch.float_values)
        out.append((int(batch.ins_id[i]), int(batch.search_id[i]),
                    int(batch.rank[i]), int(batch.cmatch[i]), sv, fv))
    return out


@pytest.mark.parametrize("world", [1, 2, 3, 5])
@pytest.mark.parametrize("mode", MODES)
def test_route_records_matches_reference(mode, world):
    a = _arrays()
    got = shuffle.route_records(_records("port", a), world, mode,
                                rng=np.random.default_rng(11))
    want = jshuffle.route_records(_records("jax", a), world, mode,
                                  rng=np.random.default_rng(11))
    assert len(got) == len(want) == world
    for g, w in zip(got, want):
        _same(g, w)
    # the seed form (a throwaway generator) routes alike too
    got = shuffle.route_records(_records("port", a), world, mode, seed=4)
    want = jshuffle.route_records(_records("jax", a), world, mode, seed=4)
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("n", [0, 1, 40])
def test_serialization_reads_across_packages(n):
    a = _arrays(n=n, seed=n + 1)
    port, ref = _records("port", a), _records("jax", a)
    _same(jshuffle.deserialize_batch(shuffle.serialize_batch(port),
                                     ref.schema), ref)
    _same(shuffle.deserialize_batch(jshuffle.serialize_batch(ref),
                                    port.schema), port)
    # the service's extra keys ride beside the batch and are skipped by
    # a reader that does not know them
    raw = shuffle.serialize_batch(port, src=np.asarray([2]),
                                  round=np.asarray([7]))
    _same(jshuffle.deserialize_batch(raw, ref.schema), ref)


@pytest.mark.parametrize("world", [1, 2, 3])
def test_elastic_reroute_matches_reference(world):
    a = _arrays(n=61, seed=9)
    rng, jrng = np.random.default_rng(3), np.random.default_rng(0)
    jrng.bit_generator.state = rng.bit_generator.state
    for _ in range(3):               # the generators stay in lockstep
        got = shuffle.elastic_reroute(_records("port", a), world, rng)
        want = jshuffle.elastic_reroute(_records("jax", a), world, jrng)
        for g, w in zip(got, want):
            _same(g, w)
        assert rng.bit_generator.state == jrng.bit_generator.state


def _run_ranks(fn, world):
    outs, errs = [None] * world, []

    def run(r):
        try:
            outs[r] = fn(r)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errs.append((r, e))

    ts = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not errs, errs
    return outs


@pytest.mark.parametrize("world", [2, 3])
def test_tcp_service_rounds_route_every_record(world):
    eps = [f"127.0.0.1:{p}" for p in _free_ports(world)]
    services = [shuffle.TcpShuffleService(r, eps, timeout_s=60)
                for r in range(world)]
    data = [[_records("port", _arrays(n=30 + 7 * r + rnd, seed=10 * r + rnd))
             for rnd in range(3)] for r in range(world)]
    try:
        def rank(r):
            got = []
            for rnd in range(3):
                routed = shuffle.route_records(data[r][rnd], world,
                                               "ins_id")
                got.append(services[r].exchange(routed,
                                                data[r][rnd].schema))
            return got

        outs = _run_ranks(rank, world)
        for rnd in range(3):
            sent = sorted(row for r in range(world)
                          for row in _rows(data[r][rnd]))
            recv = []
            for r in range(world):
                for b in outs[r][rnd]:
                    rows = _rows(b)
                    recv += rows
                    dest = shuffle.hash64_array(b.ins_id) % np.uint64(world)
                    assert (dest == r).all(), (rnd, r)
            assert sorted(recv) == sent, rnd
        assert services[0].last_exchange["sent_bytes"] > 0
    finally:
        for s in services:
            s.close()


def test_tcp_service_times_out_on_a_missing_peer():
    eps = [f"127.0.0.1:{p}" for p in _free_ports(2)]
    svc = shuffle.TcpShuffleService(0, eps, timeout_s=1.0)
    try:
        b = _records("port", _arrays(n=8))
        with pytest.raises(RuntimeError, match="refused|timed out"):
            svc.exchange(shuffle.route_records(b, 2, "ins_id"), b.schema)
    finally:
        svc.close()


@pytest.mark.parametrize("routing", MODES)
def test_load_into_memory_over_services_matches_reference(tmp_path,
                                                          routing):
    """Two ranks per package, each loading its own text files through
    ``load_into_memory(routing=...)`` over its package's service: every
    rank receives the multiset the JAX package's rank receives (the
    order after the receiver's permutation differs: the JAX service
    keeps arrival order)."""
    from tests.test_torch_ingest import _write_text_files, schemas
    world = 2
    files = [_write_text_files(tmp_path / f"r{r}", n_files=2, lines=30,
                               seed=7 * r, with_ins_id=True)
             for r in range(world) if (tmp_path / f"r{r}").mkdir() is None]
    schema, jschema = schemas()

    def run(pkg):
        eps = [f"127.0.0.1:{p}" for p in _free_ports(world)]
        mod = shuffle if pkg == "port" else jshuffle
        cls, sch = ((SlotDataset, schema) if pkg == "port"
                    else (JaxDataset, jschema))
        services = [mod.TcpShuffleService(r, eps) for r in range(world)]
        try:
            def rank(r):
                ds = cls(sch, shuffle_service=services[r], seed=r)
                ds.with_ins_id = True
                ds.set_filelist(files[r])
                ds.load_into_memory(routing=routing)
                return _rows(ds.records)
            return _run_ranks(rank, world)
        finally:
            for s in services:
                s.close()

    got, want = run("port"), run("jax")
    for r in range(world):
        assert sorted(got[r]) == sorted(want[r]), r
    assert len(got[0]) + len(got[1]) == 4 * 30


@pytest.mark.parametrize("world", [1, 2, 4])
def test_member_shards_match_reference(world):
    a = _arrays(n=45, seed=2)
    ds, jds = SlotDataset(_records("port", a).schema), \
        JaxDataset(_records("jax", a).schema)
    ds.records, jds.records = _records("port", a), _records("jax", a)
    for g, w in zip(ds.member_shards(world), jds.member_shards(world),
                    strict=True):
        _same(g, w)


def test_spawned_ranks_shuffle_through_archives(tmp_path):
    """Two spawned ranks (tests/torch_resilience_worker.py, no JAX) load
    their ``.pbar`` shares over TcpShuffleServices, ins_id-routed then
    random, and train a pass on each arrival: nothing lost, nothing
    misrouted (the chip's phase 16 (a) at a narrow width)."""
    from tests import torch_resilience_worker as worker
    spec = {"device": "cpu", "slots": 4, "dense": 3, "hidden": [16],
            "dim": 8, "batch": 32, "max_len": 1, "n_keys": 500,
            "shuffle_seed": 5}
    keys, rng = worker.draw_keys(spec["n_keys"])
    records = worker.make_records(worker.schema_of(spec), 300, keys, rng, 1)
    infos = worker.shuffle_drill(tmp_path, spec, records)
    for info in infos:
        assert not info["jax_loaded"]
        for rnd in info["rounds"].values():
            assert rnd["sent_bytes"] > 0 and rnd["steps"] >= 3
