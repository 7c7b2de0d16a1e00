"""One rank of the port's resilient world — no JAX.

Launched by tests/test_torch_elastic.py (on the CPU, at a narrow width)
and by chip_smoke.py's phase 16 (``--resilience-worker``, every rank on
cuda:0, DeepFM at full width) through the port's launcher. The spec is
a JSON file named by ``PBT_RES_SPEC``: ``kind`` ("shuffle", "resume" or
"elastic"), ``workdir``, ``device`` and the model's widths (``slots``,
``dense``, ``hidden``, ``dim``, ``batch``, ``max_len``, ``n_keys``).

- shuffle: load this rank's ``.pbar`` archive through a SlotDataset on a
  TcpShuffleService, once with ``ins_id`` routing and once ``random``,
  and train one pass on what arrived after each; writes the received
  ins_ids, the exchange's bytes and seconds, and the launches;
- resume: ``stage`` "write" trains three checkpointed passes and dumps
  the live state after pass 2; "restore" (fresh processes) resumes
  through ``Trainer.resume(collectives=)`` and dumps the restored state;
- elastic: the elastic shrink drill (the port of tests/elastic_worker.py
  without the grow mode). Every rank holds the same dataset (ins_id
  1..n) and partitions each pass over the live members through the
  persistent shuffle generator; mid-pass snapshots every ``midpass``
  steps; the rank armed by ``PBTPU_FAULTPOINT`` / ``_ONLY_RANK`` dies.
  A survivor catches the PeerFailureError, runs
  ``Trainer.recover_world`` (drain snapshot, generation-sealed reform,
  election over the survivors, restore), re-routes the departed rank's
  unconsumed tail (``SlotDataset.reroute_records``) and finishes.
  ``sim`` = {"orig_members", "dead", "elected"}: the simulated-shrink
  golden run — no kill, no reform, no mid-pass snapshots; the survivors
  replay the schedule the recovered world trained, from the start.

Outputs (``workdir``): ``info_<rank>.json`` and ``out_<rank>.npz``.
"""

import json
import os
import sys
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


def _spec() -> dict:
    with open(os.environ["PBT_RES_SPEC"]) as f:
        return json.load(f)


def make_records(schema, n, keys, rng, max_len, ins_id=None):
    """Criteo-shaped examples (chip_smoke's make_records): each slot 1 to
    ``max_len`` ids drawn from ``keys``, a 25%-positive label and the
    dense floats; ``ins_id`` defaults to 1..n."""
    from paddlebox_tpu_torch.data.slot_record import SlotRecordBatch
    lens = [rng.integers(1, max_len + 1, n)
            for _ in range(len(schema.sparse_slots))]
    vals = [rng.choice(keys, int(ln.sum())).astype(np.int64) for ln in lens]
    offs = [np.concatenate([[0], np.cumsum(ln)]).astype(np.int64)
            for ln in lens]
    n_dense = len(schema.float_slots) - 1
    floats = [(rng.random(n) < 0.25).astype(np.float32)]
    floats += [rng.normal(size=n).astype(np.float32) for _ in range(n_dense)]
    ids = (np.arange(1, n + 1, dtype=np.uint64) if ins_id is None
           else ins_id)
    z64, z32 = np.zeros(n, np.uint64), np.zeros(n, np.int32)
    return SlotRecordBatch(schema, n, vals, offs, floats, ids, z64, z32, z32)


def draw_keys(n_keys: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(1, 1 << 50, n_keys + 4096,
                                  dtype=np.uint64))[:n_keys]
    rng.shuffle(keys)
    return keys, rng


def schema_of(spec):
    from paddlebox_tpu_torch.data import DataFeedSchema
    return DataFeedSchema.ctr(num_sparse=spec["slots"],
                              num_float=spec["dense"],
                              batch_size=spec["batch"],
                              max_len=spec["max_len"])


def build_job(spec, seed):
    """(store, trainer, box): DeepFM at the spec's widths, an adagrad
    table, adam dense params, on the spec's device."""
    from paddlebox_tpu_torch.embedding import (EmbeddingConfig,
                                               HostEmbeddingStore)
    from paddlebox_tpu_torch.fleet import BoxPS
    from paddlebox_tpu_torch.models import DeepFMModel
    from paddlebox_tpu_torch.train import Trainer, TrainerConfig
    cfg = EmbeddingConfig(dim=spec["dim"], optimizer="adagrad",
                          learning_rate=0.05)
    store = HostEmbeddingStore(cfg)
    tr = Trainer(DeepFMModel(spec["slots"], spec["dim"], spec["dense"],
                             hidden=tuple(spec["hidden"])),
                 store, schema_of(spec),
                 TrainerConfig(global_batch_size=spec["batch"],
                               dense_lr=2e-3, auc_buckets=1 << 12),
                 seed=seed, device=spec["device"])
    box = BoxPS(store)
    box.set_date(20261017)
    box.init_metric("job_auc", n_buckets=128)
    return store, tr, box


def launch_counts():
    from paddlebox_tpu_torch.ops import kernels
    return {k: getattr(kernels, k).launches for k in
            ("gather_pool", "scatter_accumulate", "binned_merge_acc",
             "merge_update")}


def counted(fn, total: dict):
    """Run ``fn`` between a reset of every kernel's launch count and a
    read; add the counts to ``total``."""
    from paddlebox_tpu_torch.ops import kernels
    kernels.reset_launches()
    out = fn()
    for k, v in launch_counts().items():
        total[k] = total.get(k, 0) + v
    return out


def dump_state(path, store, tr, box, keys=None) -> None:
    """The planes a resume must restore, as one npz: the store's keys and
    flushed rows (``keys`` given: those), the dense params and optimizer
    state, the metric state, the global step and the pass id."""
    from paddlebox_tpu_torch.utils.checkpoint import flatten_tree
    tr.flush_sparse()
    if keys is None:
        keys = np.sort(store.keys())
    rows = store.get_rows(keys)
    dense = {f"dense/{p}": np.asarray(v)
             for p, v in flatten_tree(tr.dense_state())}
    met = {f"met/{k}": np.asarray(v.cpu() if hasattr(v, "cpu") else v)
           for k, v in box.metrics.get_state("job_auc").items()}
    np.savez(path, keys=keys, rows=rows,
             global_step=np.int64(tr.global_step),
             pass_id=np.int64(box.pass_id), **dense, **met)


def _ds_for(schema, records):
    from paddlebox_tpu_torch.data import SlotDataset
    d = SlotDataset(schema)
    d.records = records
    return d


def _warm_kernels(spec) -> None:
    if spec["device"] != "cpu":
        from paddlebox_tpu_torch.ops import kernels
        # built by the parent before the world formed: this loads them
        # (under the build lock), so no rank freezes in nvcc while its
        # peers' watchdogs run
        kernels.build_kernels()


# ---------------------------------------------------------------------------
# (a) the global shuffle
# ---------------------------------------------------------------------------

def run_shuffle(spec, log) -> dict:
    from paddlebox_tpu_torch.data import SlotDataset
    from paddlebox_tpu_torch.data.shuffle import TcpShuffleService
    from paddlebox_tpu_torch.distributed import RoleMaker
    rm = RoleMaker.from_env()
    _warm_kernels(spec)
    schema = schema_of(spec)
    svc = TcpShuffleService(rm.rank, rm.endpoints, timeout_s=120)
    store, tr, box = build_job(spec, seed=rm.rank)
    info = {"rank": rm.rank, "rounds": {}, "launches": {},
            "jax_loaded": "jax" in sys.modules}
    try:
        for routing in ("ins_id", "random"):
            ds = SlotDataset(schema, shuffle_service=svc,
                             seed=spec["shuffle_seed"] + rm.rank)
            ds.set_filelist([spec["archives"][rm.rank]])
            ds.load_into_memory(routing=routing)
            ex = ds.last_load_stats["exchange"]
            rec = ds.records
            box.begin_pass()
            out = counted(lambda: tr.train_pass(ds, metrics=box.metrics),
                          info["launches"])
            box.end_pass()
            info["rounds"][routing] = {
                "ins_id": [int(i) for i in rec.ins_id],
                "sent_bytes": ex["sent_bytes"],
                "received_bytes": ex["received_bytes"],
                "seconds": ex["seconds"],
                "load_seconds": ds.last_load_stats["seconds"],
                "steps": out["steps"], "loss_mean": out["loss_mean"]}
            log(f"{routing}: received {rec.num} records, trained "
                f"{out['steps']} steps")
    finally:
        svc.close()
    return info


# ---------------------------------------------------------------------------
# (b) the coordinated resume
# ---------------------------------------------------------------------------

def run_resume(spec, log) -> dict:
    from paddlebox_tpu_torch.distributed import RoleMaker
    from paddlebox_tpu_torch.utils.pass_ckpt import PassCheckpointer
    rm = RoleMaker.from_env()
    _warm_kernels(spec)
    me, work = rm.rank, spec["workdir"]
    schema = schema_of(spec)
    keys, rng = draw_keys(spec["n_keys"], seed=100 + me)
    ck = PassCheckpointer(os.path.join(work, f"root{me}"), keep_last_n=4,
                          base_every=2)
    info = {"rank": me, "launches": {}, "jax_loaded": "jax" in sys.modules}
    if spec["stage"] == "write":
        store, tr, box = build_job(spec, seed=me)
        for p in (1, 2, 3):
            ds = _ds_for(schema, make_records(
                schema, spec["steps"] * spec["batch"], keys, rng,
                spec["max_len"]))
            box.begin_pass()
            counted(lambda: tr.train_pass(ds, metrics=box.metrics),
                    info["launches"])
            box.end_pass(checkpointer=ck, trainer=tr, dataset=ds)
            info[f"save_{p}"] = dict(ck.last_save or {})
            if p == 2:
                dump_state(os.path.join(work, f"live2_{me}.npz"),
                           store, tr, box)
        log("wrote three passes")
        return info
    store, tr, box = build_job(spec, seed=1000 + me)
    col = rm.collectives(timeout_s=120)
    t0 = time.perf_counter()
    cursor = tr.resume(ck, box=box, collectives=col)
    info["resume_seconds"] = time.perf_counter() - t0
    info["elected"] = cursor["elected"]
    info["pass_id"] = cursor["pass_id"]
    info["intact"] = [list(c) for c in ck.intact_cursors()]
    live = np.load(os.path.join(work, f"live2_{me}.npz"))
    dump_state(os.path.join(work, f"restored_{me}.npz"), store, tr, box,
               keys=live["keys"])
    col.barrier("done")
    log(f"elected {cursor['elected']}")
    return info


# ---------------------------------------------------------------------------
# (c) the elastic shrink
# ---------------------------------------------------------------------------

def _concat(parts):
    from paddlebox_tpu_torch.data.slot_record import SlotRecordBatch
    parts = [p for p in parts if p is not None and p.num > 0]
    return SlotRecordBatch.concat(parts) if parts else None


def build_pass_records(ds, base, me, members, bs, old_members=None,
                       skip=0):
    """One pass's records for rank ``me`` through the shared generator:
    one permutation draw, plus — continuing a shrunk pass (``skip`` > 0
    over the ``old_members`` partition) — one re-route draw per departed
    rank's tail, in sorted order. Every rank (and the simulated golden)
    draws alike, so the generators stay in lockstep. Returns (records or
    None, the ins_ids of this rank's already-consumed head)."""
    ds.records = base
    ds.local_shuffle()
    if skip > 0 and old_members is not None:
        shards = ds.member_shards(len(old_members))
        own = shards[old_members.index(me)]
        head = min(skip * bs, own.num)
        own_head_ids = [int(i) for i in own.ins_id[:head]]
        own_tail = own.select(np.arange(head, own.num))
        adopted = []
        for d in sorted(set(old_members) - set(members)):
            dsh = shards[old_members.index(d)]
            dhead = min(skip * bs, dsh.num)
            tail = dsh.select(np.arange(dhead, dsh.num))
            routed = ds.reroute_records(tail, len(members))
            adopted.append(routed[members.index(me)])
        return _concat([own_tail] + adopted), own_head_ids
    shards = ds.member_shards(len(members))
    return shards[members.index(me)], []


def run_elastic(spec, log) -> dict:
    from paddlebox_tpu_torch import monitor
    from paddlebox_tpu_torch.config import flags
    from paddlebox_tpu_torch.data import SlotDataset
    from paddlebox_tpu_torch.distributed import RoleMaker
    from paddlebox_tpu_torch.distributed.resilience import (
        PeerFailureError, WorldFencedError)
    from paddlebox_tpu_torch.utils import faultpoint
    from paddlebox_tpu_torch.utils.pass_ckpt import PassCheckpointer
    rm = RoleMaker.from_env()
    work = spec["workdir"]
    bs = spec["batch"]
    passes = spec["passes"]
    step_sleep = float(spec.get("step_sleep", 0.0))
    lost_s = float(spec.get("lost_s", 2.0))
    sim = spec.get("sim")
    if spec.get("push_engine"):
        flags.push_engine = spec["push_engine"]
    if sim is not None:
        orig_members = sorted(sim["orig_members"])
        survivors = [r for r in orig_members if r not in set(sim["dead"])]
        me = survivors[rm.rank]
        members = list(survivors)
    else:
        me = rm.rank
        orig_members = list(range(rm.world_size))
        members = list(orig_members)
    only = os.environ.get("PBTPU_FAULTPOINT_ONLY_RANK", "")
    if sim is not None or (only and only != str(me)):
        faultpoint.disarm()
    sink = monitor.MemorySink(cap=1 << 14)
    monitor.hub().enable(sink)
    _warm_kernels(spec)

    schema = schema_of(spec)
    keys, rng = draw_keys(spec["n_keys"])
    base = make_records(schema, spec["n"], keys, rng, spec["max_len"])
    store, tr, box = build_job(spec, seed=7 + me)
    ckpt = PassCheckpointer(os.path.join(work, "snaps", f"rank{me}"),
                            keep_last_n=4, base_every=2)
    # the simulated shrink is a plain run: mid-pass snapshots leave the
    # planes bit-equal (tests/test_torch_midpass.py), and it needs none
    midpass = 0 if sim is not None else int(spec.get("midpass", 0))
    if midpass > 0:
        tr.enable_midpass_snapshots(ckpt, midpass, box, metrics=box.metrics)
    ds = SlotDataset(schema)
    info: dict = {"rank": me, "orig_members": orig_members,
                  "elected": None, "mid_steps": 0, "gen": 0,
                  "members": members, "fenced": False,
                  "min_world_exit": False, "launches": {},
                  "jax_loaded": "jax" in sys.modules,
                  "peer_error": None, "drain_snapshot": None}

    if sim is None:
        world = rm.elastic_world(
            timeout_s=120, heartbeat_interval_s=spec.get("hb_interval", 0.15),
            lost_after_s=lost_s, stall_after_s=120.0,
            reform_timeout_s=spec.get("reform_timeout", 8.0))
        # warm-up grace until the first pass boundary: pass 1 allocates
        # and warms the card, and ranks sharing its host can starve a
        # publisher past a tight lost_after. The re-formed worlds keep
        # the tight value.
        world.heartbeat.lost_after_s = max(lost_s, 10.0)
        box.attach_collectives(world.collectives, heartbeat=world.heartbeat)

        def slow_check(w=world):
            time.sleep(step_sleep)
            w.check()
        tr.peer_check = slow_check if step_sleep > 0 else world.check
    else:
        world = None
        col = rm.collectives(timeout_s=120)
        box.attach_collectives(col)

    init_state = ds.shuffle_state()
    p, skip = 1, 0
    old_members = None
    hb_grace = world is not None
    sim_q, sim_m = ((int(sim["elected"][0]), int(sim["elected"][1]))
                    if sim is not None else (None, None))

    def train_one(recs, skip_steps=0):
        return counted(lambda: tr.train_pass(_ds_for(schema, recs),
                                             metrics=box.metrics,
                                             skip_steps=skip_steps),
                       info["launches"])

    while p <= passes:
        try:
            pre_state = ds.shuffle_state()
            tr.midpass_cursor_extra = {"shuffle_state": pre_state}
            if sim is not None:
                if p <= sim_q:
                    pm, po, ps = orig_members, None, 0
                elif p == sim_q + 1 and sim_m > 0:
                    pm, po, ps = members, orig_members, sim_m
                else:
                    pm, po, ps = members, None, 0
            else:
                pm, po, ps = members, old_members, skip
            if sim is not None and po is not None:
                # the golden kill pass: the own head of the old partition
                # (the state the live run restored), then the
                # continuation — one box pass, two train segments
                probe = _ds_for(schema, base)
                probe.set_shuffle_state(pre_state)
                probe.local_shuffle()
                own_full = probe.member_shards(len(po))[po.index(me)]
                head = own_full.select(np.arange(0, min(ps * bs,
                                                        own_full.num)))
                recs, _ = build_pass_records(ds, base, me, pm, bs,
                                             old_members=po, skip=ps)
                box.begin_pass()
                if head.num >= bs:
                    train_one(head)
                if recs is not None and recs.num >= bs:
                    train_one(recs)
                box.end_pass(checkpointer=ckpt, trainer=tr, dataset=ds)
                p += 1
                continue
            recs, _own_head = build_pass_records(ds, base, me, pm, bs,
                                                 old_members=po, skip=ps)
            this_skip = ps if po is None else 0
            box.begin_pass()
            if recs is not None and recs.num >= bs:
                train_one(recs, skip_steps=this_skip)
            box.end_pass(checkpointer=ckpt, trainer=tr, dataset=ds)
            skip, old_members = 0, None
            if hb_grace and world is not None:
                world.heartbeat.lost_after_s = lost_s   # the grace ends
                hb_grace = False
            p += 1
        except PeerFailureError as e:
            log(f"peer failure in pass {p}: {e}")
            info["peer_error"] = {"type": type(e).__name__,
                                  "ranks": list(e.ranks), "pass": p,
                                  "steps": int(tr.last_pass_steps)}
            info["jitter"] = world.heartbeat.jitter()
            pre_members = list(world.members)
            t0 = time.perf_counter()
            try:
                new_world, cursor = tr.recover_world(world, e, ckpt, box,
                                                     metrics=box.metrics)
            except WorldFencedError as fe:
                log(f"fenced: {fe}")
                info["fenced"] = True
                break
            info["recover_seconds"] = time.perf_counter() - t0
            drains = sink.find("drain_snapshot")
            if drains:
                info["drain_snapshot"] = drains[-1]["fields"]
            if new_world is None:
                info["min_world_exit"] = True
                break
            world = new_world
            members = list(world.members)
            tr.peer_check = world.check
            info.update(gen=world.gen, members=members)
            # mid cursors of re-routed passes would be ambiguous across
            # member sets: pass boundaries only from here
            tr.enable_midpass_snapshots(ckpt, 0, box)
            if cursor is None:
                ds.set_shuffle_state(init_state)
                p, skip, old_members = 1, 0, None
                continue
            info["elected"] = cursor.get("elected")
            q, m = int(cursor["pass_id"]), int(cursor.get("mid_steps") or 0)
            info["mid_steps"] = m
            if cursor.get("shuffle_state"):
                ds.set_shuffle_state(cursor["shuffle_state"])
            p, skip = q + 1, m
            old_members = pre_members if m > 0 else None

    resize = sink.find("world_resize")
    info["world_resize"] = [r["fields"] for r in resize]
    if world is not None:
        info["jitter_final"] = world.heartbeat.jitter()
    if not info["fenced"] and not info["min_world_exit"]:
        dump_state(os.path.join(work, f"out_{me}.npz"), store, tr, box,
                   keys=np.sort(base.unique_keys().astype(np.uint64)))
        (world.collectives if world is not None else col).barrier("done")
    if world is not None:
        world.close()
    monitor.hub().disable()
    return info


KINDS = {"shuffle": run_shuffle, "resume": run_resume,
         "elastic": run_elastic}


# ---------------------------------------------------------------------------
# the launching side
# ---------------------------------------------------------------------------

# the 2 -> 1 elastic drill at a narrow width: 16 steps a rank a pass,
# mid-pass snapshots every 4, steps slowed in generation 0 so the
# survivor detects a loss in pass 2 before its own pass 2 ends
ELASTIC_STEPS = 16
ELASTIC_SPEC = {"kind": "elastic", "device": "cpu", "slots": 4, "dense": 3,
                "hidden": [16, 16], "dim": 8, "batch": 32, "max_len": 1,
                "n_keys": 300, "n": 2 * ELASTIC_STEPS * 32, "passes": 3,
                "midpass": 4, "lost_s": 2.0, "step_sleep": 0.3,
                "hb_interval": 0.1, "reform_timeout": 4.0}


# the rank command: this program, or a script that runs its main()
# (chip_smoke.py --resilience-worker)
RANK_CMD = [sys.executable, os.path.abspath(__file__)]


def run_world(d, spec, nprocs, env=None, timeout_s=240, device_ranks=None):
    """Launch ``nprocs`` ranks (``RANK_CMD``) with ``spec`` (written to
    ``d``/spec.json) through the port's launcher, ``fail_stop=False``;
    returns (per-rank exit codes, the ranks' error tails)."""
    from paddlebox_tpu_torch.distributed.launch import launch
    os.makedirs(d, exist_ok=True)
    spec = dict(spec, workdir=str(d))
    path = os.path.join(d, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    base = {"PBT_RES_SPEC": path, "PYTHONPATH": REPO,
            "OMP_NUM_THREADS": "1", **(env or {})}
    codes = launch(nprocs, RANK_CMD,
                   store_dir=os.path.join(d, "store"), base_env=base,
                   fail_stop=False, timeout_s=timeout_s,
                   local_ranks=device_ranks)
    errs = "; ".join(open(os.path.join(d, n)).read()[-1500:]
                     for n in sorted(os.listdir(d)) if n.startswith("err_"))
    return codes, errs


def read_info(d, rank, stage=""):
    with open(os.path.join(d, f"info{stage}_{rank}.json")) as f:
        return json.load(f)


def _fail(what: str) -> None:
    raise AssertionError(what)


def shuffle_drill(d, spec, records, world=2, device_ranks=None):
    """(a): each rank's contiguous share of ``records`` (ins_ids
    distinct) as a ``.pbar`` archive; the ranks load them over their
    shuffle services, ins_id-routed then random. Checks each round: the
    union of what the ranks received is what they loaded, and every
    record sits on its route's rank (random: the destinations the
    sender's generator, seeded ``shuffle_seed + rank``, draws first).
    Returns the ranks' infos."""
    from paddlebox_tpu_torch.data.archive import write_archive
    from paddlebox_tpu_torch.utils.hashing import hash64_array
    os.makedirs(d, exist_ok=True)
    n = records.num
    bounds = np.linspace(0, n, world + 1).astype(np.int64)
    parts = [records.select(np.arange(bounds[r], bounds[r + 1]))
             for r in range(world)]
    archives = []
    for r, part in enumerate(parts):
        archives.append(os.path.join(d, f"part-{r}.pbar"))
        write_archive(archives[-1], part)
    spec = dict(spec, kind="shuffle", archives=archives)
    codes, errs = run_world(d, spec, world, device_ranks=device_ranks,
                            timeout_s=600)
    if codes != [0] * world:
        _fail(f"shuffle ranks exited {codes}: {errs}")
    infos = [read_info(d, r) for r in range(world)]
    for routing in ("ins_id", "random"):
        want: list[set] = [set() for _ in range(world)]
        for r, part in enumerate(parts):
            if routing == "ins_id":
                dest = (hash64_array(part.ins_id)
                        % np.uint64(world)).astype(np.int64)
            else:
                dest = np.random.default_rng(
                    spec["shuffle_seed"] + r).integers(0, world, part.num)
            for q in range(world):
                want[q] |= set(int(i) for i in part.ins_id[dest == q])
        got = [infos[q]["rounds"][routing]["ins_id"] for q in range(world)]
        if sum(len(g) for g in got) != n:
            _fail(f"{routing}: the ranks received "
                  f"{[len(g) for g in got]} records of {n}")
        for q in range(world):
            if len(got[q]) != len(set(got[q])) or set(got[q]) != want[q]:
                _fail(f"{routing}: rank {q} received records routed "
                      f"elsewhere or lost some")
    return infos


def resume_drill(d, spec, world=2, device_ranks=None):
    """(b): the ranks train three checkpointed passes (each its own
    root); rank 1's newest ``dense.npz`` is truncated; fresh processes
    resume through ``Trainer.resume(collectives=)``. Checks that every
    rank elects pass 2 and restores the live state it had after pass 2
    bit for bit. Returns (writer infos, restorer infos)."""
    spec = dict(spec, kind="resume")
    codes, errs = run_world(d, dict(spec, stage="write"), world,
                            device_ranks=device_ranks, timeout_s=600)
    if codes != [0] * world:
        _fail(f"writer ranks exited {codes}: {errs}")
    dense = os.path.join(d, "root1", "pass-00003", "dense.npz")
    raw = open(dense, "rb").read()
    with open(dense, "wb") as f:
        f.write(raw[:-64])
    codes, errs = run_world(d, dict(spec, stage="restore"), world,
                            device_ranks=device_ranks, timeout_s=600)
    if codes != [0] * world:
        _fail(f"restoring ranks exited {codes}: {errs}")
    writers = [read_info(d, r, "write") for r in range(world)]
    restorers = [read_info(d, r, "restore") for r in range(world)]
    for r in range(world):
        if restorers[r]["elected"] != [2, 0]:
            _fail(f"rank {r} elected {restorers[r]['elected']}")
        with np.load(os.path.join(d, f"live2_{r}.npz")) as a, \
                np.load(os.path.join(d, f"restored_{r}.npz")) as b:
            if sorted(a.files) != sorted(b.files):
                _fail(f"rank {r}: planes {sorted(a.files)} vs "
                      f"{sorted(b.files)}")
            for k in a.files:
                if not np.array_equal(a[k], b[k]):
                    _fail(f"rank {r}: restored {k} differs from the live "
                          f"state after pass 2")
    return writers, restorers


def main(argv=None) -> int:
    spec = _spec()
    work = spec["workdir"]
    os.makedirs(work, exist_ok=True)
    rank = os.environ.get("PBTPU_TRAINER_ID", "?")

    def log(msg):
        print(f"{spec['kind']} rank {rank}: {msg}", flush=True)

    try:
        info = KINDS[spec["kind"]](spec, log)
    except BaseException:
        with open(os.path.join(work, f"err_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    tag = spec.get("stage", "")
    with open(os.path.join(work, f"info{tag}_{info['rank']}.json"),
              "w") as f:
        json.dump(info, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
