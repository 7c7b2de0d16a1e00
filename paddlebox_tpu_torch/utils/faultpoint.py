"""Named fault-injection points — the port's copy of
``paddlebox_tpu/utils/faultpoint.py`` (``arm`` :266, ``disarm`` :297,
``hit`` :314, ``_arm_from_env`` :347).

Each crash window of the persistence paths calls :func:`hit` with a
registered name. Disarmed (the default), a hit is one empty-dict check.
Armed — via :func:`arm` in process, or the environment for subprocess
tests::

    PBTPU_FAULTPOINT=store.save_delta.pre_manifest   # point name(s), comma-ok
    PBTPU_FAULTPOINT_ACTION=kill                     # kill | ioerror
    PBTPU_FAULTPOINT_AFTER=2                         # fire on the 3rd hit

— the named point either hard-kills the process (``os._exit(137)``: no
atexit handlers, no finally blocks, the closest in-process stand-in for
a preemption) or raises :class:`FaultInjected` (an OSError).

``POINTS`` is the closed registry of the windows this package reaches,
under the JAX package's names, so one environment arms both packages.
Arms and trips route through the telemetry hub as the reference's do
(``faultpoint.armed``, ``faultpoint.trips``, ``faultpoint.trip.<name>``
and the ``faultpoint_armed`` / ``faultpoint_trip`` events); a broken hub
never fails ``arm`` or masks the injected fault.
"""

from __future__ import annotations

import os

POINTS: tuple[str, ...] = (
    # embedding/store.ShardedEmbeddingStore saves: about to write one
    # shard's chain (the top-level shards.json still describes the
    # previous save), and every shard saved with the top manifest not yet
    # committed — a kill at either rolls the whole save back.
    "exchange.store.pre_shard_save",
    "exchange.store.pre_manifest",
    # train/trainer.eval_pass: a routed eval pass dropped tokens and is
    # about to re-run at the grown capacity factor (eval is stateless).
    "exchange.eval.pre_retry",
    # utils/checkpoint.save_tree: dense tmp file written + fsynced,
    # os.replace not yet run — the final name still holds the previous
    # file (or nothing).
    "ckpt.dense.pre_replace",
    # embedding/store.save_base: base.npz tmp written, before the replace.
    "store.save_base.pre_replace",
    # embedding/store.save_delta: delta-*.npz tmp written, before replace.
    "store.save_delta.pre_replace",
    # embedding/store.save_delta: delta file landed, manifest commit not
    # yet — the chain manifest must still describe the previous save.
    "store.save_delta.pre_manifest",
    # embedding/feed_pass.flush: unsynced device rows are about to move
    # D2H into the host store (the materialization before every save) —
    # dying here must leave the previous snapshot untouched.
    "feed_pass.flush.pre",
    # embedding/feed_pass._stage/_apply_patch: the incremental delta feed
    # is about to fetch fresh/stale rows from the host store (or patch a
    # background staging with rows mutated after it). Nothing is applied
    # yet, so the previous pass's snapshot is the recovery point.
    "feed_pass.delta_stage.pre",
    # embedding/spill_store: a spill store is about to msync its
    # memory-mapped rows and stream them into a base/delta payload —
    # dying here must leave the chain at the previous committed save.
    "tiering.save.pre_flush",
    # embedding/spill_store.tier_end_pass: the pass-boundary re-scoring is
    # about to demote cold cached rows; the cache is never authoritative,
    # so a kill here must resume bit-exact.
    "tiering.evict.pre",
    # train/trainer._dispatch_pending_apply: a deferred sparse-push apply
    # (flags.push_overlap) is about to launch, before the next step.
    "trainer.push_apply.pre",
    # utils/pass_ckpt.save: all planes written, snapshot MANIFEST.json not
    # yet committed — the snapshot must be invisible to resume.
    "pass_ckpt.pre_manifest",
    # utils/pass_ckpt.save: manifest committed — resume must land on THIS
    # snapshot.
    "pass_ckpt.post_manifest",
    # train/trainer._midpass_save: a mid-pass snapshot just committed —
    # dying here must resume from the cursor (skip the steps already
    # trained), not replay the pass from its start.
    "trainer.midpass.post_save",
    # remote (hdfs://) checkpoint and model roots: the local snapshot
    # committed, its upload not yet run — the remote donefile must still
    # name only fully uploaded snapshots (the pass_ckpt mirror and
    # FleetUtil._save_dir).
    "remote_ckpt.upload.pre",
    # remote restore: a snapshot or model directory is about to download
    # — dying here must leave the next resume able to download it again.
    "remote_ckpt.download.pre",
    # serving/artifact.write_artifact: every member landed, the version's
    # MANIFEST.json not yet committed — the version never happened.
    "serving.publish.pre_manifest",
    # serving/publisher.publish: the version directory committed, its
    # verification not yet run.
    "serving.publish.pre_upload",
    # serving/publisher.publish: verified, the donefile line not yet
    # appended — no server may see the version.
    "serving.publish.pre_donefile",
    # monitor/sinks.JsonlSink._rotate: a full segment is about to close
    # and the next one open (writer thread). A fault here latches the
    # sink's error: telemetry stops, training does not.
    "telemetry.rotate.pre",
    # train/trainer._pack_host: a batch's translate and plan are about to
    # run on the pack thread — a mid-pass kill in the host pipeline.
    "trainer.pack.pre",
    # train/trainer step loop: this batch's step is about to launch, just
    # after the peer check — the tightest mid-pass kill window.
    "trainer.step.pre",
    # distributed/resilience.ElasticWorld._attempt, the re-formation
    # window: drained and snapshotted, about to arrive; membership sealed
    # or read, ack not sent; acked, peers maybe not. A kill at any of
    # them must leave the survivors on ONE next generation without this
    # rank, never a mixed world.
    "elastic.reform.pre_arrive",
    "elastic.reform.post_seal",
    "elastic.reform.post_ack",
    # distributed/resilience.ElasticWorld.admit, the grow window: about to
    # register the admit request; acked a generation that includes this
    # joiner.
    "elastic.admit.pre_register",
    "elastic.admit.post_ack",
    # train/trainer.set_shard_ownership: the build partition is about to
    # rebind after an elastic resize.
    "elastic.ownership.rebind.pre",
    # serving/fleet.SharedStagingCache.materialize: the lease holder's
    # bytes are staged, verify and rename not yet run — dying here must
    # leave the lease expirable and never a torn copy under the final
    # name.
    "serving.fleet.lease.pre_verify",
    # serving/fleet.FleetReplicaServer._build: a replica is about to
    # build a fetched version (the replica-killed-mid-swap window).
    "serving.fleet.replica.pre_build",
    # serving/router.Router: a request's primary dispatch is about to go
    # to its chosen replica.
    "serving.fleet.router.pre_dispatch",
)

# points that fire only inside an elastic re-formation (no plain
# kill -> resume run reaches them)
ELASTIC_POINTS: tuple[str, ...] = (
    "elastic.reform.pre_arrive",
    "elastic.reform.post_seal",
    "elastic.reform.post_ack",
)

# points that fire only inside an elastic admit (world grow) or the
# ownership rebind after one
ADMIT_POINTS: tuple[str, ...] = (
    "elastic.admit.pre_register",
    "elastic.admit.post_ack",
    "elastic.ownership.rebind.pre",
)


# points that fire only inside the serving fleet (shared staging, replica
# builds, router dispatch): covered by the fleet's own kill matrix
# (tests/test_torch_fleet.py), all prefixed "serving.fleet."
FLEET_POINTS: tuple[str, ...] = (
    "serving.fleet.lease.pre_verify",
    "serving.fleet.replica.pre_build",
    "serving.fleet.router.pre_dispatch",
)


class FaultInjected(OSError):
    """Raised by an armed ``ioerror`` fault point."""


class _Armed:
    __slots__ = ("name", "action", "after", "hits")

    def __init__(self, name: str, action: str, after: int):
        self.name = name
        self.action = action
        self.after = after
        self.hits = 0


_armed: dict[str, _Armed] = {}
# telemetry failures swallowed by arm()/hit(): a broken hub is counted
# here and never fails the harness or masks the injected fault
hub_failures = 0
# per-point hit counters (tests assert a point is on the executed path)
_counts: dict[str, int] = {}


def arm(name, action: str = "kill", after: int = 0) -> None:
    """Arm one or more fault points. ``name`` is a point name, a
    comma-separated list of names, or a list/tuple of names — all armed
    with the same ``action``/``after`` (a re-arm of a live name resets
    its hit count). ``action``: ``kill`` (os._exit(137)) or ``ioerror``
    (raise FaultInjected). ``after``: fire on hit #after+1."""
    global hub_failures
    names = ([n.strip() for n in name.split(",") if n.strip()]
             if isinstance(name, str) else [str(n) for n in name])
    if not names:
        raise ValueError("arm() needs at least one fault point name")
    for n in names:
        if n not in POINTS:
            raise KeyError(
                f"unknown fault point {n!r}; registered: {POINTS}")
    if action not in ("kill", "ioerror"):
        raise ValueError(f"fault action {action!r} (want kill|ioerror)")
    for n in names:
        _armed[n] = _Armed(n, action, int(after))
    try:
        from paddlebox_tpu_torch.monitor.hub import _HUB
        for n in names:
            _HUB.counter_add("faultpoint.armed")
            _HUB.event("faultpoint_armed", point=n, action=action,
                       after=int(after))
    except Exception:
        hub_failures += 1


def disarm(name: str | None = None) -> None:
    """Disarm one point (by name) or, with no argument, all of them."""
    if name is None:
        _armed.clear()
    else:
        _armed.pop(name, None)


def hit_count(name: str) -> int:
    return _counts.get(name, 0)


def hit(name: str) -> None:
    """Mark a registered crash window. No-op unless armed on this name."""
    global hub_failures
    if not _armed:
        return
    if name not in POINTS:
        raise KeyError(f"unregistered fault point {name!r}")
    _counts[name] = _counts.get(name, 0) + 1
    a = _armed.get(name)
    if a is None:
        return
    a.hits += 1
    if a.hits <= a.after:
        return
    # telemetry before firing (the kill path loses in-flight sinks by
    # design: that is the crash being modeled)
    try:
        from paddlebox_tpu_torch.monitor.hub import _HUB
        _HUB.counter_add("faultpoint.trips")
        _HUB.counter_add(f"faultpoint.trip.{name}")
        _HUB.event("faultpoint_trip", point=name, action=a.action)
    except Exception:
        hub_failures += 1
    if a.action == "kill":
        # stderr marker first: a harness asserts the kill came from the
        # armed point, not an incidental crash
        os.write(2, f"FAULTPOINT KILL {name}\n".encode())
        os._exit(137)
    raise FaultInjected(f"fault point {name} (injected)")


def _arm_from_env() -> None:
    spec = os.environ.get("PBTPU_FAULTPOINT", "")
    if not spec:
        return
    names = [n.strip() for n in spec.split(",") if n.strip()]
    actions = [a.strip() for a in
               os.environ.get("PBTPU_FAULTPOINT_ACTION", "kill").split(",")]
    afters = [a.strip() for a in
              os.environ.get("PBTPU_FAULTPOINT_AFTER", "0").split(",")]
    # one action/after applies to every name; otherwise the lists align
    # positionally with the comma-separated point names. A name only the
    # JAX package reaches (its registry is larger) is that package's to
    # arm: this one never hits it.
    for i, n in enumerate(names):
        action = actions[i] if len(actions) > 1 else actions[0]
        after = afters[i] if len(afters) > 1 else afters[0]
        if n in POINTS:
            arm(n, action, int(after))


_arm_from_env()
