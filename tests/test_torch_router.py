"""The port's fleet router (``serving/router.py``) on the reference's
seven router cases (tests/test_fleet.py:262-365), with the same
scriptable fake replica: a shed is a named, counted refusal and never a
hang; the one retry never lands on the replica that timed out; a
building replica drains; an all-stale fleet degrades to the freshest
replica with a ``fleet.serving_stale`` event; an all-building fleet
falls back instead of shedding; a hedge's first answer wins and the
loser, completing after its cancel, is discarded and counted; a
``serving.fleet.router.pre_dispatch`` ioerror is retried elsewhere.

Each case also runs on the JAX ``Router`` with the same fakes, and the
two routers' ``stats()`` must agree. Every case runs under a deadline
(the body in a thread joined with a timeout), so a Future left pending
fails the test instead of hanging it.
"""

import functools
import threading
import time
from concurrent.futures import Future

import pytest

from paddlebox_tpu import monitor as jmonitor
from paddlebox_tpu.serving.router import Router as JaxRouter
from paddlebox_tpu.utils import faultpoint as jfaultpoint

from paddlebox_tpu_torch import monitor
from paddlebox_tpu_torch.serving.obs import LatencyWindow
from paddlebox_tpu_torch.serving.router import (Router, RouterShedError,
                                                RouterTimeoutError)
from paddlebox_tpu_torch.utils import faultpoint

DEADLINE_S = 20.0
PACKAGES = ("port", "jax")


def deadline(fn):
    """Run the test body in a thread; fail if it outlives DEADLINE_S."""
    @functools.wraps(fn)
    def run(*a, **kw):
        box: dict = {}

        def body():
            try:
                fn(*a, **kw)
            except BaseException as e:   # re-raised on the test thread
                box["err"] = e

        t = threading.Thread(target=body, daemon=True)
        t.start()
        t.join(DEADLINE_S)
        assert not t.is_alive(), f"{fn.__name__} outlived {DEADLINE_S}s"
        if "err" in box:
            raise box["err"]
    return run


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faultpoint.disarm()
    jfaultpoint.disarm()


@pytest.fixture()
def events():
    ms, jms = monitor.MemorySink(), jmonitor.MemorySink()
    monitor.hub().enable(ms)
    jmonitor.hub().enable(jms)
    yield {"port": ms, "jax": jms}
    monitor.hub().disable()
    jmonitor.hub().disable()


def _router(pkg, *a, **kw):
    return (Router if pkg == "port" else JaxRouter)(*a, **kw)


class _FakeReplica:
    """A scriptable replica handle: health + latency + result/failure."""

    def __init__(self, name, *, status="ok", building=False,
                 active_version=1, age_seconds=1.0, latency_s=0.0,
                 result=1.0, fail=None, hang=False, inflight=0):
        self.name = name
        self.quarantined = False
        self.status = status
        self.building = building
        self.active_version = active_version
        self.age_seconds = age_seconds
        self.latency_s = latency_s
        self.result = result
        self.fail = fail
        self.hang = hang
        self.inflight = inflight
        self.calls = 0
        self.futures: list[Future] = []

    def health(self):
        if self.status == "unreachable":
            raise ConnectionError(f"{self.name} is down")
        return {"status": self.status, "building": self.building,
                "active_version": self.active_version,
                "age_seconds": self.age_seconds}

    def submit(self, ids, mask, dense=None) -> Future:
        self.calls += 1
        fut: Future = Future()
        self.futures.append(fut)
        if self.hang:
            return fut                     # never resolves (cancellable)

        def _resolve():
            if self.fail is not None:
                fut.set_exception(self.fail)
            else:
                fut.set_result(self.result)
        if self.latency_s > 0:
            # in flight already: cancel() fails, so the router's discard
            # contract (late loser counted, never surfaced) is exercised
            fut.set_running_or_notify_cancel()
            threading.Timer(self.latency_s, _resolve).start()
        else:
            _resolve()
        return fut


def _settled(reps) -> bool:
    """Every Future a fake handed out is resolved or cancelled."""
    return all(f.done() for r in reps for f in r.futures)


@pytest.mark.parametrize("pkg", PACKAGES)
@deadline
def test_router_shed_is_named_counted_and_never_hangs(pkg):
    reps = [_FakeReplica("a", status="empty"),
            _FakeReplica("b", status="unreachable")]
    r = _router(pkg, reps, timeout_s=1.0, health_ttl_s=0.0)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="no serviceable replica"):
        r.score([1], [True])
    assert time.monotonic() - t0 < 2.0     # a refusal, not a hang
    s = r.stats()
    assert s["sheds"] == 1 and s["requests"] == 1
    assert reps[0].calls == reps[1].calls == 0


@deadline
def test_router_shed_error_type():
    r = Router([_FakeReplica("a", status="empty")], health_ttl_s=0.0)
    with pytest.raises(RouterShedError):
        r.score([1], [True])


@pytest.mark.parametrize("pkg", PACKAGES)
@deadline
def test_router_retry_never_lands_on_the_timed_out_replica(pkg):
    slow = _FakeReplica("slow", hang=True, inflight=0)
    fast = _FakeReplica("fast", result=7.0, inflight=5)
    r = _router(pkg, [slow, fast], timeout_s=0.2, health_ttl_s=10.0)
    out = r.score([1], [True])             # least-loaded picks `slow`
    assert out == 7.0
    assert slow.calls == 1 and fast.calls == 1
    s = r.stats()
    assert s["timeouts"] == 1 and s["retries"] == 1
    assert s["failures"] == 0
    assert _settled([slow, fast])          # the hung one was cancelled


@deadline
def test_router_both_timed_out_raises_timeout_and_cancels():
    a = _FakeReplica("a", hang=True)
    b = _FakeReplica("b", hang=True)
    r = Router([a, b], timeout_s=0.1, health_ttl_s=10.0)
    with pytest.raises(RouterTimeoutError):
        r.score([1], [True])
    s = r.stats()
    assert s["timeouts"] == 2 and s["failures"] == 1
    assert _settled([a, b])


@pytest.mark.parametrize("pkg", PACKAGES)
@deadline
def test_router_drains_a_building_replica(pkg):
    building = _FakeReplica("building", building=True, result=0.0)
    serving = _FakeReplica("serving", result=3.0)
    r = _router(pkg, [building, serving], health_ttl_s=10.0)
    for _ in range(10):
        assert r.score([1], [True]) == 3.0
    assert building.calls == 0 and serving.calls == 10


@pytest.mark.parametrize("pkg", PACKAGES)
@deadline
def test_router_all_stale_degrades_to_freshest_with_event(pkg, events):
    older = _FakeReplica("older", status="stale", age_seconds=100.0,
                         result=1.0)
    fresher = _FakeReplica("fresher", status="stale", age_seconds=5.0,
                           result=2.0)
    r = _router(pkg, [older, fresher], health_ttl_s=10.0)
    assert r.score([1], [True]) == 2.0     # freshest stale replica
    assert fresher.calls == 1 and older.calls == 0
    assert r.stats()["degraded_dispatches"] == 1
    ev = events[pkg].find("fleet.serving_stale")
    assert ev and ev[-1]["fields"]["chosen"] == "fresher"


@pytest.mark.parametrize("pkg", PACKAGES)
@deadline
def test_router_all_building_falls_back_instead_of_shedding(pkg, events):
    b1 = _FakeReplica("b1", building=True, result=1.0, age_seconds=2.0)
    b2 = _FakeReplica("b2", building=True, result=2.0, age_seconds=9.0)
    r = _router(pkg, [b1, b2], health_ttl_s=10.0)
    assert r.score([1], [True]) == 1.0
    s = r.stats()
    assert s["degraded_dispatches"] == 1 and s["sheds"] == 0
    # a build window is no staleness incident
    assert not events[pkg].find("fleet.serving_stale")


@pytest.mark.parametrize("pkg", PACKAGES)
@deadline
def test_router_hedge_first_wins_loser_cancelled_and_discarded(pkg):
    slow = _FakeReplica("slow", latency_s=0.5, result=1.0, inflight=0)
    fast = _FakeReplica("fast", latency_s=0.01, result=2.0, inflight=3)
    r = _router(pkg, [slow, fast], timeout_s=5.0, health_ttl_s=10.0,
                hedge_factor=1.0, hedge_min_count=5)
    for _ in range(10):                    # seed the p99 the threshold
        r._lat_svc.add(10.0)               # derives from (~10 ms)
    out = r.score([1], [True])
    # primary to `slow` (least loaded); the hedge fired past the
    # threshold, landed on `fast`, and its answer won
    assert out == 2.0
    assert slow.calls == 1 and fast.calls == 1
    s = r.stats()
    assert s["hedges"] == 1 and s["hedges_won"] == 1
    assert s["retries"] == 0 and s["failures"] == 0
    # the loser completes after its cancel: discarded, counted, never
    # surfaced; its Future resolves (nothing is left pending)
    end = time.monotonic() + 2.0
    while r.stats()["hedge_discards"] < 1 and time.monotonic() < end:
        time.sleep(0.02)
    assert r.stats()["hedge_discards"] == 1
    assert _settled([slow, fast])


@pytest.mark.parametrize("pkg", PACKAGES)
@deadline
def test_router_pre_dispatch_ioerror_retries_elsewhere(pkg):
    """A faulted primary dispatch is retried on the other replica; the
    caller sees only the answer."""
    a = _FakeReplica("a", result=1.0)
    b = _FakeReplica("b", result=1.0)
    r = _router(pkg, [a, b], health_ttl_s=10.0)
    fp = faultpoint if pkg == "port" else jfaultpoint
    fp.arm("serving.fleet.router.pre_dispatch", "ioerror")
    try:
        assert r.score([1], [True]) == 1.0
    finally:
        fp.disarm()
    # the fault fired before the submit: the primary target got nothing
    assert a.calls + b.calls == 1
    s = r.stats()
    assert s["retries"] == 1 and s["failures"] == 0


def test_hedge_threshold_guards():
    """Few samples or a very fast window never hedge everything: the
    min_count and floor_ms guards of the reference's rule."""
    from paddlebox_tpu.serving.obs import LatencyWindow as JaxWindow
    for W in (LatencyWindow, JaxWindow):
        w = W(30.0)
        assert w.hedge_threshold_ms(2.0, now=0.0) is None       # empty
        for i in range(19):
            w.add(0.01 * (i + 1), now=1.0)
        assert w.hedge_threshold_ms(2.0, now=1.0) is None       # 19 < 20
        w.add(0.2, now=1.0)
        assert w.hedge_threshold_ms(2.0, now=1.0) == 1.0        # floor
        assert w.hedge_threshold_ms(0.0, now=1.0) is None       # off
        for _ in range(20):
            w.add(10.0, now=2.0)
    got = LatencyWindow(30.0)
    want = JaxWindow(30.0)
    for i in range(50):
        got.add(float(i), now=5.0)
        want.add(float(i), now=5.0)
    assert got.hedge_threshold_ms(1.5, min_count=10, now=5.0) == \
        want.hedge_threshold_ms(1.5, min_count=10, now=5.0)
