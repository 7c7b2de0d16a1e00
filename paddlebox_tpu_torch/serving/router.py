"""Health-aware request router over a serving replica fleet — the port of
``paddlebox_tpu/serving/router.py`` (``Router`` :78).

One host runs N replicas off one donefile (``serving/fleet.py``); the
router is the dispatch layer in front of them, the piece that turns "a
replica died mid-swap" into a routing decision:

- **Eligibility off /healthz.** Each replica's ``health()`` is polled and
  cached for ``health_ttl_s``. ``ok`` replicas take traffic;
  ``stale``/``degraded``/``empty``/unreachable ones, quarantined ones and
  one whose ``building`` bit is set drop out of rotation (a replica
  rebuilding a version drains). When no ``ok`` replica is left, a
  building or stale replica that still holds an active version serves
  as the fallback: a build does not unload the active model, and old
  scores beat a shed.
- **Least-loaded of two choices.** Two random eligible replicas; the one
  with fewer requests in flight wins.
- **Shed, never hang.** No serviceable replica → :class:`RouterShedError`,
  a named refusal carrying every replica's status, counted in
  :meth:`stats`. An all-stale fleet degrades to its freshest replica and
  emits ``fleet.serving_stale``.
- **One bounded retry.** A dispatch failure or timeout gets exactly one
  retry on a different replica: the one that failed (and any hedge
  target) is excluded.
- **Hedged requests.** With ``flags.serving_hedge_factor`` > 0, a request
  outstanding past factor x the windowed p99 of service times launches a
  second copy on another replica; the first answer wins, the loser is
  cancelled, and a loser already running resolves later with its result
  discarded and counted. The trigger's window leaves out hedge-won
  requests (their latency is about the threshold itself, and feeding it
  back would ratchet the threshold up).

Replica handles are duck-typed (``serving/fleet.py`` ``LocalReplica`` /
``SubprocessReplica``): ``name``, ``quarantined``, ``inflight``,
``health() -> dict``, ``submit(ids, mask, dense) -> Future`` and
``promote()``. Every Future a handle returns resolves or is cancelled:
a cancelled loser is never left pending in the router.

``serving.fleet.router.pre_dispatch`` (``utils/faultpoint.py``) sits on
the primary dispatch only: its ioerror leg proves a faulted dispatch is
retried on another replica, not surfaced to the caller.
"""

from __future__ import annotations

import random
import threading
import time
from concurrent.futures import FIRST_COMPLETED, Future, wait
from concurrent.futures import TimeoutError as FutureTimeoutError

from paddlebox_tpu_torch import monitor
from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.serving.obs import LatencyWindow
from paddlebox_tpu_torch.utils import faultpoint


class RouterShedError(RuntimeError):
    """No serviceable replica: the request is REFUSED (counted, named) —
    the router's contract is that a caller is never left hanging on a
    fleet that cannot answer."""


class RouterTimeoutError(TimeoutError):
    """One replica dispatch exceeded the per-request timeout. Internal
    to the retry path unless the retry times out too."""


class Router:
    """Health-aware least-loaded-of-two-choices dispatcher over replica
    handles. One instance per host fleet; thread-safe."""

    def __init__(self, replicas, *, timeout_s: float = 5.0,
                 health_ttl_s: float = 1.0,
                 hedge_factor: float | None = None,
                 hedge_min_count: int = 20,
                 window_s: float | None = None,
                 rng: random.Random | None = None):
        self.replicas = list(replicas)
        self.timeout_s = float(timeout_s)
        self.health_ttl_s = float(health_ttl_s)
        # 0.0 = hedging off; the flag is the fleet-wide default, the
        # kwarg the bench/test override
        self.hedge_factor = (float(flags.serving_hedge_factor)
                             if hedge_factor is None
                             else float(hedge_factor))
        self.hedge_min_count = int(hedge_min_count)
        win = (float(flags.serving_window_s or 30.0)
               if window_s is None else float(window_s))
        self._lat = LatencyWindow(win)
        # hedge-threshold source: client-observed latency MINUS the
        # hedge-won requests (see the module docstring's ratchet note)
        self._lat_svc = LatencyWindow(win)
        self._lock = threading.Lock()
        self._rng = rng if rng is not None else random.Random()
        self._health_cache: dict[str, tuple[float, dict]] = {}
        self._stale_emit_ts = 0.0
        self._requests = 0
        self._sheds = 0
        self._degraded_dispatches = 0
        self._retries = 0
        self._timeouts = 0
        self._failures = 0
        self._hedges = 0
        self._hedges_won = 0
        self._hedge_discards = 0

    # ---- health / eligibility -------------------------------------------

    def _health(self, rep, now: float) -> dict:
        with self._lock:
            cached = self._health_cache.get(rep.name)
            if cached is not None and now - cached[0] < self.health_ttl_s:
                return cached[1]
        try:
            h = rep.health()
        except Exception as e:   # noqa: BLE001 — a dead replica is a
            # routing fact, not a router error
            h = {"status": "unreachable", "error": repr(e)}
        with self._lock:
            self._health_cache[rep.name] = (now, h)
        return h

    def invalidate_health(self, name: str | None = None) -> None:
        """Drop cached health (all replicas with no argument) — the
        fleet calls this after a restart/quarantine so rotation reacts
        within the tick, not the TTL."""
        with self._lock:
            if name is None:
                self._health_cache.clear()
            else:
                self._health_cache.pop(name, None)

    def _survey(self, now: float):
        """(eligible, fallback, statuses): eligible replicas are ok +
        not building + not quarantined; the fallback list holds every
        replica that still has an active version to serve (building or
        stale — a build does not unload the active model, the swap is
        atomic), sorted freshest first."""
        eligible, fallback, statuses = [], [], {}
        for rep in self.replicas:
            if getattr(rep, "quarantined", False):
                statuses[rep.name] = "quarantined"
                continue
            h = self._health(rep, now)
            status = str(h.get("status", "unreachable"))
            building = bool(h.get("building"))
            statuses[rep.name] = (status + "+building" if building
                                  else status)
            if status == "ok" and not building:
                eligible.append(rep)
            elif (status in ("ok", "stale", "degraded")
                    and h.get("active_version") is not None):
                age = h.get("age_seconds")
                fallback.append((float("inf") if age is None
                                 else float(age), rep))
        fallback.sort(key=lambda t: t[0])
        return eligible, [r for _, r in fallback], statuses

    def _pick(self, exclude: set[str] | None = None):
        """One replica by two-choice least-loaded over the eligible set
        (minus ``exclude``); degrade to the freshest stale replica when
        nothing is ok; RouterShedError when nothing can serve at all."""
        now = time.time()
        exclude = exclude or set()
        eligible, stale, statuses = self._survey(now)
        eligible = [r for r in eligible if r.name not in exclude]
        if not eligible:
            stale = [r for r in stale if r.name not in exclude]
            if stale:
                # fallback dispatch: every replica is building or stale,
                # but the freshest one still SERVES (a build keeps the
                # old version active; the swap is atomic) and serving it
                # beats a shed. The staleness alert fires only when the
                # fleet is actually stale — a transient build window is
                # not an incident — and once per TTL, not per request.
                chosen = stale[0]
                with self._lock:
                    self._degraded_dispatches += 1
                    emit = (not statuses.get(chosen.name, "").startswith(
                                "ok")
                            and now - self._stale_emit_ts
                            >= self.health_ttl_s)
                    if emit:
                        self._stale_emit_ts = now
                if emit:
                    monitor.counter_add("fleet.serving_stale")
                    monitor.event("fleet.serving_stale",
                                  statuses=statuses,
                                  chosen=chosen.name)
                return chosen
            with self._lock:
                self._sheds += 1
            monitor.counter_add("fleet.router_sheds")
            raise RouterShedError(
                f"no serviceable replica (shed): {statuses}"
                + (f"; excluded after failure: {sorted(exclude)}"
                   if exclude else ""))
        if len(eligible) == 1:
            return eligible[0]
        a, b = self._rng.sample(eligible, 2)
        return a if a.inflight <= b.inflight else b

    # ---- dispatch --------------------------------------------------------

    def score(self, ids, mask, dense=None,
              timeout_s: float | None = None):
        """Route one request: pick → dispatch → (maybe hedge) → answer,
        with ONE retry on a different replica after a dispatch failure
        or timeout. Raises RouterShedError / RouterTimeoutError / the
        replica's scoring exception (after the retry also failed)."""
        timeout = self.timeout_s if timeout_s is None else float(timeout_s)
        t0 = time.perf_counter()
        with self._lock:
            self._requests += 1
        tried: set[str] = set()
        state = {"hedge_won": False}
        try:
            out = self._attempt(ids, mask, dense, timeout, tried,
                                primary=True, state=state)
        except RouterShedError:
            raise                     # nothing to retry INTO
        except Exception:
            # ONE bounded retry on a replica that did not just fail —
            # `tried` carries the primary (and any hedge) target, so
            # the retry can never land on the replica that timed out
            with self._lock:
                self._retries += 1
            monitor.counter_add("fleet.router_retries")
            try:
                out = self._attempt(ids, mask, dense, timeout, tried,
                                    primary=False, state=state)
            except Exception:
                with self._lock:
                    self._failures += 1
                monitor.counter_add("fleet.router_failures")
                raise
        elapsed_ms = (time.perf_counter() - t0) * 1e3
        with self._lock:              # LatencyWindow is not thread-safe
            self._lat.add(elapsed_ms)
            if not state["hedge_won"]:
                self._lat_svc.add(elapsed_ms)
        return out

    def _attempt(self, ids, mask, dense, timeout: float,
                 tried: set[str], *, primary: bool, state: dict):
        rep = self._pick(exclude=tried)
        tried.add(rep.name)
        if primary:
            # the registered crash window: a request is about to
            # dispatch to its chosen replica. Primary only — the armed
            # ioerror leg proves the retry lands elsewhere; hitting it
            # again on the retry would turn one injected fault into an
            # unconditional request failure.
            faultpoint.hit("serving.fleet.router.pre_dispatch")
        fut: Future = rep.submit(ids, mask, dense)
        deadline = time.monotonic() + timeout
        if primary:
            with self._lock:          # LatencyWindow is not thread-safe
                thr_ms = self._lat_svc.hedge_threshold_ms(
                    self.hedge_factor, min_count=self.hedge_min_count)
        else:
            thr_ms = None
        if thr_ms is not None:
            done, _ = wait([fut], timeout=min(thr_ms / 1e3, timeout))
            if fut not in done:
                out = self._hedge(rep, fut, ids, mask, dense, deadline,
                                  tried, state)
                if out is not _NO_HEDGE:
                    return out
        try:
            return fut.result(timeout=max(0.0,
                                          deadline - time.monotonic()))
        except (TimeoutError, FutureTimeoutError):
            fut.cancel()
            with self._lock:
                self._timeouts += 1
            monitor.counter_add("fleet.router_timeouts")
            raise RouterTimeoutError(
                f"replica {rep.name} exceeded {timeout:.3f}s") from None

    def _hedge(self, rep, fut: Future, ids, mask, dense,
               deadline: float, tried: set[str], state: dict):
        """Launch the hedge and race it against the primary. Returns the
        winner's result, or ``_NO_HEDGE`` when no second replica exists
        (the caller falls back to waiting on the primary alone)."""
        try:
            other = self._pick(exclude={rep.name})
        except RouterShedError:
            return _NO_HEDGE          # nobody to hedge onto
        # a timeout below times BOTH racers out — the one retry must
        # land on a third replica, never the hedge target that just
        # failed to answer either
        tried.add(other.name)
        with self._lock:
            self._hedges += 1
        monitor.counter_add("fleet.router_hedges")
        hfut: Future = other.submit(ids, mask, dense)
        racers = {fut: rep, hfut: other}
        last_err: Exception | None = None
        while racers:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            done, _ = wait(list(racers), timeout=remaining,
                           return_when=FIRST_COMPLETED)
            if not done:
                break
            winner = done.pop()
            try:
                out = winner.result()
            except Exception as e:   # noqa: BLE001 — the OTHER racer
                last_err = e          # may still answer; a hedge
                del racers[winner]    # exists exactly to survive this
                continue
            loser = next((f for f in racers if f is not winner), None)
            if loser is not None:
                self._discard(loser)
            if winner is hfut:
                state["hedge_won"] = True
                with self._lock:
                    self._hedges_won += 1
                monitor.counter_add("fleet.router_hedges_won")
            return out
        if not racers and last_err is not None:
            raise last_err            # both racers FAILED (not a timeout)
        # both racers timed out: cancel and let the caller's
        # timeout/retry accounting take over
        for f in list(racers):
            self._discard(f, count=False)
        with self._lock:
            self._timeouts += 1
        monitor.counter_add("fleet.router_timeouts")
        raise RouterTimeoutError(
            f"primary {rep.name} and hedge both exceeded the deadline")

    def _discard(self, fut: Future, count: bool = True) -> None:
        """Cancel the losing racer; a loser past cancel (already
        running) resolves later — its result is DISCARDED by contract
        (never returned to any caller) and counted, because a late
        loser silently winning would un-order the first-wins race."""
        if fut.cancel():
            return

        def _count(_f):
            if count:
                with self._lock:
                    self._hedge_discards += 1
        fut.add_done_callback(_count)

    # ---- accounting ------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            snap = self._lat.snapshot()
            out = {
                "replicas": len(self.replicas),
                "requests": int(self._requests),
                "sheds": int(self._sheds),
                "degraded_dispatches": int(self._degraded_dispatches),
                "retries": int(self._retries),
                "timeouts": int(self._timeouts),
                "failures": int(self._failures),
                "hedges": int(self._hedges),
                "hedges_won": int(self._hedges_won),
                "hedge_discards": int(self._hedge_discards),
            }
        if snap["count"]:
            out["p50_ms"] = round(snap["p50_ms"], 3)
            out["p99_ms"] = round(snap["p99_ms"], 3)
        return out


_NO_HEDGE = object()
