"""The world trace's clock side — the port's copy of the part of
``paddlebox_tpu/monitor/trace.py`` the heartbeat reads.

``ntp_offset`` (JAX ``trace.py:278-288``) turns one closed heartbeat
round trip into a clock-offset sample; ``distributed.resilience.
HeartbeatMonitor`` emits each as a ``trace.clock_probe`` event. The
trace recorder and merger themselves are the monitor's read side (not
ported yet: ROADMAP queue 1 item 7).
"""

from __future__ import annotations


def ntp_offset(t0: float, t1: float, t2: float, t3: float
               ) -> tuple[float, float]:
    """The symmetric estimate from one heartbeat round trip: the observer
    publishes at ``t0`` (its clock), the peer reads that at ``t1`` and
    publishes its echo at ``t2`` (peer clock), the observer reads the
    echo at ``t3``. Returns ``(offset, rtt)`` with ``offset ~=
    peer_clock - observer_clock`` (delay asymmetry is the error term,
    bounded by rtt/2)."""
    offset = ((t1 - t0) + (t2 - t3)) / 2.0
    rtt = (t3 - t0) - (t2 - t1)
    return offset, rtt
