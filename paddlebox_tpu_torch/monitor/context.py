"""Pass/step context propagation for telemetry — the port's copy of
``paddlebox_tpu/monitor/context.py``.

Every telemetry event in the reference is implicitly scoped: the per-card
``log_for_profile`` lines print *per pass*, the dump threads write *per
batch*, and the donefiles name the pass they snapshot. Our events need the
same identity — including the ones emitted from background threads (the
pack pipeline, the feed-pass stager, the DumpStream writer) — so the
context is:

- a :class:`contextvars.ContextVar` holding one mutable :class:`PassContext`
  object. Threads spawned through :func:`spawn` inherit the caller's
  contextvars snapshot; because the snapshot maps the var to the *same
  object*, step advances made by the training thread (:func:`set_step`)
  are visible to every inheriting thread immediately.
- a process-global fallback mirroring the innermost open pass, so threads
  created with a bare ``threading.Thread`` (third-party code, pre-existing
  helpers) still resolve the current pass. One pass is open per process at
  a time — the reference has the same discipline (BeginPass raises on
  nesting) — so the fallback is exact, not approximate.
"""

from __future__ import annotations

import contextvars
import threading


class PassContext:
    """Mutable identity of the innermost open pass. ``step`` is advanced
    in place by the training loop so context snapshots taken at thread
    spawn stay live."""

    __slots__ = ("pass_id", "step", "phase")

    def __init__(self, pass_id: int | None = None, step: int | None = None,
                 phase: int | None = None):
        self.pass_id = pass_id
        self.step = step
        self.phase = phase

    def tags(self) -> dict:
        return {"pass_id": self.pass_id, "step": self.step,
                "phase": self.phase}


_EMPTY = PassContext()           # shared immutable-by-convention sentinel
_var: contextvars.ContextVar[PassContext | None] = contextvars.ContextVar(
    "pbtpu_pass_context", default=None)
_global: PassContext = _EMPTY    # fallback for plainly-spawned threads


def current() -> PassContext:
    """The innermost open pass context (or the empty sentinel)."""
    c = _var.get()
    return c if c is not None else _global


def enter_pass(pass_id: int, phase: int | None = None):
    """Open a pass scope; returns an opaque handle for :func:`exit_pass`.
    The TelemetryHub owns the lifecycle — instrumented code only reads."""
    global _global
    ctx = PassContext(int(pass_id), 0, phase)
    token = _var.set(ctx)
    prev_global, _global = _global, ctx
    return (ctx, token, prev_global)


def exit_pass(handle) -> None:
    global _global
    _ctx, token, prev_global = handle
    try:
        _var.reset(token)
    except ValueError:
        # reset from a different Context (e.g. a pass closed on another
        # thread than the one that opened it) — the global fallback below
        # still closes the scope for every plain reader
        _var.set(None)
    _global = prev_global


def set_step(step: int) -> None:
    """Advance the current pass's step (in place — snapshots stay live)."""
    c = current()
    if c is not _EMPTY:
        c.step = int(step)


def set_phase(phase: int) -> None:
    c = current()
    if c is not _EMPTY:
        c.phase = int(phase)


def spawn(target, *, args: tuple = (), kwargs: dict | None = None,
          name: str | None = None, daemon: bool = True) -> threading.Thread:
    """A ``threading.Thread`` that inherits the caller's contextvars.

    Python threads start with an EMPTY contextvars context; this copies the
    caller's, so telemetry emitted from the worker carries the same
    pass/step identity as the spawning code. Returned unstarted."""
    ctx = contextvars.copy_context()
    kw = kwargs or {}

    def run():
        ctx.run(target, *args, **kw)

    return threading.Thread(target=run, name=name, daemon=daemon)
