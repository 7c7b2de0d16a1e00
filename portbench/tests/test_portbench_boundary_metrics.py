"""The pass boundary's timers and the named idle shares, read from a
synthetic context as a training run hands it over."""

from __future__ import annotations

import pytest

from portbench import harness


def _read(name: str, ctx: dict):
    return harness.load_module("metrics", name).read(ctx)


def _ctx(**kw) -> dict:
    ctx = {"timers": {"read": (0.64, 65), "feed_begin": (1.2, 4),
                      "feed_wait": (0.04, 8), "writeback": (0.8, 4)},
           "passes": [(2.5, 2.0, 64)] * 4, "steps": 256}
    ctx.update(kw)
    return ctx


@pytest.mark.parametrize("name,want", [("feed_begin_s.train", 0.3),
                                       ("feed_wait_s.train", 0.01),
                                       ("writeback_s.train", 0.2)])
def test_boundary_timers_a_pass(name, want):
    assert _read(name, _ctx()) == pytest.approx(want)
    # an empty window, and a program without the stage
    assert _read(name, _ctx(passes=[])) is None
    assert _read(name, _ctx(timers={"read": (0.64, 65)})) is None


def _profile(gaps, busy=0.5, window=2.5):
    return {"busy_s": busy, "window_s": window, "device_ops": [],
            "idle_gaps": [[n, s] for n, s in gaps]}


GAPS = [("train_pass: pbt/read", 0.6), ("train_pass: python", 0.2),
        ("train_pass: pbt/feed_begin", 0.5),
        ("train_pass: pbt/dense_fwd_bwd", 0.3), ("end_pass: python", 0.1),
        ("outside: python", 0.1), ("train_pass: aten::mm", 0.2)]


def test_idle_shares_of_the_idle_time():
    ctx = _ctx(profile=_profile(GAPS))
    assert _read("idle_read_share.train", ctx) == pytest.approx(0.6 / 2.0)
    assert _read("idle_unnamed_share.train", ctx) == pytest.approx(0.4 / 2.0)


def test_idle_shares_none_on_an_empty_window():
    for name in ("idle_read_share.train", "idle_unnamed_share.train"):
        assert _read(name, _ctx()) is None                 # untraced
        assert _read(name, _ctx(profile=_profile(GAPS, busy=1.0,
                                                 window=1.0))) is None
        assert _read(name, _ctx(profile=_profile([], 0.0, 0.0))) is None


def test_a_program_without_ranges():
    """The gaps a program that opens no ``pbt/`` range leaves: no read
    share, and all of its unnamed time."""
    gaps = [("train_pass: python", 1.5), ("train_pass: aten::mm", 0.5)]
    ctx = _ctx(profile=_profile(gaps))
    assert _read("idle_read_share.train", ctx) is None
    assert _read("idle_unnamed_share.train", ctx) == pytest.approx(0.75)
