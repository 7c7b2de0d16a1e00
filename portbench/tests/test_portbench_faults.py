"""A run whose timed path is broken underneath comes out not correct:
one case for each fault the cells can have (one chip: no exchange
between chips to leave out), and the batch's faults at multi-hot."""

from __future__ import annotations

import pytest

from portbench.tests.portbench_tiny import UNEVEN, run_cell

CASES = [(w, f) for w in ("deepfm_criteo.train", "dlrm_criteo_tb.train")
         for f in ("frozen_step", "half_batch", "wrong_token", "stale_row")]
CASES.append(("deepfm_criteo.serve", "wrong_score"))
MULTI_HOT = ["half_batch", "wrong_token"]


def _planted(fault: str) -> str:
    return f"from portbench import faults\nfaults.install({fault!r})"


@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{w}-{f}" for w, f in CASES])
def test_fault_is_not_correct(workload, fault):
    res = run_cell(workload, prelude=_planted(fault))
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("fault", MULTI_HOT)
def test_fault_is_not_correct_at_multi_hot(fault):
    res = run_cell("dlrm_criteo_tb.train", prelude=_planted(fault),
                   cfg={"hotness": UNEVEN})
    assert res["correct"] is False, res["checks"]
