"""A run whose timed path is broken underneath comes out not correct:
one case for each fault the cells can have (one chip: no exchange
between chips to leave out)."""

from __future__ import annotations

import pytest

from portbench.tests.portbench_tiny import run_cell

CASES = [(w, f) for w in ("deepfm_criteo.train", "dlrm_criteo_tb.train")
         for f in ("frozen_step", "half_batch", "wrong_token", "stale_row")]
CASES.append(("deepfm_criteo.serve", "wrong_score"))


@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{w}-{f}" for w, f in CASES])
def test_fault_is_not_correct(workload, fault):
    res = run_cell(workload, prelude="from portbench import faults\n"
                   f"faults.install({fault!r})")
    assert res["correct"] is False, res["checks"]
