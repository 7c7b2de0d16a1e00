"""The control: the plain reference put in the program's place at the
precision below the configuration's (TF32 for float32 with TF32 off)
must come out not correct against each cell's limits. On the card only
(TF32 exists only there), at each cell's own sizes: run with
``python3 -m pytest --noconftest -m cuda portbench/tests``."""

from __future__ import annotations

import pytest
import torch

from portbench import control, harness


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 is the card's")
    return torch.device("cuda")


def _cell(workload):
    return (*harness.by_name(workload), harness.benchmark()["run_seconds"])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["deepfm_criteo.train",
                                      "dlrm_criteo_tb.train"])
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
def test_training_control_fails(card, workload, seed):
    cfg, mix, _ = _cell(workload)
    got = control.train_readings(cfg, mix, seed, card, program=False,
                                 precision="tf32")["control"]
    limits = harness.limits(workload)
    assert any(got[k] > limits[k] for k in limits), got


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
def test_serving_control_fails(card, seed):
    cfg, mix, seconds = _cell("deepfm_criteo.serve")
    got = control.serve_readings(cfg, mix, seed, card, seconds,
                                 "tf32")["control"]
    assert got["score"] > harness.limits("deepfm_criteo.serve")["score"]
