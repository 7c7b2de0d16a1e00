"""The DLRM-DCNv2 cell: its plain reference against the program's model,
its FLOPs by hand, its two metric readers, tiny runs through the real
loop at the published hotness (correct, and not correct under each
planted fault), and on the card the TF32 control against its limits
(``python3 -m pytest --noconftest -m cuda portbench/tests``)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import control, harness, program
from portbench.counts import flops
from portbench.reference import ctr
from portbench.tests.portbench_tiny import run_cell, shrink
from portbench.traffic import criteo

CONFIG = "dlrm_dcnv2_criteo_1tb"
CELL = f"{CONFIG}.train"
TINY = {"dcn_low_rank_dim": 8}


def _tiny():
    cfg, _ = shrink(harness.config(CONFIG), {"loop": "train"})
    return dict(cfg, **TINY)


def test_the_configuration_keeps_the_published_widths():
    cfg = harness.config(CONFIG)
    assert (cfg["embedding_dim"], cfg["bottom_hidden"], cfg["top_hidden"],
            cfg["dcn_num_layers"], cfg["dcn_low_rank_dim"]) == \
        (128, [512, 256], [1024, 1024, 512, 256], 3, 512)
    assert sum(harness.hotness(cfg)) == 214
    assert sum(cfg["cardinalities"]) == 7_116_632
    assert cfg["reduced"] == ["cardinalities", "max_ind_range"]


def test_forward_matches_the_program_model():
    from paddlebox_tpu_torch import weights
    cfg = _tiny()
    gen = torch.Generator().manual_seed(5)
    params = ctr.make_params(cfg, gen, "cpu")
    model = program.model(cfg)
    weights.load_model_params(model, program.param_tree(params))
    hot = harness.hotness(cfg)
    b, s, d = 32, cfg["num_sparse"], cfg["embedding_dim"]
    rows = torch.randn(b, sum(hot), 3 + d, generator=gen) * 0.1
    dense = torch.randn(b, cfg["num_dense"], generator=gen)
    mask = torch.ones(b, sum(hot), dtype=torch.bool)
    got = model(rows, mask, dense, np.repeat(np.arange(s), hot), s)
    want = ctr.family(cfg).forward(cfg, params, ctr.pool(cfg, rows[..., 2]),
                                   ctr.pool(cfg, rows[..., 3:]), dense,
                                   "float32")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_init_rows_match_the_program_store():
    from paddlebox_tpu_torch.embedding import HostEmbeddingStore
    cfg = _tiny()
    keys = criteo.unique_keys(criteo.key_of(20, torch.arange(100)))
    store = HostEmbeddingStore(program.embedding_config(cfg))
    np.testing.assert_array_equal(store.peek_rows(keys),
                                  ctr.init_rows(cfg, keys))


def test_flops_by_hand():
    cfg = harness.config(CONFIG)
    bottom = 13 * 512 + 512 * 256 + 256 * 128
    top = 3456 * 1024 + 1024 * 1024 + 1024 * 512 + 512 * 256 + 256
    cross = 3 * 2 * 3456 * 512          # V and W, three layers
    want = 2 * (3 * bottom - 13 * 512) + 2 * 3 * cross + 2 * 3 * top
    assert want == 96_169_472
    assert flops.train_flops_per_example(cfg) == want
    fam = harness.load_module("families", "dlrm_dcnv2")
    assert fam.interaction_flops_per_example(cfg) == 2 * 3 * cross
    # two thirds of it is the cross network; 6.5x DLRM's
    assert 0.6 < 2 * 3 * cross / want < 0.7
    assert 6 < want / flops.train_flops_per_example(
        harness.config("dlrm_criteo_tb")) < 7


def _read(name: str, ctx: dict):
    return harness.load_module("metrics", name).read(ctx)


def test_metric_readers():
    ctx = {"isolated": {"lookup": 0.004, "interaction": 0.012},
           "peak_flops": 67e12}
    assert _read("interaction_ms.train", ctx) == pytest.approx(12.0)
    # 63,700,992 FLOPs an example x 8192 at 67 TFLOP/s: 7.789 ms of 12
    assert _read("interaction_roofline", ctx) == pytest.approx(
        63_700_992 * 8192 / 67e12 / 0.012 * 100)
    assert 64 < _read("interaction_roofline", ctx) < 65
    # a program that does not time the interaction, and a CPU run
    for name in ("interaction_ms.train", "interaction_roofline"):
        assert _read(name, {"isolated": {"lookup": 0.004},
                            "peak_flops": 67e12}) is None
    assert _read("interaction_roofline",
                 {"isolated": {"interaction": 0.012}}) is None


def test_tiny_run_agrees_with_the_reference():
    res = run_cell(CELL, cfg=TINY)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0
    assert set(res["metrics"]) == {"train_examples_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["frozen_step", "half_batch",
                                   "wrong_token", "stale_row"])
def test_fault_is_not_correct(fault):
    res = run_cell(CELL, cfg=TINY, prelude=(
        f"from portbench import faults\nfaults.install({fault!r})"))
    assert res["correct"] is False, res["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 is the card's")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102])
def test_training_control_fails(card, seed):
    cfg, mix = harness.by_name(CELL)
    got = control.train_readings(cfg, mix, seed, card, program=False,
                                 precision="tf32")["control"]
    limits = harness.limits(CELL)
    assert any(got[k] > limits[k] for k in limits), got
