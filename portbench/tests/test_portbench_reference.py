"""Each plain reference against the port at a tiny size on the CPU."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from portbench import program
from portbench.reference import ctr
from portbench.tests.portbench_tiny import ROOT, run_cell, shrink
from portbench.traffic import criteo


def _cfg(name):
    with open(os.path.join(ROOT, "portbench", "configs",
                           f"{name}.json")) as f:
        cfg = json.load(f)
    return shrink(cfg, {"loop": "train"})[0]


@pytest.mark.parametrize("name", ["deepfm_criteo", "dlrm_criteo_tb"])
def test_forward_matches_the_program_model(name):
    from paddlebox_tpu_torch import weights
    cfg = _cfg(name)
    gen = torch.Generator().manual_seed(5)
    params = ctr.make_params(cfg, gen, "cpu")
    model = program.model(cfg)
    weights.load_model_params(model, program.param_tree(params))
    b, s, d = 32, cfg["num_sparse"], cfg["embedding_dim"]
    rows = torch.randn(b, s, 3 + d, generator=gen)
    dense = torch.randn(b, cfg["num_dense"], generator=gen)
    mask = torch.ones(b, s, dtype=torch.bool)
    got = model(rows, mask, dense, np.arange(s), s)
    want = ctr.family(cfg).forward(cfg, params, rows[..., 2],
                                   rows[..., 3:], dense, "float32")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["deepfm_criteo", "dlrm_criteo_tb"])
def test_init_rows_match_the_program_store(name):
    from paddlebox_tpu_torch.embedding import HostEmbeddingStore
    cfg = _cfg(name)
    keys = criteo.unique_keys(criteo.key_of(3, torch.arange(100)))
    store = HostEmbeddingStore(program.embedding_config(cfg))
    np.testing.assert_array_equal(store.peek_rows(keys),
                                  ctr.init_rows(cfg, keys))


@pytest.mark.parametrize("workload", ["deepfm_criteo.train",
                                      "dlrm_criteo_tb.train",
                                      "deepfm_criteo.serve"])
def test_tiny_run_agrees_with_the_reference(workload):
    res = run_cell(workload)
    assert res["correct"], res["checks"]
    for name, c in res["checks"].items():
        assert c["value"] <= c["limit"], name
