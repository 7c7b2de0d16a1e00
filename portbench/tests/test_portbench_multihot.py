"""Per-field hotness: the generator's layout, the schema, the reference's
pooling, and tiny runs through the real loop at uneven and even
hotness, each pull engine the program picks for them."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import harness, program
from portbench.drivers import train
from portbench.reference import ctr
from portbench.tests.portbench_tiny import UNEVEN, run_cell, shrink
from portbench.traffic import criteo

HOT = [3, 1, 2]
CFG = {"cardinalities": [3, 1000, 40_000_000], "zipf_exponent": 1.1,
       "num_dense": 13, "num_sparse": 3, "hotness": HOT, "batch_size": 64}


def test_each_fields_ids_sit_together():
    keys, _, _ = criteo.draw_examples(torch.Generator().manual_seed(5),
                                      512, CFG, "cpu")
    assert keys.shape == (512, sum(HOT))
    field, rank = criteo.rank_of(keys)
    want = np.repeat(np.arange(3), HOT)
    assert bool((field == torch.from_numpy(want)).all())
    # field f's ids: one draw of n * h ranks, example after example
    gen = torch.Generator().manual_seed(5)
    first = criteo.power_law_ranks(gen, 512 * 3, 3, 1.1, "cpu")
    assert torch.equal(rank[:, :3], first.reshape(512, 3))


def test_schema_and_records_at_multi_hot():
    sch = program.schema(CFG)
    assert [s.max_len for s in sch.sparse_slots] == HOT
    keys, label, dense = criteo.draw_examples(
        torch.Generator().manual_seed(6), 100, CFG, "cpu")
    rec = criteo.records(sch, keys, label, dense)
    for f, (h, e) in enumerate(zip(HOT, np.cumsum(HOT))):
        assert np.array_equal(rec.sparse_offsets[f],
                              np.arange(101) * h)
        assert np.array_equal(rec.sparse_values[f],
                              keys[:, e - h:e].reshape(-1).numpy())
    assert np.array_equal(np.sort(rec.unique_keys().astype(np.uint64)),
                          criteo.unique_keys(keys))
    # slots of one hotness share one offsets array, as at one id a slot
    one = dict(CFG, hotness=[1, 1, 1])
    rec = criteo.records(program.schema(one), *criteo.draw_examples(
        torch.Generator().manual_seed(6), 100, one, "cpu"))
    assert all(o is rec.sparse_offsets[0] for o in rec.sparse_offsets)


@pytest.mark.parametrize("bad", [[1, 2], [1, 0, 1]])
def test_a_hotness_that_does_not_fit_is_refused(bad):
    with pytest.raises(harness.BenchError, match="hotness"):
        harness.hotness(dict(CFG, hotness=bad))


def test_reference_pools_per_slot():
    t = torch.arange(2 * 6 * 2, dtype=torch.float32).reshape(2, 6, 2)
    got = ctr.pool(CFG, t)
    want = torch.stack([t[:, :3].sum(1), t[:, 3], t[:, 4:].sum(1)], dim=1)
    assert torch.equal(got, want)
    one = dict(CFG, hotness=[1, 1, 1])
    x = t[:, :3]
    # one id a slot, stated or by default: nothing pools
    assert ctr.pool(one, x) is x
    assert ctr.pool({"num_sparse": 3}, x) is x


@pytest.mark.parametrize("hotness,engine", [
    (UNEVEN, "gather_seqpool"), ([2] * 26, "fused_gather_pool")],
    ids=["uneven", "even"])
def test_the_program_pull_at_multi_hot(hotness, engine):
    """Uneven hotness takes the plain gather and the model's seqpool, an
    even one the fused pooled pull (its CPU twin here)."""
    cfg, _ = shrink(harness.config("dlrm_criteo_tb"), {"loop": "train"})
    cfg = dict(cfg, hotness=hotness,
               cardinalities=[min(c, 500) for c in cfg["cardinalities"]])
    *_, tr, _ = train.build(cfg, 5, torch.device("cpu"))
    try:
        assert tr.layout.total_len == sum(hotness)
        assert tr.pull_engine == engine
    finally:
        tr.feed_mgr.close()


@pytest.mark.parametrize("hotness", [UNEVEN, [2] * 26],
                         ids=["uneven", "even"])
def test_multi_hot_run_agrees_with_the_pooling_reference(hotness):
    res = run_cell("dlrm_criteo_tb.train", cfg={"hotness": hotness})
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0
