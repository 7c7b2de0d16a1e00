"""The traffic generator: deterministic by seed, keys invertible, ranks
inside each field and skewed."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.traffic import criteo

CFG = {"cardinalities": [3, 1000, 40_000_000], "zipf_exponent": 1.1,
       "num_dense": 13}


def _draw(seed):
    gen = torch.Generator().manual_seed(seed)
    return criteo.draw_examples(gen, 4096, CFG, "cpu")


def test_same_seed_same_examples():
    a, b, c = _draw(2**31 + 5), _draw(2**31 + 5), _draw(2**31 + 6)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])


def test_keys_invert_to_field_and_rank():
    gen = torch.Generator().manual_seed(7)
    for f, card in enumerate(CFG["cardinalities"]):
        ranks = criteo.power_law_ranks(gen, 10000, card, 1.1, "cpu")
        assert int(ranks.min()) >= 0 and int(ranks.max()) < card
        field, back = criteo.rank_of(criteo.key_of(f, ranks))
        assert torch.equal(back, ranks)
        assert bool((field == f).all())


def test_ranks_are_skewed():
    gen = torch.Generator().manual_seed(11)
    r = criteo.power_law_ranks(gen, 200_000, 40_000_000, 1.1, "cpu")
    # the 1000 hottest of 40M ranks draw a third of the ids or more
    assert float((r < 1000).float().mean()) > 0.33
    # and the draws still reach deep into the tail
    assert int(r.max()) > 1_000_000


def test_records_and_unique_keys():
    from paddlebox_tpu_torch.data import DataFeedSchema
    keys, label, dense = _draw(3)
    schema = DataFeedSchema.ctr(num_sparse=3, num_float=13, batch_size=64)
    rec = criteo.records(schema, keys, label, dense)
    assert rec.num == 4096
    assert np.array_equal(np.sort(rec.unique_keys().astype(np.uint64)),
                          criteo.unique_keys(keys))


# sha256 of draw_examples' keys, labels and dense floats (their bytes, in
# that order) for 2048 examples from seed 2^31 + 5 on the CPU, recorded
# from the generator before it took a hotness: at one id a field it
# makes the same calls
ONE_HOT_DIGESTS = {
    "deepfm_criteo":
        "923fb351ccdc2e005e9de787504d6277b3c9889e3b77170971791b1c259a139c",
    "dlrm_criteo_tb":
        "11ad547fa983e926629c1f6a27a30e7129e6d524236e1d0961d78e867a44a58a",
}


@pytest.mark.parametrize("name", sorted(ONE_HOT_DIGESTS))
@pytest.mark.parametrize("hotness", [None, 1], ids=["absent", "ones"])
def test_hotness_one_draws_as_before(name, hotness):
    cfg = harness.config(name)
    if hotness is not None:
        cfg["hotness"] = [hotness] * cfg["num_sparse"]
    gen = torch.Generator().manual_seed(2**31 + 5)
    h = hashlib.sha256()
    for t in criteo.draw_examples(gen, 2048, cfg, "cpu"):
        h.update(t.contiguous().numpy().tobytes())
    assert h.hexdigest() == ONE_HOT_DIGESTS[name]
