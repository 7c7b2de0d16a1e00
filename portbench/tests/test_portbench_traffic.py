"""The traffic generator: deterministic by seed, keys invertible, ranks
inside each field and skewed."""

from __future__ import annotations

import numpy as np
import torch

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
