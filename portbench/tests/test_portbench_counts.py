"""The frozen FLOP and byte arithmetic against hand-worked shapes."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from portbench import program
from portbench.counts import flops, sectors
from portbench.drivers import train

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "configs")


def _cfg(name):
    with open(os.path.join(CONFIGS, f"{name}.json")) as f:
        return json.load(f)


def test_deepfm_flops_by_hand():
    # deep net 26 * 11 + 13 = 299 -> 400 -> 400 -> 400 -> 1:
    # 299*400 + 400*400 + 400*400 + 400*1 = 440,000 multiply-adds, 2 FLOPs
    # each, forward + weight grad + input grad
    assert flops.train_flops_per_example(_cfg("deepfm_criteo")) == \
        3 * 2 * 440_000


def test_dlrm_flops_by_hand():
    cfg = _cfg("dlrm_criteo_tb")
    bottom = 13 * 512 + 512 * 256 + 256 * 128
    top = (128 + 351 + 26) * 1024 + 1024 * 1024 + 1024 * 512 \
        + 512 * 256 + 256
    gram = 27 * 27 * 128
    want = 2 * (3 * bottom - 13 * 512) + 2 * 3 * gram + 2 * 3 * top
    assert flops.train_flops_per_example(cfg) == want
    # about 6x DeepFM's
    assert 5 < want / flops.train_flops_per_example(
        _cfg("deepfm_criteo")) < 6


@pytest.mark.parametrize("stride,width,rows,want", [
    # 13 floats (52 B) at a 15-float (60 B) stride: rows 0 and 1 cover
    # bytes [0, 52) and [60, 112): sectors 0-1 and 1-3 -> 4 sectors
    (15, 13, [0, 1], 4 * 32),
    # one row of 131 floats (524 B) from byte 0: 17 sectors
    (131, 131, [0], 17 * 32),
    # row 5 starts at byte 2620, inside sector 81, and ends in sector 98:
    # 18 sectors; the same row twice is moved once
    (131, 131, [5, 5], 18 * 32),
])
def test_sector_bytes_by_hand(stride, width, rows, want):
    r = torch.tensor(rows)
    assert sectors.sector_bytes((sectors.row_starts(r, stride),
                                 width * 4)) == want


def test_pull_and_push_bytes_by_hand():
    rows = torch.tensor([[0, 1], [1, 0]])      # 4 tokens, 2 distinct rows
    # ids 16 B -> 1 sector; rows 0-1 at stride 15 reading 13 floats: 4
    # sectors; output 4 tokens x 13 floats = 208 B -> 7 sectors
    assert sectors.pull_bytes(rows, 15, 13, 4 * 13) == (1 + 4 + 7) * 32
    # 4 tokens x (11 grads + id + show + clk) x 4 B = 224 B -> 7 sectors;
    # rows 0-1, 15 floats each at stride 15: 120 B -> 4 sectors, twice
    assert sectors.push_bytes(rows, 15, 15, 11) == (7 + 2 * 4) * 32


def test_one_hot_pull_bytes_as_before():
    """The pull's output counted pooled (examples x slots x width) is the
    per-token count at one id a slot: the value recorded from the count
    before it pooled."""
    gen = torch.Generator().manual_seed(7)
    idx = torch.randint(0, 5000, (64, 26), generator=gen).numpy()
    assert train.pull_bytes(idx.astype(np.int32), 26, 133, 131) == 1650752
    # a multi-hot batch of 2 ids a slot writes the same pooled output
    wide = np.repeat(idx, 2, axis=1)
    assert train.pull_bytes(wide, 26, 133, 131) == \
        1650752 + sectors.dense_bytes(wide.size * 4) \
        - sectors.dense_bytes(idx.size * 4)


@pytest.mark.parametrize("name", ["deepfm_criteo", "dlrm_criteo_tb"])
def test_one_hot_schema_as_before(name):
    from paddlebox_tpu_torch.data import DataFeedSchema
    cfg = _cfg(name)
    want = DataFeedSchema.ctr(num_sparse=26, num_float=13,
                              batch_size=8192, max_len=1)
    assert program.schema(cfg) == want
    assert program.schema(dict(cfg, hotness=[1] * 26)) == want
