"""Data and recipes shared by the port's multi-rank tests.

Imported by the spawned ranks (tests/torch_multirank_worker.py, which
import no JAX) and by the pytest side (tests/test_torch_multirank_train.py,
tests/test_torch_exchange.py), which builds the JAX references from the
same NumPy arrays. Everything here is NumPy only.
"""

from __future__ import annotations

import numpy as np

NUM_SLOTS = 4
DIM = 4
DENSE_DIM = 1
HIDDEN = (8,)
BATCH = 32
N_EXAMPLES = 12 * BATCH
KEY_SPACE = 40
AUC_BUCKETS = 1 << 12
DENSE_LR = 1e-2
SPARSE_LR = 0.1
PASSES = 2
LOSS_REL = 2e-5
AUC_ABS = 2e-4
TABLE_TOL = dict(rtol=1e-4, atol=1e-6)

# op-level exchange cases: the table rows per shard and the tokens per
# rank (routed pull / pooled pull / push)
OPS_RPS = 24
OPS_TOKENS = 64
OPS_B, OPS_S, OPS_L = 8, 4, 2


def dataset_arrays(max_len: int, n_ex: int = N_EXAMPLES, seed: int = 0,
                   skew: bool = False, batch: int = BATCH) -> dict:
    """Columnar arrays of a learnable synthetic CTR set: per slot, 1 to
    ``max_len`` signs per example (slot-salted), a click label that
    follows latent per-key weights, one dense float. ``skew``: distinct
    contiguous keys per batch, one per token (no dedup can shrink it)."""
    rng = np.random.default_rng(seed)
    weight = np.random.default_rng(99).normal(
        size=(NUM_SLOTS, KEY_SPACE)) * 1.5
    values, offsets = [], []
    logit = np.zeros(n_ex)
    e = np.arange(n_ex, dtype=np.int64)
    for s in range(NUM_SLOTS):
        if skew:
            lens = np.ones(n_ex, np.int64)
            raw = (e // batch) * 100_000 + (e % batch) * NUM_SLOTS + s
            ids = raw % KEY_SPACE
        else:
            lens = rng.integers(1, max_len + 1, size=n_ex)
            ids = rng.integers(0, KEY_SPACE, size=int(lens.sum()))
            raw = ids
        off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        np.add.at(logit, np.repeat(e, lens), weight[s, ids])
        values.append((raw.astype(np.int64) | (np.int64(s + 1) << 40)))
        offsets.append(off)
    p = 1.0 / (1.0 + np.exp(-0.8 * logit))
    label = (rng.random(n_ex) < p).astype(np.float32)
    dense = rng.normal(size=n_ex).astype(np.float32)
    return {"num": n_ex, "values": values, "offsets": offsets,
            "floats": [label, dense]}


def make_records(mod, schema, arr: dict):
    """A package's SlotRecordBatch (``mod`` = its data.slot_record
    module) from ``dataset_arrays``."""
    n = arr["num"]
    return mod.SlotRecordBatch(
        schema=schema, num=n,
        sparse_values=[v.copy() for v in arr["values"]],
        sparse_offsets=[o.copy() for o in arr["offsets"]],
        float_values=[f.copy() for f in arr["floats"]],
        ins_id=np.zeros(n, np.uint64), search_id=np.zeros(n, np.uint64),
        rank=np.zeros(n, np.int32), cmatch=np.zeros(n, np.int32))


def lattice(rng, shape) -> np.ndarray:
    """Exact-arithmetic values: multiples of 2^-10 in [-0.5, 0.5), so
    sums of a few hundred stay exact in f32 in any order."""
    return (rng.integers(-512, 512, size=shape) / 1024.0).astype(np.float32)


def ops_case(world: int, row_width: int, grad_width: int,
             seed: int = 3) -> dict:
    """One exchange op case: the global table (world * OPS_RPS rows, the
    null row 0 zero, show/clk columns non-negative), every rank's tokens
    (flat (world * OPS_TOKENS,), ~20% null) and their push payloads, and
    the pooled case's (world * OPS_B, S * L) index block."""
    rng = np.random.default_rng(seed)
    n_rows = world * OPS_RPS
    table = lattice(rng, (n_rows, row_width))
    table[:, :2] = np.abs(table[:, :2]) * 8
    table[0] = 0.0
    n = world * OPS_TOKENS
    idx = rng.integers(1, n_rows, size=n).astype(np.int32)
    idx[rng.random(n) < 0.2] = 0
    grads = lattice(rng, (n, grad_width))
    grads[idx == 0] = 0.0
    shows = (idx > 0).astype(np.float32)
    clks = (rng.integers(0, 2, n) * shows).astype(np.float32)
    pidx = rng.integers(1, n_rows, size=(world * OPS_B,
                                         OPS_S * OPS_L)).astype(np.int32)
    pidx[rng.random(pidx.shape) < 0.3] = 0
    return {"table": table, "idx": idx, "grads": grads, "shows": shows,
            "clks": clks, "pidx": pidx}
