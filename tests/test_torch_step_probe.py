"""The port's step probe (``paddlebox_tpu_torch.utils.step_probe``) and
the ablated train step it instruments, against the JAX package's:

- one step of each ``ablate`` variant from the same carried-over weights
  and table, the port's ``Trainer.train_step(ablate=...)`` against JAX's
  ``_build_train_step(ablate=...)``, one-hot and multi-hot (the fused
  pull), at the trainer tests' tolerances;
- ``attribute_step`` on the CPU: the reference's output keys, stages
  that telescope to the single step, and the call accounting the card
  check predicts launches from;
- ``push_floor_analysis`` / ``finalize_push_floor`` on the reference's
  cases (tests/test_scatter_accumulate.py): every candidate engine's
  statement, the fused engine's floor scaling with unique lanes, the
  premerge and binned-knob notes, the closure statements;
- the card's numbers in one place (``chip_smoke.py`` imports them).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from paddlebox_tpu.config import flags as jflags
from paddlebox_tpu.embedding import PassWorkingSet as JaxWS
from paddlebox_tpu.utils import step_probe as jprobe

from paddlebox_tpu_torch import weights
from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.embedding import EmbeddingConfig, PassWorkingSet
from paddlebox_tpu_torch.ops import kernels
from paddlebox_tpu_torch.utils import step_probe

from tests.test_torch_trainer import (BATCH, DENSE_DIM, LOSS_TOL, MLP_TOL,
                                      NUM_SLOTS, TABLE_TOL, _assert_params,
                                      _jax, _port)

torch.set_num_threads(1)

VARIANTS = ((), ("push",), ("lookup",), ("fwdbwd",), ("push", "lookup"),
            ("push", "lookup", "fwdbwd"))


def _one_step_pair(emb_dim, max_len, ablate):
    """The same first step through both packages with ``ablate``."""
    jstore, jtr, mesh = _jax(emb_dim, max_len)
    jparams = jax.tree.map(np.asarray, jtr.params)
    store, tr = _port(emb_dim, max_len, jparams)
    rng = np.random.default_rng(11)
    keys = np.unique(rng.choice(1 << 40, 300).astype(np.uint64))
    jws = JaxWS.begin_pass(jstore, keys, mesh)
    ws = PassWorkingSet.begin_pass(store, keys, device="cpu")
    weights.load_table(ws, np.asarray(jws.table))
    T = NUM_SLOTS * max_len
    raw = rng.choice(keys, size=(BATCH, T))
    mask = rng.random((BATCH, T)) < 0.9
    idx = ws.translate(raw, mask)
    dense = rng.normal(size=(BATCH, DENSE_DIM)).astype(np.float32)
    labels = (rng.random(BATCH) < 0.3).astype(np.float32)
    loss, preds = tr.train_step(ws.table, *tr.stage(
        tr.pack_arrays(ws, idx, mask, dense, labels)), ablate=ablate)
    fn = jtr._build_train_step(ablate=ablate)
    out = fn(jws.table, *jtr.pack_dense(), idx, mask, dense, labels,
             *jtr._host_plan(jws, idx))
    table, dstate, jloss, jpreds, _ = jtr.split_step_out(out)
    return (float(loss), preds.numpy(), ws.table.numpy(),
            weights.deepfm_params(tr.model), tr.pull_engine,
            float(jloss), np.asarray(jpreds), np.asarray(table),
            jax.tree.map(np.asarray, jtr.unpack_dense(dstate)[0]),
            jtr.pull_engine)


@pytest.mark.parametrize("max_len", [1, 4], ids=["onehot", "multihot"])
@pytest.mark.parametrize("ablate", VARIANTS,
                         ids=["-".join(v) or "full" for v in VARIANTS])
def test_ablated_step_matches_reference(max_len, ablate):
    (loss, preds, table, params, engine, jloss, jpreds, jtable, jparams,
     jengine) = _one_step_pair(8, max_len, ablate)
    assert engine == jengine
    np.testing.assert_allclose(loss, jloss, **LOSS_TOL)
    np.testing.assert_allclose(preds, jpreds, **MLP_TOL)
    np.testing.assert_allclose(table, jtable, **TABLE_TOL)
    _assert_params(params, jparams)


def test_ablation_semantics():
    """The stand-ins: "push" leaves the table's bits alone, "fwdbwd"
    returns loss = sum(pulled) * 1e-8 with zero predictions, "lookup" +
    "fwdbwd" a zero loss; the dense optimizer still steps (with zero
    grads, its moments from the trained pass move the params), as in the
    reference."""
    from paddlebox_tpu_torch.embedding import sharded
    from tests.test_torch_resume import _dataset, _make
    _, tr, _ = _make("port", max_len=1, carry=False)
    ds = _dataset("port", tr, 1, max_len=1)
    out = tr.train_pass(ds)
    assert out["steps"] > 0
    ws = tr.last_ws
    pb = next(iter(ds.batches(tr.cfg.global_batch_size)))
    idx = ws.translate(pb.ids, pb.mask)
    labels, dense = tr.split_floats(pb.floats)
    staged = tr.stage(tr.pack_arrays(ws, idx, pb.mask, dense, labels))
    before = ws.table.clone()
    tr.train_step(ws.table, *staged, ablate=("push",))
    assert torch.equal(ws.table, before)
    p0 = [p.detach().clone() for p in tr.params]
    loss, preds = tr.train_step(ws.table, *staged,
                                ablate=("push", "fwdbwd"))
    pulled = sharded.lookup(ws.table, staged[0], tr.store.cfg)
    assert torch.equal(preds, torch.zeros_like(preds))
    assert float(loss) == pytest.approx(float(pulled.sum()) * 1e-8,
                                        rel=1e-5)
    loss0, _ = tr.train_step(ws.table, *staged,
                             ablate=("push", "lookup", "fwdbwd"))
    assert float(loss0) == 0.0
    assert not all(torch.equal(a, b) for a, b in zip(p0, tr.params))
    with pytest.raises(ValueError, match="defer"):
        tr.train_step(ws.table, *staged, defer=True, ablate=("push",))


# ---------------------------------------------------------------------------
# attribute_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_len", [1, 4], ids=["onehot", "multihot"])
def test_attribute_step_keys_and_accounting(max_len):
    from tests.test_torch_resume import _dataset, _make
    _, tr, _ = _make("port", max_len=max_len, carry=False)
    ds = _dataset("port", tr, 1, max_len=max_len)
    out = tr.train_pass(ds)
    ws = tr.last_ws
    pb = next(iter(ds.batches(tr.cfg.global_batch_size)))
    idx = ws.translate(pb.ids, pb.mask)
    labels, dense = tr.split_floats(pb.floats)
    staged = tr.stage(tr.pack_arrays(ws, idx, pb.mask, dense, labels))
    head = out["step_seconds"] / out["steps"]
    att = step_probe.attribute_step(tr, ws, staged, head, windows=2)
    ref_keys = {"stages", "isolated", "push_overlap", "overlap_ab",
                "attributed_seconds", "single_step_seconds",
                "headline_step_seconds", "unattributed_seconds",
                "coverage", "method_overlap", "method"}
    assert ref_keys <= set(att) and set(att) - ref_keys == {"calls"}
    assert set(att["stages"]) == {"sparse_push", "lookup", "dense_fwd_bwd",
                                  "glue_residual", "dispatch_floor"}
    assert set(att["isolated"]) == {"lookup", "dense_fwd_bwd",
                                    "sparse_push"}
    assert sum(att["stages"].values()) == pytest.approx(
        att["single_step_seconds"], abs=1e-5)
    assert att["coverage"] == pytest.approx(1.0, abs=0.01)
    assert att["headline_step_seconds"] == round(head, 6)
    assert att["unattributed_seconds"] == pytest.approx(
        head - att["attributed_seconds"], abs=1e-5)
    assert att["push_overlap"] == "on" and att["overlap_ab"] is not None
    calls = att["calls"]
    # each timed stage: 2 windows of (1 warm-up + k = 1 timed call)
    for name in ("step", "ablate_push", "ablate_push_lookup",
                 "ablate_push_lookup_fwdbwd", "floor", "overlap_pair",
                 "overlap_loss_path", "isolated_fwd_bwd", "isolated_push"):
        assert calls[name] == 4, (name, calls)
    assert calls["isolated_lookup"] == 5
    assert calls["overlap_applies"] == calls["overlap_pair"]
    assert tr._push_stager.pending() == 0


def test_time_ms_and_timed_repeat_on_the_host():
    n = []
    ms = step_probe.time_ms(lambda: n.append(1), iters=5, warmup=2,
                            device="cpu")
    assert ms >= 0 and len(n) == 7
    calls = {}
    s = step_probe.timed_repeat(lambda x: x + 1, (1,), k=3, windows=2,
                                device="cpu", calls=calls, name="f")
    assert s >= 0 and calls == {"f": 8}


# ---------------------------------------------------------------------------
# push floors (the reference's cases, tests/test_scatter_accumulate.py)
# ---------------------------------------------------------------------------

@pytest.fixture
def engine_flag():
    old = (flags.push_engine, flags.binned_push)
    yield
    flags.push_engine, flags.binned_push = old


def test_push_floor_per_engine_statements(engine_flag):
    c = EmbeddingConfig(dim=8, optimizer="adagrad", learning_rate=0.05)
    peaks = (67e12, 3.35e12)
    fl = step_probe.push_floor_analysis(c, 1 << 16, 213_000, peaks=peaks,
                                        premerged=True, unique_lanes=40_000)
    assert set(fl["engines"]) == set(kernels.PUSH_ENGINES)
    assert fl["engine"] == "scatter_accumulate"
    assert set(fl["stages"]) == {"plan_h2d", "kernel_dma", "onehot_dots",
                                 "fused_update"}
    assert fl["stages"]["onehot_dots"]["flops"] == 0.0
    assert "no one-hot matrix merge" in fl["stages"]["onehot_dots"]["note"]
    for e in fl["engines"].values():
        assert "closed" in e and e["floor_seconds"] > 0
    sa = fl["engines"]["scatter_accumulate"]["floor_seconds"]
    assert sa < fl["engines"]["xla_scatter"]["floor_seconds"]
    assert fl["best_engine"] == "scatter_accumulate"
    step_probe.finalize_push_floor(fl, measured_push=1.0)
    assert fl["closed"].startswith("measured")
    assert all(isinstance(e["closed"], str) for e in fl["engines"].values())
    step_probe.finalize_push_floor(fl, measured_push=sa * 2)
    assert fl["engines"]["scatter_accumulate"]["closed"] is True
    assert fl["closed"] is True


def test_push_floor_unpremerged_names_the_premerge_requirement():
    c = EmbeddingConfig(dim=8, optimizer="adagrad", learning_rate=0.05)
    fl = step_probe.push_floor_analysis(c, 1 << 16, 213_000,
                                        peaks=(67e12, 3.35e12))
    assert "premerged" in fl["engines"]["scatter_accumulate"]["note"]
    assert fl["engine"] == "binned_kernel"        # auto on the card
    fl_cpu = step_probe.push_floor_analysis(c, 1 << 16, 213_000,
                                            device_type="cpu")
    assert fl_cpu["engine"] == "xla_scatter"
    assert fl_cpu["floor_seconds"] is None        # no peaks: abstains
    assert fl_cpu["closed"].startswith("no peak table")


def test_binned_enable_knob_named_in_the_floor(engine_flag):
    c = EmbeddingConfig(dim=8, optimizer="adagrad", learning_rate=0.05)
    flags.binned_push = False
    fl = step_probe.push_floor_analysis(c, 1 << 16, 213_000,
                                        peaks=(67e12, 3.35e12))
    assert "flags.binned_push is off" in fl["engines"]["binned_kernel"][
        "note"]
    assert fl["engine"] == "xla_scatter"
    flags.push_engine = "binned_kernel"           # a force ignores it
    assert step_probe.push_floor_analysis(
        c, 1 << 16, 213_000)["engine"] == "binned_kernel"


@pytest.mark.parametrize("measured,closes", [(None, False), (1e-9, True),
                                             (1.0, False)])
def test_finalize_push_floor_matches_reference(measured, closes):
    """finalize_push_floor closes the same statement the reference's does
    on the same dict: the same closure per engine, the same best engine
    (the alarm text's tail names each package's knobs)."""
    def statement():
        return {"engine": "binned_kernel", "floor_seconds": 2e-5,
                "engines": {"binned_kernel": {"floor_seconds": 2e-5},
                            "scatter_accumulate": {"floor_seconds": 1e-5},
                            "xla_scatter": {"floor_seconds": None}}}
    mine, ref = statement(), statement()
    step_probe.finalize_push_floor(mine, measured)
    jprobe.finalize_push_floor(ref, measured)
    assert mine["best_engine"] == ref["best_engine"] == "scatter_accumulate"
    for name in mine["engines"]:
        assert mine["engines"][name]["closed"] == ref["engines"][name][
            "closed"]
    assert (mine["closed"] is True) == (ref["closed"] is True) == closes
    if not closes:
        assert mine["closed"][:30] == ref["closed"][:30]


def test_union_sector_bytes():
    u = step_probe._union_sector_bytes
    assert u(1000, 64, [(0, 64, 1.0)]) == pytest.approx(64_000)
    assert u(1000, 52, [(0, 52, 0.0)]) == 0
    # a 4-byte field of every 48-byte row sits in its own sector
    assert u(1024, 48, [(44, 4, 1.0)]) == pytest.approx(1024 * 32)
    # touched rows share sectors with their neighbours: the union is less
    # than the rows' own sectors, more than their bytes
    p = 0.33
    got = u(1 << 19, 52, [(0, 52, p)])
    assert 52 * p * (1 << 19) < got < 96 * p * (1 << 19)


def test_card_numbers_have_one_source():
    import chip_smoke
    assert chip_smoke.HBM_BYTES_PER_S is step_probe.HBM_BYTES_PER_S
    assert chip_smoke.FP32_OPS_PER_S is step_probe.FP32_OPS_PER_S
    assert chip_smoke.SECTOR == step_probe.SECTOR == 32
    assert chip_smoke.time_ms is step_probe.time_ms
    assert step_probe.PEAKS["NVIDIA H100 80GB HBM3"] == (67e12, 3.35e12)
    assert chip_smoke.bound(3.35e9, 0) == (1.0, "bytes")
    if not torch.cuda.is_available():
        assert step_probe.device_peaks() is None
    assert step_probe.device_peaks("cpu") is None
    assert jflags.push_engine == "auto"
