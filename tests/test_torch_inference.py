"""The port's inference layer against the JAX package's, both ways:

- the per-row codec (``embedding/quant.py``) bit-equal, and the host
  presence gate (``gate_pull_np``) equal, to the reference's;
- ``ServingTable``: lookup (hits, misses, gate, mask), delta merge and
  drop, save/load across packages (``serving.npz`` stored
  uncompressed);
- ``HostEmbeddingStore.export_serving`` equal after the same operations;
- ``model.json`` equal key for key for all seven families (bf16
  included);
- an export written by one package scored by the other's ``Predictor``,
  and the same batch scored by both, within the zoo tests' forward
  tolerance (rtol 1e-5 / atol 1e-6 on the probabilities; DLRM in bf16 at
  the zoo's bf16 tolerance); MMoE's multi-task predictor too;
- ``Predictor.with_model`` builds a fresh module and never writes into
  the one a live version serves from, nor into the caller's model.

Small sizes (3-4 slots, dim 4-8, hidden ≤ 16, batch ≤ 32), device="cpu".
"""

import json
import os
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddlebox_tpu import models as jmodels
from paddlebox_tpu.data import DataFeedSchema as JaxSchema
from paddlebox_tpu.embedding import EmbeddingConfig as JaxCfg
from paddlebox_tpu.embedding import HostEmbeddingStore as JaxStore
from paddlebox_tpu.embedding import gating as jgating
from paddlebox_tpu.embedding import quant as jquant
from paddlebox_tpu.inference import Predictor as JaxPredictor
from paddlebox_tpu.inference import ServingTable as JaxTable
from paddlebox_tpu.inference import model_config as jax_model_config
from paddlebox_tpu.inference import save_inference_model as jax_save

from paddlebox_tpu_torch import models, weights
from paddlebox_tpu_torch.data import DataFeedSchema
from paddlebox_tpu_torch.embedding import EmbeddingConfig, HostEmbeddingStore
from paddlebox_tpu_torch.embedding import quant
from paddlebox_tpu_torch.embedding.gating import GateSpec, gate_pull_np
from paddlebox_tpu_torch.inference import (Predictor, ServingTable,
                                           load_inference_model,
                                           model_config,
                                           save_inference_model)

torch.set_num_threads(1)

S, DENSE, DIM, L = 3, 2, 4, 2
FWD_TOL = dict(rtol=1e-5, atol=1e-6)      # tests/test_torch_zoo.py
BF16_TOL = dict(rtol=1e-2, atol=1e-2)     # tests/test_torch_zoo.py

WIDTHS = {
    "dnn_ctr": dict(hidden=(16, 8)),
    "deepfm": dict(hidden=(16, 8)),
    "wide_deep": dict(hidden=(16, 8)),
    "dcn_v2": dict(hidden=(16, 8), num_cross_layers=2),
    "dlrm": dict(bottom_hidden=(16,), top_hidden=(16, 8)),
    "mmoe": dict(num_experts=3, num_tasks=2, expert_hidden=(16,),
                 expert_out=8, tower_hidden=(8,)),
    "pv_rank": dict(hidden=(16, 8), max_rank=3, slot_proj=4, att_dim=4),
}
# (family, bf16): every family, and the bf16 compute dtype of two
CONFIGS = [(n, False) for n in sorted(WIDTHS)] + [("dlrm", True),
                                                  ("deepfm", True)]
# PV-rank scores need a per-batch rank_offset, which neither package's
# Predictor builds
SCORED = [c for c in CONFIGS if c[0] != "pv_rank"]


def _ids(c):
    return f"{c[0]}-bf16" if c[1] else c[0]


def _pair(name, bf16=False, seed=3):
    jkw = dict(compute_dtype=jnp.bfloat16) if bf16 else {}
    pkw = dict(compute_dtype=torch.bfloat16) if bf16 else {}
    jm = jmodels.MODEL_REGISTRY[name](S, DIM, DENSE, **WIDTHS[name], **jkw)
    pm = models.MODEL_REGISTRY[name](S, DIM, DENSE, **WIDTHS[name], **pkw)
    jparams = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    weights.load_model_params(pm, jparams)
    return jm, pm, jparams


def _schemas(batch=32):
    return (JaxSchema.ctr(num_sparse=S, num_float=DENSE, batch_size=batch,
                          max_len=L),
            DataFeedSchema.ctr(num_sparse=S, num_float=DENSE,
                               batch_size=batch, max_len=L))


def _plane(n=200, seed=0, width=3 + DIM):
    """Random keys and pull rows with counter-like show/clk columns."""
    rng = np.random.default_rng(seed)
    keys = rng.choice(1 << 50, n, replace=False).astype(np.uint64)
    vals = rng.normal(scale=0.3, size=(n, width)).astype(np.float32)
    vals[:, 0] = rng.integers(0, 9, n)
    vals[:, 1] = np.minimum(vals[:, 0], rng.integers(0, 3, n))
    return keys, vals


def _request(keys, B=32, seed=1):
    """ids (some misses), a mask, dense floats."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(keys, (B, S * L)).astype(np.uint64)
    miss = rng.random((B, S * L)) < 0.1
    ids[miss] = rng.integers(1, 1 << 40, int(miss.sum()), dtype=np.uint64)
    mask = rng.random((B, S * L)) < 0.85
    dense = rng.normal(size=(B, DENSE)).astype(np.float32)
    return ids, mask, dense


# ---------------------------------------------------------------------------
# the row codec and the gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("storage", ["int8", "int16"])
def test_row_codec_bit_equal_to_reference(storage):
    rng = np.random.default_rng(5)
    x = rng.normal(scale=2.0, size=(64, 9)).astype(np.float32)
    x[3] = 0.0                           # the scale floor
    x[4, 2] = 1e-30                      # a subnormal-scale row
    q, scale = quant.quantize_rows_np(x, storage)
    jq, jscale = jquant.quantize_rows_np(x, storage)
    assert q.dtype == jq.dtype and scale.dtype == jscale.dtype
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(scale.view(np.uint32),
                                  jscale.view(np.uint32))
    np.testing.assert_array_equal(
        quant.dequantize_rows_np(q, scale).view(np.uint32),
        jquant.dequantize_rows_np(jq, jscale).view(np.uint32))
    # D == 0 degenerates the same way
    q0, s0 = quant.quantize_rows_np(np.zeros((5, 0), np.float32), storage)
    jq0, js0 = jquant.quantize_rows_np(np.zeros((5, 0), np.float32),
                                       storage)
    assert q0.shape == jq0.shape and np.array_equal(s0, js0)
    cfg = EmbeddingConfig(storage=storage)
    jcfg = JaxCfg(storage=storage)
    assert quant.qmax(cfg) == jquant.qmax(jcfg)
    assert np.dtype(quant.qdtype(cfg)) == np.dtype(jquant.qdtype(jcfg))


@pytest.mark.parametrize("thr", [(0.0, 0.0), (3.0, 0.0), (2.0, 5.0)],
                         ids=["off", "mf", "mf+expand"])
def test_gate_pull_np_matches_reference(thr):
    kw = dict(dim=4, expand_dim=3, mf_create_threshold=thr[0],
              expand_create_threshold=thr[1])
    spec = GateSpec.from_cfg(EmbeddingConfig(**kw))
    jspec = jgating.GateSpec.from_cfg(JaxCfg(**kw))
    assert tuple(spec) == tuple(jspec)
    rng = np.random.default_rng(2)
    pulled = rng.normal(size=(5, 6, spec.fixed_cols + 7)).astype(np.float32)
    pulled[..., 0] = rng.integers(0, 8, (5, 6))
    np.testing.assert_array_equal(gate_pull_np(pulled, spec),
                                  jgating.gate_pull_xp(pulled, jspec, np))


# ---------------------------------------------------------------------------
# ServingTable
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gated", [False, True], ids=["plain", "gated"])
def test_serving_table_lookup_matches_reference(gated):
    keys, vals = _plane()
    gate = GateSpec(3, DIM, 4.0, 0.0) if gated else None
    jgate = jgating.GateSpec(3, DIM, 4.0, 0.0) if gated else None
    t, jt = ServingTable(keys, vals, gate), JaxTable(keys, vals, jgate)
    np.testing.assert_array_equal(t.keys, jt.keys)
    ids, mask, _ = _request(keys)
    got = t.lookup(ids, mask)
    assert got.dtype == np.float32 and got.shape == (32, S * L, 3 + DIM)
    np.testing.assert_array_equal(got, jt.lookup(ids, mask))
    np.testing.assert_array_equal(t.lookup(ids), jt.lookup(ids))
    # misses pull zeros
    miss = ~np.isin(ids, keys)
    assert miss.any() and not t.lookup(ids)[miss].any()
    empty = ServingTable(np.zeros(0, np.uint64),
                         np.zeros((0, 3 + DIM), np.float32))
    assert not empty.lookup(ids).any()


def test_serving_table_duplicate_keys_named():
    keys, vals = _plane(8)
    keys[3] = keys[5]
    with pytest.raises(ValueError, match=str(int(keys[5]))):
        ServingTable(keys, vals)


def test_serving_table_merge_drop_matches_reference(tmp_path):
    keys, vals = _plane()
    t, jt = ServingTable(keys, vals), JaxTable(keys, vals)
    rng = np.random.default_rng(9)
    # a delta at full row width: updates, new keys, a key twice (the last
    # occurrence wins), removals
    upd = np.concatenate([keys[:20], rng.integers(1, 1 << 40, 10,
                                                  dtype=np.uint64),
                          keys[:1]])
    rows = rng.normal(size=(len(upd), 3 + DIM + 5)).astype(np.float32)
    removed = keys[50:60]
    f = str(tmp_path / "delta-00001.npz")
    np.savez(f, keys=upd, rows=rows, removed=removed)
    c = t.copy()
    c.apply_delta_file(f)
    jt.apply_delta_file(f)
    np.testing.assert_array_equal(c.keys, jt.keys)
    np.testing.assert_array_equal(c.vals, jt.vals)
    assert len(c) == len(keys) + 10 - 10
    # the copy is copy-on-write: the original serves its old rows
    np.testing.assert_array_equal(t.lookup(keys), vals)
    np.testing.assert_array_equal(c.lookup(upd[:1])[0], rows[-1, :3 + DIM])
    assert not c.lookup(removed).any()
    # apply_delta_dir in sequence order
    np.savez(str(tmp_path / "delta-00002.npz"), keys=keys[:1],
             rows=np.ones((1, 3 + DIM), np.float32),
             removed=np.zeros(0, np.uint64))
    d, jd = t.copy(), JaxTable(keys, vals)
    assert d.apply_delta_dir(str(tmp_path)) == jd.apply_delta_dir(
        str(tmp_path)) == 2
    np.testing.assert_array_equal(d.vals, jd.vals)


@pytest.mark.parametrize("way", ["port->jax", "jax->port"])
def test_serving_table_save_load_across_packages(tmp_path, way):
    keys, vals = _plane()
    gate = (3, DIM, 2.0, 0.0)
    if way == "port->jax":
        ServingTable(keys, vals, GateSpec(*gate)).save(str(tmp_path))
        got = JaxTable.load(str(tmp_path))
    else:
        JaxTable(keys, vals, jgating.GateSpec(*gate)).save(str(tmp_path))
        got = ServingTable.load(str(tmp_path))
    assert tuple(got.gate) == gate
    np.testing.assert_array_equal(got.keys, np.sort(keys))
    np.testing.assert_array_equal(got.lookup(keys), ServingTable(
        keys, vals, GateSpec(*gate)).lookup(keys))
    with zipfile.ZipFile(tmp_path / "serving.npz") as z:
        assert sorted(z.namelist()) == ["keys.npy", "rows.npy"]
        assert all(i.compress_type == zipfile.ZIP_STORED
                   for i in z.infolist())
    with open(tmp_path / "serving_meta.json") as f:
        assert json.load(f) == {"num_keys": len(keys),
                                "pull_width": 3 + DIM, "gate": list(gate)}


def test_export_serving_matches_reference():
    rng = np.random.default_rng(4)
    keys = rng.choice(1 << 40, 300, replace=False).astype(np.uint64)
    cfg = dict(dim=DIM, optimizer="adam", mf_create_threshold=2.0)
    store, jstore = HostEmbeddingStore(EmbeddingConfig(**cfg)), \
        JaxStore(JaxCfg(**cfg))
    for s in (store, jstore):
        rows = s.lookup_or_init(keys)
        rows[:, 0] = np.arange(len(keys)) % 5
        s.write_back(keys, rows)
    k, v = store.export_serving()
    jk, jv = jstore.export_serving()
    np.testing.assert_array_equal(k, jk)
    np.testing.assert_array_equal(v, jv)
    assert v.shape == (300, store.cfg.pull_width)
    t, jt = ServingTable.from_store(store), JaxTable.from_store(jstore)
    assert tuple(t.gate) == tuple(jt.gate)
    np.testing.assert_array_equal(t.lookup(keys[:40]),
                                  jt.lookup(keys[:40]))


# ---------------------------------------------------------------------------
# export: model.json and dense.npz
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", CONFIGS, ids=_ids)
def test_model_json_equal_to_reference(tmp_path, cfg):
    name, bf16 = cfg
    jm, pm, jparams = _pair(name, bf16)
    assert model_config(pm) == jax_model_config(jm)
    if bf16:
        assert model_config(pm)["compute_dtype"] == "bfloat16"
    jschema, schema = _schemas()
    keys, vals = _plane()
    save_inference_model(str(tmp_path / "port"), pm,
                         weights.model_params(pm), ServingTable(keys, vals),
                         schema)
    jax_save(str(tmp_path / "jax"), jm, jparams, JaxTable(keys, vals),
             jschema)
    docs = []
    for side in ("port", "jax"):
        with open(tmp_path / side / "model.json") as f:
            docs.append(json.load(f))
    assert docs[0] == docs[1]
    # dense.npz: the same members, stored uncompressed (mmap-able)
    with zipfile.ZipFile(tmp_path / "port" / "dense.npz") as z, \
            zipfile.ZipFile(tmp_path / "jax" / "dense.npz") as jz:
        assert sorted(z.namelist()) == sorted(jz.namelist())
        assert all(i.compress_type == zipfile.ZIP_STORED
                   for i in z.infolist())
    # and the port rebuilds the same model from either directory
    for side in ("port", "jax"):
        m, params, table, sch, meta = load_inference_model(
            str(tmp_path / side))
        assert type(m) is type(pm) and model_config(m) == model_config(pm)
        assert len(table) == len(keys) and sch == schema


def _score_both(path):
    """The batch scored by the port's and the JAX Predictor loaded from
    ``path`` (the same directory)."""
    port = Predictor.load(path, device="cpu")
    jaxp = JaxPredictor.load(path)
    ids, mask, dense = _request(port.table.keys)
    return (port.predict(ids, mask, dense),
            np.asarray(jaxp.predict(ids, mask, dense)))


@pytest.mark.parametrize("cfg", SCORED, ids=_ids)
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_export_scored_by_both_predictors(tmp_path, cfg, writer):
    name, bf16 = cfg
    jm, pm, jparams = _pair(name, bf16)
    jschema, schema = _schemas()
    keys, vals = _plane()
    path = str(tmp_path / "export")
    if writer == "port":
        save_inference_model(path, pm, weights.model_params(pm),
                             ServingTable(keys, vals), schema)
    else:
        jax_save(path, jm, jparams, JaxTable(keys, vals), jschema)
    got, want = _score_both(path)
    tasks = WIDTHS[name].get("num_tasks")
    assert got.shape == want.shape == ((32, tasks) if name == "mmoe"
                                       else (32,))
    np.testing.assert_allclose(got, want, **(BF16_TOL if bf16 else FWD_TOL))
    assert np.all((got > 0) & (got < 1))


def test_predictor_matches_forward_of_the_live_model():
    """predict = sigmoid(model(lookup, mask, dense)) on the given params,
    and predict_batch drops the label column."""
    _, pm, _ = _pair("deepfm")
    _, schema = _schemas()
    keys, vals = _plane()
    table = ServingTable(keys, vals)
    pred = Predictor(pm, weights.model_params(pm), table, schema,
                     device="cpu")
    ids, mask, dense = _request(keys)
    want = torch.sigmoid(pm(torch.from_numpy(table.lookup(ids, mask)),
                            torch.from_numpy(mask), torch.from_numpy(dense),
                            pred.layout.segment_ids, S)).detach().numpy()
    np.testing.assert_array_equal(pred.predict(ids, mask, dense), want)
    with pytest.raises(ValueError, match="token axis"):
        pred.predict(ids[:, :-1], mask[:, :-1], dense)


def test_with_model_never_touches_the_live_module():
    _, pm, jparams = _pair("deepfm")
    _, schema = _schemas()
    keys, vals = _plane()
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    old = Predictor(pm, jparams, ServingTable(keys, vals), schema,
                    device="cpu")
    assert old.model is not pm          # the caller's model stays its own
    ids, mask, dense = _request(keys)
    p_old = old.predict(ids, mask, dense)
    new_params = jax.tree.map(lambda a: a * 1.5, jparams)
    new = old.with_model(new_params, ServingTable(keys, vals * 2))
    assert new.model is not old.model and new.device == old.device
    # the live version's module and scores are unchanged
    np.testing.assert_array_equal(old.predict(ids, mask, dense), p_old)
    assert not np.allclose(new.predict(ids, mask, dense), p_old)
    np.testing.assert_array_equal(
        weights.model_params(old.model)["mlp"][0]["w"],
        jparams["mlp"][0]["w"])
    for k, v in pm.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_export_from_a_trained_store(tmp_path):
    """save_inference_model freezes a HostEmbeddingStore through
    export_serving, with its gate, as the reference does."""
    _, pm, _ = _pair("deepfm")
    jm, _, jparams = _pair("deepfm")
    _, schema = _schemas()
    keys, _ = _plane()
    cfg = dict(dim=DIM, mf_create_threshold=3.0)
    store, jstore = HostEmbeddingStore(EmbeddingConfig(**cfg)), \
        JaxStore(JaxCfg(**cfg))
    for s in (store, jstore):
        rows = s.lookup_or_init(keys)
        rows[:, 0] = np.arange(len(keys)) % 7
        s.write_back(keys, rows)
    save_inference_model(str(tmp_path / "p"), pm, jparams, store, schema)
    jax_save(str(tmp_path / "j"), jm, jparams, jstore, _schemas()[0])
    a = Predictor.load(str(tmp_path / "p"), device="cpu")
    b = Predictor.load(str(tmp_path / "j"), device="cpu")
    assert tuple(a.table.gate) == tuple(b.table.gate)
    ids, mask, dense = _request(keys)
    np.testing.assert_array_equal(a.predict(ids, mask, dense),
                                  b.predict(ids, mask, dense))


# ---------------------------------------------------------------------------
# the reference's C client memory-maps a port export
# ---------------------------------------------------------------------------

def test_reference_c_client_scores_a_port_export(tmp_path):
    """paddlebox_tpu/native/serving_score.c (libc only) mmaps the port's
    serving.npz and dense.npz, stored members and the JAX tree's member
    names, and scores as the port's Predictor does (the reference test's
    tolerance, rtol 2e-4 / atol 2e-5)."""
    import shutil
    import subprocess
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        pytest.skip("no C compiler")
    native = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "paddlebox_tpu", "native")
    cbin = str(tmp_path / "serving_score")
    subprocess.run([cc, "-O2", "-std=c11", "-Wall",
                    os.path.join(native, "serving_score.c"), "-o", cbin,
                    "-lm"], check=True, timeout=120)
    rng = np.random.default_rng(0)
    store = HostEmbeddingStore(EmbeddingConfig(dim=DIM))
    keys = rng.choice(1 << 40, 200, replace=False).astype(np.uint64)
    rows = store.lookup_or_init(keys)
    rows[:, 0] = rng.integers(1, 50, len(rows))
    rows[:, 1] = rng.integers(0, 10, len(rows))
    store.write_back(keys, rows)
    _, schema = _schemas(batch=8)
    model = models.DNNCTRModel(S, DIM, DENSE, hidden=(16, 8))
    model.init(torch.Generator().manual_seed(1))
    export = str(tmp_path / "export")
    save_inference_model(export, model, weights.model_params(model), store,
                         schema)
    ids, mask, dense = _request(keys, B=8)
    want = Predictor.load(export, device="cpu").predict(ids, mask, dense)
    lines = [" ".join([str(int(v)) for v in ids[b]]
                      + [str(int(v)) for v in mask[b]]
                      + [f"{v:.8f}" for v in dense[b]]) for b in range(8)]
    out = subprocess.run([cbin, export, str(S), str(L), "1"],
                         input="\n".join(lines) + "\n", capture_output=True,
                         text=True, check=True, timeout=60)
    got = np.array([float(x) for x in out.stdout.split()])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
