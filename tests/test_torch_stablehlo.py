"""The port's exported-program artifact (``inference/stablehlo.py``)
against the port's ``Predictor`` and the JAX package's
``export_stablehlo`` / ``load_stablehlo``:

- the round trip (export at a fixed batch, load, call on the pulled
  rows) equals ``Predictor.predict`` on the same ids, and equals the
  JAX artifact's call on the same carried-over params and inputs, at
  the reference's tolerance (rtol 1e-5, atol 1e-6:
  tests/test_inference.py:155-157), single-task and multi-task;
- the meta file keeps the reference's keys, and the program runs at the
  exported batch only;
- a torn module/meta pair is rejected with ``CheckpointCorruptError``, a
  meta without the CRC still loads, and neither package loads the
  other's artifact.

Small sizes (3 slots, dim 4, hidden ≤ 16, batch 32), device="cpu".
"""

import json

import numpy as np
import pytest
import torch

from paddlebox_tpu.inference.stablehlo import (
    export_stablehlo as jax_export_stablehlo)
from paddlebox_tpu.inference.stablehlo import (
    load_stablehlo as jax_load_stablehlo)

from paddlebox_tpu_torch.inference import Predictor, ServingTable
from paddlebox_tpu_torch.inference.stablehlo import (META_FILE,
                                                     export_stablehlo,
                                                     load_stablehlo)
from paddlebox_tpu_torch.utils.checkpoint import CheckpointCorruptError

from test_torch_inference import FWD_TOL, _pair, _plane, _request, _schemas

torch.set_num_threads(1)

B = 32
FAMILIES = ("deepfm", "dnn_ctr", "mmoe")


def _setup(name, seed=3):
    jm, pm, jparams = _pair(name, seed=seed)
    jschema, schema = _schemas(B)
    keys, vals = _plane()
    table = ServingTable(keys, vals)
    ids, mask, dense = _request(keys, B)
    return jm, pm, jparams, jschema, schema, table, ids, mask, dense


@pytest.mark.parametrize("name", FAMILIES)
def test_roundtrip_equals_predictor_and_reference(tmp_path, name):
    jm, pm, jparams, jschema, schema, table, ids, mask, dense = _setup(name)
    path = str(tmp_path / "prog")
    export_stablehlo(path, pm, jparams, schema, batch_size=B,
                     pull_width=table.pull_width, device="cpu")
    call = load_stablehlo(path, device="cpu")
    assert call.device == torch.device("cpu")
    pulled = table.lookup(ids, mask)
    probs = call(pulled, mask, dense)
    want_shape = (B, 2) if name == "mmoe" else (B,)
    assert probs.shape == want_shape
    live = Predictor(pm, jparams, table, schema, device="cpu")
    np.testing.assert_allclose(live.predict(ids, mask, dense), probs,
                               **FWD_TOL)
    jpath = str(tmp_path / "hlo")
    jax_export_stablehlo(jpath, jm, jparams, jschema, batch_size=B,
                         pull_width=table.pull_width)
    np.testing.assert_allclose(
        probs, jax_load_stablehlo(jpath)(pulled, mask, dense), **FWD_TOL)
    with open(tmp_path / "prog" / META_FILE) as f:
        meta = json.load(f)
    with open(tmp_path / "hlo" / "stablehlo_meta.json") as f:
        jmeta = json.load(f)
    assert set(jmeta) <= set(meta)
    for k in ("batch_size", "total_len", "pull_width", "num_dense",
              "multi_task"):
        assert meta[k] == jmeta[k], k
    assert meta["format"] == "torch.export"


def test_program_is_fixed_at_its_batch(tmp_path):
    _, pm, jparams, _, schema, table, ids, mask, dense = _setup("deepfm")
    path = str(tmp_path / "prog")
    export_stablehlo(path, pm, jparams, schema, batch_size=B,
                     pull_width=table.pull_width, device="cpu")
    call = load_stablehlo(path, device="cpu")
    pulled = table.lookup(ids, mask)
    with pytest.raises(Exception):
        call(pulled[:B // 2], mask[:B // 2], dense[:B // 2])


def test_torn_pair_rejected(tmp_path):
    _, pm, jparams, _, schema, table, ids, mask, dense = _setup("deepfm")
    path = str(tmp_path / "prog")
    export_stablehlo(path, pm, jparams, schema, batch_size=B,
                     pull_width=table.pull_width, device="cpu")
    meta_p = tmp_path / "prog" / META_FILE
    meta = json.loads(meta_p.read_text())
    assert "module_crc32" in meta
    # the torn pair: a meta from another export beside this module
    meta["module_crc32"] = (meta["module_crc32"] + 1) & 0xFFFFFFFF
    meta_p.write_text(json.dumps(meta))
    with pytest.raises(CheckpointCorruptError, match="pair mismatch"):
        load_stablehlo(path, device="cpu")
    # a meta without the CRC (an older export) still loads
    del meta["module_crc32"]
    meta_p.write_text(json.dumps(meta))
    call = load_stablehlo(path, device="cpu")
    assert call(table.lookup(ids, mask), mask, dense).shape == (B,)


def test_artifacts_are_not_interchangeable(tmp_path):
    jm, pm, jparams, jschema, schema, table, *_ = _setup("deepfm")
    export_stablehlo(str(tmp_path / "prog"), pm, jparams, schema,
                     batch_size=B, pull_width=table.pull_width,
                     device="cpu")
    jax_export_stablehlo(str(tmp_path / "hlo"), jm, jparams, jschema,
                         batch_size=B, pull_width=table.pull_width)
    with pytest.raises(FileNotFoundError):
        jax_load_stablehlo(str(tmp_path / "prog"))
    with pytest.raises(FileNotFoundError):
        load_stablehlo(str(tmp_path / "hlo"), device="cpu")
