"""Versioned serving artifacts — the port of
``paddlebox_tpu/serving/artifact.py`` (``version_name``,
``parse_version_name``, ``write_artifact`` :69, ``read_artifact`` :135).

Each published version is one self-contained directory, byte-compatible
with the JAX package's in both directions:

    v-000007/
        model.json      model name + constructor config + schema (the
                        export layout: a server bootstraps from any base)
        dense.npz       the dense params (uncompressed)
        sparse.npz      base: the whole pull plane — hot rows f32 (the
                        serving replica cache's), cold rows as f32 fixed
                        columns (show, clk, w) plus the embedx quantized
                        per row (``embedding/quant.py``) unless quant is
                        f32; delta: changed keys' f32 pull rows and the
                        removed keys
        MANIFEST.json   per-member size + CRC32, version, pass_id, kind,
                        parent_version — written LAST, atomically

Members land tmp → fsync → replace; ``serving.publish.pre_manifest``
sits between the last member and the manifest commit. A version without
a committed manifest never happened, and ``read_artifact`` re-hashes
every member before a server builds from it.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any

import numpy as np

from paddlebox_tpu_torch.embedding import quant as quant_lib
from paddlebox_tpu_torch.embedding.gating import GateSpec
from paddlebox_tpu_torch.utils import checkpoint as ckpt_lib
from paddlebox_tpu_torch.utils import faultpoint

ARTIFACT_FORMAT_VERSION = 1
_VERSION_RE = re.compile(r"^v-(\d{6,})$")


def version_name(version: int) -> str:
    return f"v-{int(version):06d}"


def parse_version_name(name: str) -> int | None:
    m = _VERSION_RE.match(name)
    return int(m.group(1)) if m else None


def _atomic_npz(fname: str, **arrays: np.ndarray) -> None:
    with ckpt_lib.atomic_file(fname) as tmp:
        with open(tmp, "wb") as f:
            # uncompressed (stored members), memory-mappable: the
            # quantized planes already carry the compression
            np.savez(f, **arrays)


def write_artifact(dirpath: str, *, version: int, pass_id: int, kind: str,
                   parent_version: int | None, model_meta: dict[str, Any],
                   dense_params: Any, keys: np.ndarray, vals: np.ndarray,
                   removed: np.ndarray | None = None,
                   hot: np.ndarray | None = None,
                   gate: GateSpec | None = None,
                   quant: str = "f32", fixed_cols: int = 0,
                   ts: int = 0) -> dict:
    """Write one version directory and commit its manifest last.

    ``kind`` "base": keys/vals are the whole pull plane, ``hot`` flags
    the replica-cache rows (kept f32 while cold embedx quantizes per
    ``quant``); "delta": keys/vals are the changed rows at full
    precision and ``removed`` the evicted keys. Returns the manifest."""
    if kind not in ("base", "delta"):
        raise ValueError(f"artifact kind must be base|delta, got {kind!r}")
    os.makedirs(dirpath, exist_ok=True)
    keys = np.asarray(keys, np.uint64)
    vals = np.asarray(vals, np.float32)
    files: dict[str, dict] = {}

    mj = os.path.join(dirpath, "model.json")
    with ckpt_lib.atomic_file(mj) as tmp:
        with open(tmp, "w") as f:
            json.dump(model_meta, f, indent=1)
    files["model.json"] = ckpt_lib.file_entry(mj)

    dense_f = os.path.join(dirpath, "dense.npz")
    ckpt_lib.save_tree(dense_params, dense_f, compress=False)
    files["dense.npz"] = ckpt_lib.file_entry(dense_f)

    sparse_f = os.path.join(dirpath, "sparse.npz")
    if kind == "delta":
        _atomic_npz(sparse_f, keys=keys, rows=vals,
                    removed=(np.zeros(0, np.uint64) if removed is None
                             else np.asarray(removed, np.uint64)))
    else:
        hot = (np.zeros(len(keys), bool) if hot is None
               else np.asarray(hot, bool))
        if quant == "f32":
            _atomic_npz(sparse_f, keys=keys, rows=vals, hot=hot)
        else:
            cold = ~hot
            qx, scale = quant_lib.quantize_rows_np(
                vals[cold][:, fixed_cols:], quant)
            _atomic_npz(sparse_f, keys=keys, hot=hot,
                        hot_rows=vals[hot],
                        cold_fp=vals[cold][:, :fixed_cols],
                        cold_qx=qx, cold_scale=scale)
    files["sparse.npz"] = ckpt_lib.file_entry(sparse_f)

    meta = {"format_version": ARTIFACT_FORMAT_VERSION,
            "version": int(version), "pass_id": int(pass_id), "kind": kind,
            "parent_version": (None if parent_version is None
                               else int(parent_version)),
            "quant": quant, "fixed_cols": int(fixed_cols),
            "num_keys": int(len(keys)),
            "hot_keys": int(hot.sum()) if kind == "base" else 0,
            "gate": (None if gate is None else list(gate)),
            "ts": int(ts)}
    faultpoint.hit("serving.publish.pre_manifest")
    ckpt_lib.write_manifest(dirpath, files, **meta)
    return dict(meta, files=files)


def read_artifact(dirpath: str, verify: bool = True) -> dict:
    """Load a version directory → {meta, model_meta, dense_file, keys,
    vals/rows, removed, hot}. ``verify`` re-hashes every member against
    the manifest first (CheckpointCorruptError names the bad member)."""
    manifest = (ckpt_lib.verify_manifest(dirpath) if verify
                else ckpt_lib.read_manifest(dirpath))
    if manifest is None:
        raise ckpt_lib.CheckpointCorruptError(
            os.path.join(dirpath, ckpt_lib.MANIFEST_NAME),
            "missing manifest (artifact was never committed)")
    if int(manifest.get("format_version", -1)) > ARTIFACT_FORMAT_VERSION:
        raise ValueError(
            f"serving artifact format {manifest.get('format_version')} is "
            f"newer than this server understands")
    with open(os.path.join(dirpath, "model.json")) as f:
        model_meta = json.load(f)
    out: dict[str, Any] = {"meta": manifest, "model_meta": model_meta,
                           "dense_file": os.path.join(dirpath, "dense.npz")}
    with np.load(os.path.join(dirpath, "sparse.npz")) as z:
        if manifest["kind"] == "delta":
            out["keys"] = z["keys"]
            out["rows"] = z["rows"]
            out["removed"] = z["removed"]
        else:
            keys = z["keys"]
            hot = z["hot"]
            if manifest.get("quant", "f32") == "f32":
                vals = z["rows"]
            else:
                # the f32 pull plane again: hot rows as written, cold
                # rows dequantized (bounded, relative error)
                cold_x = quant_lib.dequantize_rows_np(z["cold_qx"],
                                                      z["cold_scale"])
                cold = np.concatenate([z["cold_fp"], cold_x], axis=1)
                width = (cold.shape[1] if cold.shape[1]
                         else z["hot_rows"].shape[1])
                vals = np.empty((len(keys), width), np.float32)
                vals[hot] = z["hot_rows"]
                vals[~hot] = cold
            out["keys"], out["vals"], out["hot"] = keys, vals, hot
    return out
