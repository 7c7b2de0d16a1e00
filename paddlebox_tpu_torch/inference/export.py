"""Inference-model export and load — the port of
``paddlebox_tpu/inference/export.py`` (``model_config`` :36-59,
``save_inference_model`` :79-108, ``load_inference_model`` :111-126).

An exported model is a directory of plain files, the same in both
packages:

    model.json    format version, model name, constructor config, schema,
                  label slot, pull width
    dense.npz     the dense params as the JAX tree (``weights.py``),
                  uncompressed so non-Python clients memory-map it
    serving.npz   the frozen pull plane (``ServingTable.save``)

``model.json`` is what the JAX package writes for the same family and
constructor arguments, key for key: ``compute_dtype`` is written as its
name (``"float32"``, ``"bfloat16"``), tuples as lists, and only the
constructor's own arguments are read, so nothing of the module (its
device, its parameters) leaks into ``config``.
"""

from __future__ import annotations

import inspect
import json
import os
from typing import Any

import torch

from paddlebox_tpu_torch import weights
from paddlebox_tpu_torch.data.schema import DataFeedSchema, Slot, SlotType
from paddlebox_tpu_torch.inference.serving_table import ServingTable
from paddlebox_tpu_torch.models import MODEL_REGISTRY
from paddlebox_tpu_torch.utils import checkpoint

FORMAT_VERSION = 1

# torch dtype ↔ the JAX package's ``jnp.dtype(v).name``
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16"}


def model_config(model: Any) -> dict[str, Any]:
    """A model's constructor kwargs, recovered from the attribute each
    zoo model stores under every ``__init__`` argument's name."""
    sig = inspect.signature(type(model).__init__)
    cfg = {}
    for name in sig.parameters:
        if name == "self":
            continue
        if not hasattr(model, name):
            raise ValueError(
                f"{type(model).__name__} does not store __init__ arg "
                f"{name!r} as an attribute; cannot export its config")
        v = getattr(model, name)
        if name == "compute_dtype":
            if v not in _DTYPE_NAMES:
                raise ValueError(f"compute_dtype {v} has no export name")
            v = _DTYPE_NAMES[v]
        elif isinstance(v, tuple):
            v = list(v)
        cfg[name] = v
    return cfg


def build_model(cls: Any, config: dict[str, Any]):
    """A fresh model of class ``cls`` (a zoo class, e.g.
    ``MODEL_REGISTRY[meta["model"]]``) from a ``model.json`` config
    (lists back to tuples, dtype names back to torch dtypes). Its
    parameters are allocated, not drawn: load them."""
    cfg = {k: (tuple(v) if isinstance(v, list) else v)
           for k, v in config.items()}
    if "compute_dtype" in cfg:
        cfg["compute_dtype"] = getattr(torch, cfg["compute_dtype"])
    return cls(**cfg)


def _schema_json(schema: DataFeedSchema) -> dict[str, Any]:
    return {
        "batch_size": schema.batch_size,
        "slots": [{"name": s.name, "type": s.type.value,
                   "is_dense": s.is_dense, "is_used": s.is_used,
                   "max_len": s.max_len} for s in schema.slots],
    }


def _schema_from_json(d: dict[str, Any]) -> DataFeedSchema:
    slots = [Slot(s["name"], SlotType(s["type"]), s["is_dense"],
                  s["is_used"], s["max_len"]) for s in d["slots"]]
    return DataFeedSchema(slots, batch_size=d["batch_size"])


def model_meta(model: Any, schema: DataFeedSchema, pull_width: int,
               label_slot: str = "label") -> dict[str, Any]:
    """The ``model.json`` document of an export or a serving artifact."""
    return {
        "format_version": FORMAT_VERSION,
        "model": model.name,
        "config": model_config(model),
        "schema": _schema_json(schema),
        "label_slot": label_slot,
        "pull_width": int(pull_width),
    }


def save_inference_model(path: str, model: Any, params: Any,
                         store_or_table: Any, schema: DataFeedSchema,
                         label_slot: str = "label") -> str:
    """Write a self-contained serving directory; returns ``path``.

    ``params``: the dense params as a JAX-layout tree (numpy or tensors,
    e.g. ``Trainer.eval_params()``). ``store_or_table``: a
    HostEmbeddingStore (frozen through ``export_serving``) or a
    ServingTable."""
    if model.name not in MODEL_REGISTRY:
        raise ValueError(f"model {model.name!r} not in MODEL_REGISTRY")
    os.makedirs(path, exist_ok=True)
    table = (store_or_table if isinstance(store_or_table, ServingTable)
             else ServingTable.from_store(store_or_table))
    table.save(path)
    checkpoint.save_tree(params, os.path.join(path, "dense.npz"),
                         compress=False)
    meta = model_meta(model, schema, table.pull_width, label_slot)
    with open(os.path.join(path, "model.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return path


def load_dense(model: Any, dense_file: str) -> dict:
    """``dense.npz`` as a numpy tree shaped by ``model``'s params."""
    return checkpoint.load_tree(weights.model_params(model), dense_file)


def load_inference_model(path: str):
    """→ (model, params, ServingTable, schema, meta): the model rebuilt
    on the CPU with the exported params loaded, params as a numpy tree."""
    with open(os.path.join(path, "model.json")) as f:
        meta = json.load(f)
    if meta["format_version"] > FORMAT_VERSION:
        raise ValueError(f"export format {meta['format_version']} is newer "
                         f"than this framework understands")
    model = build_model(MODEL_REGISTRY[meta["model"]], meta["config"])
    params = load_dense(model, os.path.join(path, "dense.npz"))
    weights.load_model_params(model, params)
    table = ServingTable.load(path)
    schema = _schema_from_json(meta["schema"])
    return model, params, table, schema, meta
