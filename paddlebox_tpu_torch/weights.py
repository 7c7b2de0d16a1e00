"""Carry model and table state across as NumPy arrays.

The JAX package keeps DeepFM parameters as a pytree of arrays
(``{"mlp": [{"w", "b"}, ...], "bias", "wide_dense"}``) and the pass
table as one (n_rows, W) array; the port keeps the same layouts inside
an ``nn.Module`` and a tensor. These functions move that state between
the two as NumPy arrays, so a run in either package can start from the
other's state.
"""

from __future__ import annotations

import numpy as np
import torch

from paddlebox_tpu_torch.embedding.working_set import PassWorkingSet
from paddlebox_tpu_torch.models.deepfm import DeepFMModel


def _copy(dst: torch.Tensor, src, name: str) -> None:
    a = np.array(src, dtype=np.float32)
    if tuple(a.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: shape {a.shape} != {tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(np.ascontiguousarray(a)))


@torch.no_grad()
def load_deepfm_params(model: DeepFMModel, params: dict) -> None:
    """Copy a DeepFM parameter tree (NumPy-convertible arrays) into
    ``model`` in place."""
    layers = model.mlp.layers
    if len(params["mlp"]) != len(layers):
        raise ValueError(f"{len(params['mlp'])} MLP layers given, model has "
                         f"{len(layers)}")
    for i, (layer, p) in enumerate(zip(layers, params["mlp"])):
        _copy(layer.w, p["w"], f"mlp[{i}].w")
        _copy(layer.b, p["b"], f"mlp[{i}].b")
    _copy(model.bias, params["bias"], "bias")
    if model.wide_dense is not None:
        _copy(model.wide_dense, params["wide_dense"], "wide_dense")


def deepfm_params(model: DeepFMModel) -> dict:
    """The model's parameters as a NumPy tree in the JAX layout."""
    def np_(t):
        return t.detach().cpu().numpy().copy()
    out = {"mlp": [{"w": np_(l.w), "b": np_(l.b)} for l in model.mlp.layers],
           "bias": np_(model.bias)}
    if model.wide_dense is not None:
        out["wide_dense"] = np_(model.wide_dense)
    return out


@torch.no_grad()
def load_table(ws: PassWorkingSet, table) -> None:
    """Copy a (n_rows, W) NumPy table into the working set's device
    table in place (shapes must match)."""
    _copy(ws.table, table, "table")
