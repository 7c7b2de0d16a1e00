"""Carry model and table state across as NumPy arrays.

The JAX package keeps DeepFM parameters as a pytree of arrays
(``{"mlp": [{"w", "b"}, ...], "bias", "wide_dense"}``) and the pass
table as one (n_rows, W) array; the port keeps the same layouts inside
an ``nn.Module`` and a tensor. These functions move that state between
the two as NumPy arrays, so a run in either package can start from the
other's state.

``dense_state`` / ``load_dense_state`` carry the whole dense state: the
params and the dense optimizer's state as optax's tree — adam
``(ScaleByAdamState(count, mu, nu), EmptyState())`` with a 0-d int32
``count`` and ``mu``/``nu`` in the params' layout, sgd no leaves — so
``utils.checkpoint.save_tree`` names its members as the JAX package's
``save_pytree`` does (``opt_state/0/mu/mlp/0/w``, ...).
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


def _tree(model: DeepFMModel, leaves) -> dict:
    """The JAX parameter tree over ``leaves``, which are aligned with
    ``model.parameters()``."""
    by = dict(zip((n for n, _ in model.named_parameters()), leaves))
    out = {"mlp": [{"w": by[f"mlp.layers.{i}.w"], "b": by[f"mlp.layers.{i}.b"]}
                   for i in range(len(model.mlp.layers))],
           "bias": by["bias"]}
    if model.wide_dense is not None:
        out["wide_dense"] = by["wide_dense"]
    return out


def _leaves(model: DeepFMModel, tree: dict) -> list:
    """Inverse of ``_tree``: the tree's leaves in ``model.parameters()``
    order."""
    if len(tree["mlp"]) != len(model.mlp.layers):
        raise ValueError(f"{len(tree['mlp'])} MLP layers given, model has "
                         f"{len(model.mlp.layers)}")
    by = {"bias": tree["bias"]}
    for i, layer in enumerate(tree["mlp"]):
        by[f"mlp.layers.{i}.w"] = layer["w"]
        by[f"mlp.layers.{i}.b"] = layer["b"]
    if model.wide_dense is not None:
        by["wide_dense"] = tree["wide_dense"]
    return [by[n] for n, _ in model.named_parameters()]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


@torch.no_grad()
def load_deepfm_params(model: DeepFMModel, params: dict) -> None:
    """Copy a DeepFM parameter tree (NumPy-convertible arrays) into
    ``model`` in place."""
    names = [n for n, _ in model.named_parameters()]
    for name, dst, src in zip(names, model.parameters(),
                              _leaves(model, params)):
        _copy(dst, src, name)


def deepfm_params(model: DeepFMModel) -> dict:
    """The model's parameters as a NumPy tree in the JAX layout."""
    return _tree(model, [_np(p) for p in model.parameters()])


def dense_state(model: DeepFMModel, opt) -> dict:
    """{"params": ..., "opt_state": ...}: the model's params and the dense
    optimizer's state as NumPy trees in the JAX layout."""
    st = opt.state_leaves()
    if st is None:                     # sgd: optax.sgd's two EmptyStates
        opt_state = ((), ())
    else:
        opt_state = ({"count": np.asarray(st["count"], np.int32),
                      "mu": _tree(model, [_np(t) for t in st["mu"]]),
                      "nu": _tree(model, [_np(t) for t in st["nu"]])}, ())
    return {"params": deepfm_params(model), "opt_state": opt_state}


@torch.no_grad()
def load_dense_state(model: DeepFMModel, opt, params: dict,
                     opt_state=None) -> None:
    """Copy ``params`` and, when given, the optimizer state tree (as
    ``dense_state`` lays it out) into ``model`` and ``opt`` in place, on
    their device."""
    load_deepfm_params(model, params)
    if opt_state is None or opt.state_leaves() is None:
        return
    adam = opt_state[0]
    count = np.asarray(adam["count"])
    if count.shape != ():
        raise ValueError(f"adam count: shape {count.shape}, expected ()")
    shapes = [tuple(p.shape) for p in model.parameters()]
    mu, nu = _leaves(model, adam["mu"]), _leaves(model, adam["nu"])
    for i, (m, v) in enumerate(zip(mu, nu)):
        if np.shape(m) != shapes[i] or np.shape(v) != shapes[i]:
            raise ValueError(f"adam moment {i}: shapes {np.shape(m)}, "
                             f"{np.shape(v)} != {shapes[i]}")
    opt.load_state_leaves(int(count), mu, nu)


@torch.no_grad()
def load_table(ws: PassWorkingSet, table) -> None:
    """Copy a (n_rows, W) NumPy table into the working set's device
    table in place (shapes must match)."""
    _copy(ws.table, table, "table")
