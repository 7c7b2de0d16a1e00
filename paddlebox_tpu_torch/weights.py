"""Carry model and table state across as NumPy arrays.

The JAX package keeps a model's parameters as a pytree of arrays (DeepFM
``{"mlp": [{"w", "b"}, ...], "bias", "wide_dense"}``, DCNv2 ``{"cross":
[...], "deep": [...], "head": {...}}``, MMoE ``{"experts": [[...]],
"gates": [...], "towers": [[...]]}``, ...) and the pass table as one
(n_rows, W) array; the port keeps the same layouts inside an
``nn.Module`` and a tensor. Every zoo model names its parameters by
their JAX paths with dots (``experts.0.1.w`` is ``experts/0/1/w``), so
one rule maps any of them: a numeric path part is a list index, any
other a dict key. A wrapper model (``ShareEmbeddingModel``) exposes the
module holding the parameters as ``param_root``.

``dense_state`` / ``load_dense_state`` carry the whole dense state: the
params and the dense optimizer's state laid out as optax's state tree
(``optimizers.py``: adam ``(ScaleByAdamState(count, mu, nu),
EmptyState())``, momentum ``(TraceState(trace), EmptyState())``, ftrl
``FtrlState(z, n)``, ...), with namedtuples as dicts of their fields, so
``utils.checkpoint.save_tree`` names the members as the JAX package's
``save_pytree`` does (``opt_state/0/mu/mlp/0/w``, ``opt_state/z/cross/
0/b``, ...).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from paddlebox_tpu_torch.embedding.working_set import PassWorkingSet


def _copy(dst: torch.Tensor, src, name: str) -> None:
    a = np.array(src, dtype=np.float32)
    if tuple(a.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: shape {a.shape} != {tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(np.ascontiguousarray(a)))


def param_paths(model: nn.Module) -> list[tuple[str, ...]]:
    """The JAX path of each of ``model.parameters()``, in that order."""
    root = getattr(model, "param_root", model)
    return [tuple(n.split(".")) for n, _ in root.named_parameters()]


def _nest(items):
    """{path: leaf} with tuple paths → nested dicts and lists."""
    heads: dict[str, list] = {}
    for path, leaf in items:
        heads.setdefault(path[0], []).append((path[1:], leaf))
    out = {}
    for k, sub in heads.items():
        out[k] = sub[0][1] if sub[0][0] == () else _nest(sub)
    if out and all(k.isdigit() for k in out):
        n = len(out)
        if sorted(int(k) for k in out) != list(range(n)):
            raise ValueError(f"list indices {sorted(out)} are not 0..{n - 1}")
        return [out[str(i)] for i in range(n)]
    return out


def tree(model: nn.Module, leaves) -> dict:
    """The JAX parameter tree over ``leaves``, which are aligned with
    ``model.parameters()``."""
    return _nest(zip(param_paths(model), leaves))


def _at(t, path: tuple[str, ...], where: str):
    for i, part in enumerate(path):
        here = "/".join(path[:i + 1])
        if isinstance(t, dict):
            if part not in t:
                raise ValueError(f"{where}: no leaf {here!r}")
            t = t[part]
        elif isinstance(t, (list, tuple)):
            if not part.isdigit() or int(part) >= len(t):
                raise ValueError(f"{where}: no leaf {here!r} ({len(t)} "
                                 f"entries)")
            t = t[int(part)]
        else:
            raise ValueError(f"{where}: {'/'.join(path[:i])!r} is a leaf")
    return t


def _count(t) -> int:
    if isinstance(t, dict):
        return sum(_count(v) for v in t.values())
    if isinstance(t, (list, tuple)):
        return sum(_count(v) for v in t)
    return 1


def leaves(model: nn.Module, t: dict, where: str = "params") -> list:
    """Inverse of ``tree``: the tree's leaves in ``model.parameters()``
    order. A tree with a leaf the model lacks, or lacking one it has,
    raises."""
    paths = param_paths(model)
    out = [_at(t, p, where) for p in paths]
    if _count(t) != len(paths):
        raise ValueError(f"{where}: {_count(t)} leaves given, the model "
                         f"has {len(paths)}")
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


@torch.no_grad()
def load_model_params(model: nn.Module, params: dict) -> None:
    """Copy a JAX parameter tree (NumPy-convertible arrays) into
    ``model`` in place."""
    for path, dst, src in zip(param_paths(model), model.parameters(),
                              leaves(model, params)):
        _copy(dst, src, "/".join(path))


def model_params(model: nn.Module) -> dict:
    """The model's parameters as a NumPy tree in the JAX layout."""
    return tree(model, [_np(p) for p in model.parameters()])


# the DeepFM-era names
load_deepfm_params = load_model_params
deepfm_params = model_params


def _state_tree(model: nn.Module, st):
    """An optimizer's ``state_leaves`` (tuples, dicts, per-parameter
    lists of tensors, scalars) → the optax state tree in NumPy."""
    if isinstance(st, tuple):
        return tuple(_state_tree(model, s) for s in st)
    if isinstance(st, dict):
        return {k: _state_tree(model, v) for k, v in st.items()}
    if isinstance(st, list):
        return tree(model, [_np(t) for t in st])
    return np.asarray(st, np.int32)          # a step count


def _state_leaves(model: nn.Module, template, t, where: str):
    """The optax state tree ``t`` → ``template``'s structure (the
    optimizer's ``state_leaves``), checking every shape."""
    if isinstance(template, tuple):
        if not isinstance(t, (tuple, list)) or len(t) != len(template):
            raise ValueError(f"{where}: expected a {len(template)}-tuple")
        return tuple(_state_leaves(model, s, x, f"{where}/{i}")
                     for i, (s, x) in enumerate(zip(template, t)))
    if isinstance(template, dict):
        return {k: _state_leaves(model, v, _at(t, (k,), where),
                                 f"{where}/{k}")
                for k, v in template.items()}
    if isinstance(template, list):
        got = leaves(model, t, where)
        for path, g, want in zip(param_paths(model), got, template):
            if np.shape(g) != tuple(want.shape):
                raise ValueError(f"{where}/{'/'.join(path)}: shape "
                                 f"{np.shape(g)} != {tuple(want.shape)}")
        return got
    count = np.asarray(t)
    if count.shape != ():
        raise ValueError(f"{where}: shape {count.shape}, expected ()")
    return int(count)


def dense_state(model: nn.Module, opt) -> dict:
    """{"params": ..., "opt_state": ...}: the model's params and the dense
    optimizer's state as NumPy trees in the JAX layout."""
    return {"params": model_params(model),
            "opt_state": _state_tree(model, opt.state_leaves())}


@torch.no_grad()
def load_dense_state(model: nn.Module, opt, params: dict,
                     opt_state=None) -> None:
    """Copy ``params`` and, when given, the optimizer state tree (as
    ``dense_state`` lays it out) into ``model`` and ``opt`` in place, on
    their device."""
    load_model_params(model, params)
    if opt_state is None:
        return
    opt.load_state_leaves(
        _state_leaves(model, opt.state_leaves(), opt_state, "opt_state"))


@torch.no_grad()
def load_table(ws: PassWorkingSet, table) -> None:
    """Copy a (n_rows, W) NumPy table into the working set's device
    table in place (shapes must match)."""
    _copy(ws.table, table, "table")
