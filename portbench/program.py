"""The program under test, built from a configuration: everything the
benchmark takes from ``paddlebox_tpu_torch`` goes through here or
through the loops in ``drivers/``."""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench import harness


def embedding_config(cfg: dict):
    from paddlebox_tpu_torch.embedding import EmbeddingConfig
    kw = {"dim": cfg["embedding_dim"], "optimizer": cfg["table_optimizer"],
          "learning_rate": cfg["table_lr"],
          "initial_range": cfg["initial_range"]}
    if "initial_g2sum" in cfg:
        kw["initial_g2sum"] = cfg["initial_g2sum"]
    return EmbeddingConfig(**kw)


def schema(cfg: dict):
    """Slot i holds ``hotness[i]`` ids an example (1 each by default)."""
    from paddlebox_tpu_torch.data import DataFeedSchema
    base = DataFeedSchema.ctr(num_sparse=cfg["num_sparse"],
                              num_float=cfg["num_dense"],
                              batch_size=cfg["batch_size"], max_len=1)
    hot = iter(harness.hotness(cfg))
    return DataFeedSchema(
        [dataclasses.replace(s, max_len=next(hot))
         if s in base.sparse_slots else s for s in base.slots],
        batch_size=base.batch_size)


def model(cfg: dict):
    """The program's model, built by ``families/<family>.py``."""
    return harness.load_module("families", cfg["family"]).model(cfg)


def param_tree(params: dict) -> dict:
    """Dotted parameter names -> the program's nested parameter tree of
    NumPy arrays (``mlp.0.w`` -> tree["mlp"]["0"]["w"])."""
    tree: dict = {}
    for name, value in params.items():
        *heads, leaf = name.split(".")
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = value.detach().cpu().numpy()
    return tree


def flat_tree(tree, prefix: str = "") -> dict:
    """The inverse of ``param_tree`` over any nesting of dicts and lists."""
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, (list, tuple))
             else None)
    if items is None:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flat_tree(v, f"{prefix}{k}."))
    return out
