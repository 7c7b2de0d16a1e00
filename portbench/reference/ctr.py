"""The plain reference of one CTR training step: the pull, a model
family's forward (``reference/<family>.py``), the mean sigmoid
cross-entropy, autograd, the dense optimizer and the in-table sparse
optimizer, in float32 with plain PyTorch operations. It imports nothing
of the program.

What it states, from the published descriptions and the port's
documented contract (``paddlebox_tpu_torch/embedding/config.py``'s row
layout, ``embedding/optim.py``'s and ``train/optimizers.py``'s
formulas):

- a table row is [show, clk, w, embedding (dim), optimizer state]; a new
  key's row is zero but for its embedding, a hash of the key uniform in
  [-initial_range, initial_range) (``init_rows``);
- the pull reads the rows of a batch's keys; a slot of the
  configuration's ``hotness`` h holds h keys an example, side by side,
  and their [w, embedding] sum-pool per (example, slot), as
  ``fused_seqpool_cvm`` with ``use_cvm=False`` does (``ops/
  seqpool_cvm.py``); at one key a slot nothing pools; the forward
  consumes the pooled [w, embedding] of each slot;
- each token's gradient is its slot's pooled gradient; the push merges
  a batch's tokens per distinct key: the gradients sum, show grows by
  the key's tokens and clk by its positive tokens; then
  the key's row takes one optimizer step. adagrad (BoxPS's per-feature
  scalar accumulators): g2_w += g_w^2, g2_x += mean(g_x^2), each block
  moves by lr * sqrt(g0 / (g0 + g2)) * g. sgd: lr * g;
- the dense optimizer is optax's: adam (b1 0.9, b2 0.999, eps 1e-8,
  bias-corrected) or sgd.

``precision`` selects the products' arithmetic: "float32" (TF32 off),
"tf32" (TF32 on: the control) or "bfloat16".
"""

from __future__ import annotations

import contextlib
import importlib

import numpy as np
import torch
import torch.nn.functional as F

from portbench import harness


@contextlib.contextmanager
def matmul_precision(precision: str):
    """TF32 on for "tf32", off otherwise, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "bfloat16":
        return (x.bfloat16() @ w.bfloat16()).float()
    return x @ w


def mlp(params: dict, prefix: str, n: int, x: torch.Tensor,
        precision: str, final_relu: bool = False) -> torch.Tensor:
    for i in range(n):
        x = mm(x, params[f"{prefix}.{i}.w"], precision) \
            + params[f"{prefix}.{i}.b"]
        if i < n - 1 or final_relu:
            x = torch.relu(x)
    return x


def family(cfg: dict):
    return importlib.import_module(
        f"portbench.reference.{cfg['family']}")


def pool(cfg: dict, t: torch.Tensor) -> torch.Tensor:
    """(B, sum of hotness, ...) per-token values -> (B, S, ...) sums per
    (example, slot), slot f's tokens side by side; unchanged at one token
    a slot."""
    hot = harness.hotness(cfg)
    if max(hot) == 1:
        return t
    ends = np.cumsum(hot)
    return torch.stack([t[:, e - h:e].sum(dim=1)
                        for h, e in zip(hot, ends)], dim=1)


def make_params(cfg: dict, gen: torch.Generator, device) -> dict:
    """The dense parameters a run starts from, drawn from ``gen``: each
    weight normal with the Glorot deviation sqrt(2 / (in + out)), each
    bias zero, and any other vector normal with deviation 0.01."""
    out = {}
    for name, shape in family(cfg).param_shapes(cfg):
        if name.endswith(".w"):
            std = (2.0 / (shape[0] + shape[1])) ** 0.5
            out[name] = torch.randn(shape, generator=gen,
                                    device=device) * std
        elif name.endswith(".b") or name == "bias":
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.randn(shape, generator=gen,
                                    device=device) * 0.01
    return out


def row_layout(cfg: dict) -> dict:
    d = cfg["embedding_dim"]
    n_opt = {"sgd": 0, "adagrad": 2}[cfg["table_optimizer"]]
    return {"w": 2, "x": slice(3, 3 + d), "opt": 3 + d,
            "width": 3 + d + n_opt}


def init_rows(cfg: dict, keys: np.ndarray) -> np.ndarray:
    """New keys' rows: the embedding a splitmix hash of (key, column)
    scaled into [-initial_range, initial_range); the rest zero."""
    lay = row_layout(cfg)
    d = cfg["embedding_dim"]
    rows = np.zeros((len(keys), lay["width"]), np.float32)
    k = keys.astype(np.uint64)[:, None]
    j = np.arange(d, dtype=np.uint64)[None, :]
    with np.errstate(over="ignore"):
        z = (k * np.uint64(0x9E3779B97F4A7C15)
             + j * np.uint64(0xBF58476D1CE4E5B9))
        z ^= z >> np.uint64(30)
        z *= np.uint64(0x94D049BB133111EB)
        z ^= z >> np.uint64(27)
    u = (z >> np.uint64(11)).astype(np.float64) / float(1 << 53)
    rows[:, lay["x"]] = ((2.0 * u - 1.0)
                         * cfg["initial_range"]).astype(np.float32)
    return rows


def _table_update(cfg: dict, rows: torch.Tensor, g_w: torch.Tensor,
                  g_x: torch.Tensor, show: torch.Tensor,
                  clk: torch.Tensor) -> torch.Tensor:
    lay = row_layout(cfg)
    lr = cfg["table_lr"]
    out = rows.clone()
    out[:, 0] += show
    out[:, 1] += clk
    if cfg["table_optimizer"] == "sgd":
        out[:, 2] -= lr * g_w
        out[:, lay["x"]] -= lr * g_x
        return out
    g0 = cfg["initial_g2sum"]
    o = lay["opt"]
    g2w = rows[:, o] + g_w * g_w
    g2x = rows[:, o + 1] + (g_x * g_x).mean(dim=1)
    out[:, 2] -= lr * torch.sqrt(g0 / (g0 + g2w)) * g_w
    out[:, lay["x"]] -= (lr * torch.sqrt(g0 / (g0 + g2x)))[:, None] * g_x
    out[:, o], out[:, o + 1] = g2w, g2x
    return out


class DenseOptimizer:
    def __init__(self, cfg: dict, params: dict):
        self.kind, self.lr = cfg["dense_optimizer"], cfg["dense_lr"]
        self.t = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: dict, grads: dict) -> dict:
        if self.kind == "sgd":
            return {k: p - self.lr * grads[k] for k, p in params.items()}
        b1, b2, eps = 0.9, 0.999, 1e-8
        self.t += 1
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.mu[k] = b1 * self.mu[k] + (1 - b1) * g
            self.nu[k] = b2 * self.nu[k] + (1 - b2) * g * g
            m_hat = self.mu[k] / (1 - b1 ** self.t)
            v_hat = self.nu[k] / (1 - b2 ** self.t)
            out[k] = p - self.lr * m_hat / (torch.sqrt(v_hat) + eps)
        return out


def train(cfg: dict, params: dict, batches, precision: str = "float32"):
    """Train ``batches`` (each (keys (B, sum of hotness) int64, label
    (B,), dense (B, F)) on one device) from ``params`` and fresh rows.
    Returns {"loss": [per step], "state1": the state after step 1
    ("dense": adam's first moment or sgd's parameters, "rows": every
    key's row), "params": the dense parameters after, "keys": the
    distinct keys (uint64), "rows": their rows after}."""
    fam = family(cfg)
    dev = batches[0][0].device
    all_keys = torch.unique(torch.cat([b[0].reshape(-1) for b in batches]))
    keys_np = all_keys.cpu().numpy().view(np.uint64)
    rows = torch.from_numpy(init_rows(cfg, keys_np)).to(dev)
    lay = row_layout(cfg)
    opt = DenseOptimizer(cfg, params)
    losses, state1 = [], None
    with matmul_precision(precision):
        for keys, label, dense in batches:
            idx = torch.searchsorted(all_keys, keys)
            pulled = rows[idx]
            w = pulled[..., 2].clone().requires_grad_()
            x = pulled[..., lay["x"]].clone().requires_grad_()
            p = {k: v.detach().requires_grad_() for k, v in params.items()}
            logit = fam.forward(cfg, p, pool(cfg, w), pool(cfg, x), dense,
                                precision)
            loss = F.binary_cross_entropy_with_logits(logit, label)
            names = list(p)
            grads = torch.autograd.grad(loss, [p[k] for k in names]
                                        + [w, x])
            g = dict(zip(names, grads[:-2]))
            flat = idx.reshape(-1)
            n = len(all_keys)
            g_w = torch.zeros(n, device=dev).index_add_(
                0, flat, grads[-2].reshape(-1))
            g_x = torch.zeros(n, x.shape[-1], device=dev).index_add_(
                0, flat, grads[-1].reshape(-1, x.shape[-1]))
            show = torch.zeros(n, device=dev).index_add_(
                0, flat, torch.ones_like(flat, dtype=torch.float32))
            clk = torch.zeros(n, device=dev).index_add_(
                0, flat, label[:, None].expand_as(keys).reshape(-1))
            rows = _table_update(cfg, rows, g_w, g_x, show, clk)
            params = opt.step({k: v.detach() for k, v in params.items()},
                              g)
            if state1 is None:
                state1 = {"dense": (dict(opt.mu) if opt.kind == "adam"
                                    else params), "rows": rows}
            losses.append(float(loss.detach()))
    return {"loss": losses, "state1": state1, "params": params,
            "keys": keys_np, "rows": rows}


def scores(cfg: dict, params: dict, rows: torch.Tensor,
           dense: torch.Tensor, precision: str = "float32"):
    """Probabilities of examples whose pulled rows are given:
    rows (N, sum of hotness, >= 3 + dim) as [show, clk, w, embedding]."""
    lay = row_layout(cfg)
    with matmul_precision(precision), torch.no_grad():
        logit = family(cfg).forward(cfg, params, pool(cfg, rows[..., 2]),
                                    pool(cfg, rows[..., lay["x"]]), dense,
                                    precision)
    return torch.sigmoid(logit)
