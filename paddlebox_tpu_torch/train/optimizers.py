"""Dense optimizers — the port of ``train/optimizers.py``: adam, sgd,
momentum, adagrad, rmsprop and ftrl.

The JAX package builds them with optax (ftrl as its own transform), so
these follow optax's formulas, defaults and keyword names, not
``torch.optim``'s. Every step ends in optax's ``apply_updates``, p += u,
with u already scaled by -lr:

adam     mu = (1-b1) g + b1 mu;  nu = (1-b2) g² + b2 nu;  t += 1
         u = -lr (mu / (1-b1^t)) / (sqrt(nu / (1-b2^t) + eps_root) + eps)
         (nesterov: mu_hat = b1 mu/(1-b1^(t+1)) + (1-b1) g/(1-b1^t))
sgd      u = -lr g
momentum (optax.sgd(momentum=0.9)): trace = g + m trace;  u = -lr trace
         (nesterov: u = -lr (g + m trace))
adagrad  (initial accumulator 0.1, eps 1e-7): s += g²;
         u = -lr g rsqrt(s + eps) where s > 0, else 0
rmsprop  (decay 0.9, eps 1e-8): nu = (1-d) g² + d nu;
         u = -lr g rsqrt(nu + eps)  (eps_in_sqrt=False: g / (sqrt(nu)+eps));
         with ``momentum``, a trace after the lr scale
ftrl     FTRL-proximal over ``ops/ftrl.py``; u = new_w - w

``state_leaves`` gives each optimizer's state in the shape of optax's
state tree — a tuple per ``optax.chain``, a dict per state namedtuple
(fields by name), a per-parameter list of tensors per moment, an int per
step count: adam ``({count, mu, nu}, ())``, sgd ``((), ())``, momentum
``({trace}, ())``, adagrad ``({sum_of_squares}, ())``, rmsprop
``({nu}, (), ())`` (the last ``{trace}`` with momentum), ftrl ``{z, n}``.
``weights.py`` lays the lists out as parameter trees;
``load_state_leaves`` takes the same structure back.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from paddlebox_tpu_torch.ops.ftrl import ftrl_step


def _zeros(params):
    return [torch.zeros_like(p) for p in params]


@torch.no_grad()
def _load(dst: list, src) -> None:
    for d, s in zip(dst, src):
        d.copy_(torch.as_tensor(np.asarray(s, np.float32)))


def _bias_correction(decay: float, count: int) -> float:
    """optax's 1 - decay**count, in f32."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


class _Trace:
    """optax.trace: the momentum accumulator."""

    def __init__(self, params, decay: float, nesterov: bool):
        self.decay, self.nesterov = decay, nesterov
        self.trace = _zeros(params)

    def __call__(self, i: int, u: torch.Tensor) -> torch.Tensor:
        t = self.trace[i]
        t.mul_(self.decay).add_(u)
        return u + self.decay * t if self.nesterov else t


class Adam:
    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 eps_root: float = 0.0, *, nesterov: bool = False):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.eps_root, self.nesterov = eps_root, nesterov
        self.mu = _zeros(self.params)
        self.nu = _zeros(self.params)
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        b1, b2 = self.b1, self.b2
        self.count += 1
        bc1 = _bias_correction(b1, self.count)
        bc2 = _bias_correction(b2, self.count)
        bc1_next = _bias_correction(b1, self.count + 1)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * (g * g))
            mu_hat = (b1 * (mu / bc1_next) + (1 - b1) * (g / bc1)
                      if self.nesterov else mu / bc1)
            upd = mu_hat / (torch.sqrt(nu / bc2 + self.eps_root) + self.eps)
            p.add_(-self.lr * upd)

    def state_leaves(self):
        return ({"count": self.count, "mu": self.mu, "nu": self.nu}, ())

    def load_state_leaves(self, st) -> None:
        adam, _ = st
        self.count = int(adam["count"])
        _load(self.mu, adam["mu"])
        _load(self.nu, adam["nu"])


class Sgd:
    """optax.sgd: plain, or with a momentum trace (``momentum``)."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 momentum: float | None = None, nesterov: bool = False):
        self.params = list(params)
        self.lr = lr
        self.trace = (None if momentum is None
                      else _Trace(self.params, momentum, nesterov))

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        for i, (p, g) in enumerate(zip(self.params, grads)):
            u = g if self.trace is None else self.trace(i, g)
            p.add_(-self.lr * u)

    def state_leaves(self):
        if self.trace is None:
            return ((), ())
        return ({"trace": self.trace.trace}, ())

    def load_state_leaves(self, st) -> None:
        if self.trace is not None:
            _load(self.trace.trace, st[0]["trace"])


class Adagrad:
    """optax.adagrad: scale_by_rss, then the learning rate."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        self.params = list(params)
        self.lr, self.eps = lr, eps
        self.sum_of_squares = [torch.full_like(p, initial_accumulator_value)
                               for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        for p, g, s in zip(self.params, grads, self.sum_of_squares):
            s.add_(g * g)
            scale = torch.where(s > 0, torch.rsqrt(s + self.eps),
                                torch.zeros_like(s))
            p.add_(-self.lr * (scale * g))

    def state_leaves(self):
        return ({"sum_of_squares": self.sum_of_squares}, ())

    def load_state_leaves(self, st) -> None:
        _load(self.sum_of_squares, st[0]["sum_of_squares"])


class RmsProp:
    """optax.rmsprop (not centered, no bias correction): scale_by_rms,
    the learning rate, then a momentum trace when ``momentum`` is
    given."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 decay: float = 0.9, eps: float = 1e-8,
                 initial_scale: float = 0.0, eps_in_sqrt: bool = True,
                 centered: bool = False, momentum: float | None = None,
                 nesterov: bool = False, bias_correction: bool = False):
        if centered or bias_correction:
            raise NotImplementedError(
                "rmsprop(centered=True) and rmsprop(bias_correction=True) "
                "are not ported")
        self.params = list(params)
        self.lr, self.decay, self.eps = lr, decay, eps
        self.eps_in_sqrt = eps_in_sqrt
        self.nu = [torch.full_like(p, initial_scale) for p in self.params]
        self.trace = (None if momentum is None
                      else _Trace(self.params, momentum, nesterov))

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        d = self.decay
        for i, (p, g, nu) in enumerate(zip(self.params, grads, self.nu)):
            nu.mul_(d).add_((1 - d) * (g * g))
            scale = (torch.rsqrt(nu + self.eps) if self.eps_in_sqrt
                     else 1 / (torch.sqrt(nu) + self.eps))
            u = -self.lr * (scale * g)
            if self.trace is not None:
                u = self.trace(i, u)
            p.add_(u)

    def state_leaves(self):
        trace = () if self.trace is None else {"trace": self.trace.trace}
        return ({"nu": self.nu}, (), trace)

    def load_state_leaves(self, st) -> None:
        _load(self.nu, st[0]["nu"])
        if self.trace is not None:
            _load(self.trace.trace, st[2]["trace"])


class Ftrl:
    """FTRL-proximal (``train/optimizers.py::ftrl``): the new weight comes
    from (z, n) directly, and the update is new_w - w."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float = 0.1,
                 l1: float = 0.0, l2: float = 0.0, beta: float = 1.0):
        self.params = list(params)
        self.lr, self.l1, self.l2, self.beta = lr, l1, l2, beta
        self.z = _zeros(self.params)
        self.n = _zeros(self.params)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        for p, g, z, n in zip(self.params, grads, self.z, self.n):
            new_w, new_z, new_n = ftrl_step(g, z, n, p, self.lr, self.l1,
                                            self.l2, self.beta)
            z.copy_(new_z)
            n.copy_(new_n)
            p.add_(new_w - p)

    def state_leaves(self):
        return {"z": self.z, "n": self.n}

    def load_state_leaves(self, st) -> None:
        _load(self.z, st["z"])
        _load(self.n, st["n"])


NAMES = ("adam", "sgd", "momentum", "adagrad", "rmsprop", "ftrl")


def make(name: str, lr: float, params: Sequence[torch.Tensor], **kw):
    """Build a dense optimizer by name over ``params``; ``kw`` are the
    optax constructor's keywords (``TrainerConfig.dense_optimizer_kwargs``)."""
    if name == "adam":
        return Adam(params, lr, **kw)
    if name == "sgd":
        return Sgd(params, lr, **kw)
    if name == "momentum":
        return Sgd(params, lr, momentum=kw.pop("momentum", 0.9), **kw)
    if name == "adagrad":
        return Adagrad(params, lr, **kw)
    if name == "rmsprop":
        return RmsProp(params, lr, **kw)
    if name == "ftrl":
        return Ftrl(params, lr, **kw)
    raise ValueError(f"unknown dense optimizer {name!r}; expected one of "
                     f"{'|'.join(NAMES)}")
