"""The port's DeepFM against the JAX package's: with the JAX parameters
carried across by weights.py, the forward pass and the grads of the mean
sigmoid cross-entropy with respect to every parameter and to the pulled
input match at rtol 1e-5 / atol 1e-6, on the pooled (fused pull) and the
per-token (gather + in-model pool) inputs."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax

from paddlebox_tpu.models import DeepFMModel as JaxDeepFM
from paddlebox_tpu.ops.seqpool_cvm import PooledSlots as JaxPooled

from paddlebox_tpu_torch import weights
from paddlebox_tpu_torch.models import DeepFMModel
from paddlebox_tpu_torch.ops.seqpool_cvm import PooledSlots

# One intra-op thread: several test workers share the cores with the JAX
# tests' 8-device CPU meshes, and torch's default pool (a thread per core
# in every worker) would oversubscribe them.
torch.set_num_threads(1)

S, D, DENSE, L, B = 5, 8, 3, 4, 16
HIDDEN = (32, 16)
TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(pooled: bool, seed=0):
    rng = np.random.default_rng(seed)
    P = 3 + D
    if pooled:
        x = rng.normal(size=(B, S, P)).astype(np.float32)
        x[..., 0] = rng.integers(0, 30, (B, S))       # show >= clk >= 0
        x[..., 1] = np.minimum(x[..., 0], rng.integers(0, 5, (B, S)))
    else:
        x = rng.normal(size=(B, S * L, P)).astype(np.float32)
        x[..., 0] = rng.integers(0, 30, (B, S * L))
        x[..., 1] = np.minimum(x[..., 0], rng.integers(0, 5, (B, S * L)))
    mask = rng.random((B, S * L)) < 0.8
    dense = rng.normal(size=(B, DENSE)).astype(np.float32)
    labels = (rng.random(B) < 0.4).astype(np.float32)
    return x, mask, dense, labels


@pytest.mark.parametrize("pooled", [True, False], ids=["pooled", "tokens"])
def test_forward_and_grads_match_reference(pooled):
    x, mask, dense, labels = _inputs(pooled)
    seg = np.repeat(np.arange(S, dtype=np.int32), L)
    jm = JaxDeepFM(S, D, DENSE, hidden=HIDDEN)
    jparams = jm.init(jax.random.PRNGKey(3))

    def jloss(p, xin):
        inp = JaxPooled(xin) if pooled else xin
        logits = jm.apply(p, inp, jnp.asarray(mask), jnp.asarray(dense),
                          seg, S)
        return jnp.mean(optax.sigmoid_binary_cross_entropy(
            logits, jnp.asarray(labels))), logits

    (jl, jlogits), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jparams, jnp.asarray(x))

    m = DeepFMModel(S, D, DENSE, hidden=HIDDEN)
    weights.load_deepfm_params(m, jax.tree.map(np.asarray, jparams))
    xt = torch.from_numpy(x).requires_grad_()
    inp = PooledSlots(xt) if pooled else xt
    logits = m(inp, torch.from_numpy(mask), torch.from_numpy(dense), seg, S)
    loss = F.binary_cross_entropy_with_logits(logits,
                                              torch.from_numpy(labels))
    loss.backward()

    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **TOL)
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **TOL)
    for i, layer in enumerate(m.mlp.layers):
        np.testing.assert_allclose(layer.w.grad.numpy(),
                                   np.asarray(jgp["mlp"][i]["w"]), **TOL)
        np.testing.assert_allclose(layer.b.grad.numpy(),
                                   np.asarray(jgp["mlp"][i]["b"]), **TOL)
    np.testing.assert_allclose(m.bias.grad.numpy(), np.asarray(jgp["bias"]),
                               **TOL)
    np.testing.assert_allclose(m.wide_dense.grad.numpy(),
                               np.asarray(jgp["wide_dense"]), **TOL)


def test_params_round_trip():
    jm = JaxDeepFM(S, D, DENSE, hidden=HIDDEN)
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    m = DeepFMModel(S, D, DENSE, hidden=HIDDEN)
    weights.load_deepfm_params(m, p)
    back = weights.deepfm_params(m)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        weights.load_deepfm_params(
            DeepFMModel(S, D, DENSE, hidden=(32, 8)), p)
