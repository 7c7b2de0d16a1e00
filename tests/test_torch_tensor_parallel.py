"""The port's tensor parallelism (``parallel/tensor.py``) on gloo worlds
of 2 and 4 ranks against the JAX package's single-device reference.

The JAX package's ``init_tp_mlp`` parameters and a seeded NumPy batch go
to every rank (``weights.tp_mlp_params``); each rank runs its shards of
the planned col/row/rep MLP, forward and (for the gradient cases) the
backward of sum(y**2). Each rank's output must equal JAX's
``mlp_reference`` (rtol 2e-5, atol 2e-5, as tests/test_tensor_parallel.py),
and each rank's shard gradients the slice of ``jax.grad`` of the
reference that the mode plan gives it (rtol 2e-4, atol 2e-5). Covered:
col, row and rep layers (a width-1 head, widths that do not divide by
tp), a trailing col layer gathered over tp, a ("dp", "tp") mesh with the
batch split over dp (forward and gradients summed over dp), and the plan
itself equal to the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddlebox_tpu.parallel import tensor as jtp

from paddlebox_tpu_torch.parallel import tensor as tp

from torch_multirank_spawn import run_parallel_cases

WORLDS = (2, 4)
FWD = [(16, 32, 16), (8, 64, 32, 1), (16, 32), (8, 12, 5), (8, 10, 5)]
GRAD = [(8, 16, 8), (8, 64, 32, 1)]
TOL = dict(rtol=2e-5, atol=2e-5)
GTOL = dict(rtol=2e-4, atol=2e-5)


def _name(kind, dims, n_dp=1):
    return f"{kind}_{'x'.join(map(str, dims))}_dp{n_dp}"


def _inputs(dims, batch, seed):
    params = jtp.init_tp_mlp(jax.random.PRNGKey(seed), dims)
    x = np.random.default_rng(seed).normal(
        size=(batch, dims[0])).astype(np.float32)
    arrays = {"x": x}
    for i, p in enumerate(params):
        arrays[f"w{i}"] = np.asarray(p["w"])
        arrays[f"b{i}"] = np.asarray(p["b"])
    return params, x, arrays


def _world_cases():
    cases = []
    for i, dims in enumerate(FWD):
        cases.append(({"name": _name("fwd", dims), "kind": "tp",
                       "dims": list(dims)}, dims, 16, i))
    for i, dims in enumerate(GRAD):
        cases.append(({"name": _name("grad", dims), "kind": "tp",
                       "dims": list(dims), "grads": True}, dims, 8, 10 + i))
    cases.append(({"name": _name("grad", (8, 16, 4), 2), "kind": "tp",
                   "dims": [8, 16, 4], "n_dp": 2, "grads": True},
                  (8, 16, 4), 32, 20))
    return cases


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    refs, got = {}, {}
    for world in WORLDS:
        cases = []
        for case, dims, batch, seed in _world_cases():
            params, x, arrays = _inputs(dims, batch, seed)
            refs[case["name"]] = (params, x)
            cases.append((case, arrays))
        got[world] = run_parallel_cases(
            str(tmp_path_factory.mktemp(f"tp{world}")), world, cases)
    return refs, got


def _want(params, x):
    return np.asarray(jtp.mlp_reference(params, jnp.asarray(x)))


def _check_out(ranks, want, n_dp):
    b = want.shape[0] // n_dp
    n_tp = len(ranks) // n_dp
    for r, z in enumerate(ranks):
        d = r // n_tp
        np.testing.assert_allclose(z["out"], want[d * b:(d + 1) * b], **TOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("dims", FWD, ids=lambda d: "x".join(map(str, d)))
def test_tp_mlp_matches_reference(worlds, world, dims):
    refs, got = worlds
    params, x = refs[_name("fwd", dims)]
    ranks = got[world][_name("fwd", dims)]
    _check_out(ranks, _want(params, x), 1)
    # the port's plan is the reference's
    assert list(ranks[0]["modes"]) == jtp.plan_modes(dims, world) == \
        tp.plan_modes(dims, world)


def _check_grads(ranks, params, x, dims, n_dp):
    g_ref = jax.grad(lambda p: jnp.sum(
        jtp.mlp_reference(p, jnp.asarray(x)) ** 2))(params)
    n_tp = len(ranks) // n_dp
    modes = jtp.plan_modes(dims, n_tp)
    for r, z in enumerate(ranks):
        i = r % n_tp
        for layer, (g, mode) in enumerate(zip(g_ref, modes)):
            gw, gb = np.asarray(g["w"]), np.asarray(g["b"])
            if mode == "col":
                k = gw.shape[1] // n_tp
                gw, gb = gw[:, i * k:(i + 1) * k], gb[i * k:(i + 1) * k]
            elif mode == "row":
                k = gw.shape[0] // n_tp
                gw = gw[i * k:(i + 1) * k]
            np.testing.assert_allclose(z[f"gw{layer}"], gw, **GTOL)
            np.testing.assert_allclose(z[f"gb{layer}"], gb, **GTOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("dims", GRAD, ids=lambda d: "x".join(map(str, d)))
def test_tp_gradients_match(worlds, world, dims):
    refs, got = worlds
    params, x = refs[_name("grad", dims)]
    ranks = got[world][_name("grad", dims)]
    _check_out(ranks, _want(params, x), 1)
    _check_grads(ranks, params, x, dims, 1)


@pytest.mark.parametrize("world", WORLDS)
def test_tp_with_dp_axis(worlds, world):
    """A ("dp", "tp") mesh: the batch split over dp, forward and the
    gradients summed over dp equal the reference's."""
    refs, got = worlds
    name = _name("grad", (8, 16, 4), 2)
    params, x = refs[name]
    ranks = got[world][name]
    _check_out(ranks, _want(params, x), 2)
    _check_grads(ranks, params, x, (8, 16, 4), 2)


def test_plan_modes_match_reference():
    for dims in FWD + GRAD + [(8, 7, 7, 1), (4, 8, 8, 8, 8)]:
        for n in (1, 2, 3, 4, 8):
            assert tp.plan_modes(dims, n) == jtp.plan_modes(dims, n)


def test_reference_on_carried_params_matches():
    """The port's single-device reference on carried-over params equals
    JAX's (the card checks hold the sharded MLP against it)."""
    import torch
    from paddlebox_tpu_torch import weights
    params, x, _ = _inputs((8, 64, 32, 1), 16, 3)
    got = tp.mlp_reference(weights.tp_mlp_params(
        [{k: np.asarray(v) for k, v in p.items()} for p in params]),
        torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _want(params, x), **TOL)
