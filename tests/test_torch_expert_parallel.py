"""The port's expert parallelism (``parallel/expert.py``) on gloo worlds of
2 and 4 ranks against the JAX package's dense reference.

The JAX package's ``init_moe`` parameters and a seeded NumPy batch go to
every rank (``weights.moe_params``); each rank dispatches its slice of
the tokens to the experts of every rank and back. With a capacity that
drops nothing, the outputs concatenated over the ranks equal JAX's
``moe_reference`` (rtol 2e-4, atol 2e-5, as
tests/test_expert_parallel.py), for 8, 16 and 32 experts, top-1 and
top-2; the gradients of sum(y**2) (the experts' on their owners, the
replicated gate's summed over ep) equal ``jax.grad`` of the reference.
At capacity factor 0.25 the port's ``dropped_tokens`` equals JAX's, the
zeroed rows number exactly the dropped assignments (top-1), and every
other row equals the reference. Indivisible experts raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu.parallel import expert as jep

from paddlebox_tpu_torch import weights
from paddlebox_tpu_torch.parallel import expert as ep

from torch_multirank_spawn import run_parallel_cases

WORLDS = (2, 4)
FWD = [(8, 1), (8, 2), (16, 2), (32, 1)]
TOL = dict(rtol=2e-4, atol=2e-5)


def _inputs(num_experts, batch, seed, d_model=16, d_hidden=32):
    params = jep.init_moe(jax.random.PRNGKey(seed), num_experts, d_model,
                          d_hidden)
    x = np.random.default_rng(seed).normal(
        size=(batch, d_model)).astype(np.float32)
    arrays = {k: np.asarray(v) for k, v in params.items()}
    arrays["x"] = x
    return params, x, arrays


def _cases():
    out = []
    for i, (E, k) in enumerate(FWD):
        out.append(({"name": f"fwd_{E}_{k}", "kind": "ep", "num_experts": E,
                     "top_k": k, "capacity_factor": 64.0}, E, 64, 0))
    out.append(({"name": "drop", "kind": "ep", "num_experts": 8,
                 "top_k": 1, "capacity_factor": 0.25}, 8, 64, 0))
    out.append(({"name": "drop2", "kind": "ep", "num_experts": 8,
                 "top_k": 2, "capacity_factor": 0.25}, 8, 64, 1))
    out.append(({"name": "grad", "kind": "ep", "num_experts": 8,
                 "top_k": 2, "capacity_factor": 64.0, "grads": True},
                8, 32, 0))
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    refs, got = {}, {}
    for world in WORLDS:
        cases = []
        for case, E, batch, seed in _cases():
            params, x, arrays = _inputs(E, batch, seed)
            refs[case["name"]] = (params, x)
            cases.append((case, arrays))
        # experts that do not divide over the ranks
        cases.append(({"name": "odd", "kind": "ep",
                       "num_experts": 2 * world + 1, "expect_raise": True},
                      {"x": np.zeros(1, np.float32)}))
        got[world] = run_parallel_cases(
            str(tmp_path_factory.mktemp(f"ep{world}")), world, cases)
    return refs, got


def _full(ranks, key="out"):
    return np.concatenate([z[key] for z in ranks])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("num_experts,top_k", FWD)
def test_moe_matches_dense_reference(worlds, world, num_experts, top_k):
    refs, got = worlds
    name = f"fwd_{num_experts}_{top_k}"
    params, x = refs[name]
    ranks = got[world][name]
    assert jep.dropped_tokens(params, jnp.asarray(x), world, top_k,
                              64.0) == 0
    assert all(int(z["dropped"]) == 0 for z in ranks)
    want = np.asarray(jep.moe_reference(params, jnp.asarray(x),
                                        top_k=top_k))
    np.testing.assert_allclose(_full(ranks), want, **TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_capacity_drops_match_reference(worlds, world):
    refs, got = worlds
    params, x = refs["drop"]
    ranks = got[world]["drop"]
    want_drop = jep.dropped_tokens(params, jnp.asarray(x), world, 1, 0.25)
    assert all(int(z["dropped"]) == want_drop for z in ranks)
    assert want_drop > 0                   # capacity 0.25 must drop
    y = _full(ranks)
    dense = np.asarray(jep.moe_reference(params, jnp.asarray(x), top_k=1))
    match = np.isclose(y, dense, **TOL).all(axis=1)
    zero = (y == 0.0).all(axis=1)
    assert (match | zero).all()
    # top-1: one assignment a token, so the zeroed rows are the drops
    assert int(zero.sum()) == want_drop
    assert match.sum() > 0
    # and they are the reference's: on each rank's slice, a token keeps
    # its lane when fewer than `cap` earlier rows (jnp.argsort is stable)
    # chose its expert
    _, experts = jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x) @ params["gate"], axis=-1), 1)
    experts = np.asarray(experts)[:, 0]
    n_local = x.shape[0] // world
    cap = jep._capacity(n_local, 8, 0.25)
    want_zero = np.zeros(x.shape[0], bool)
    for r in range(world):
        seen = np.zeros(8, int)
        for t in range(r * n_local, (r + 1) * n_local):
            want_zero[t] = seen[experts[t]] >= cap
            seen[experts[t]] += 1
    np.testing.assert_array_equal(zero, want_zero)


@pytest.mark.parametrize("world", WORLDS)
def test_capacity_drops_top2_count(worlds, world):
    refs, got = worlds
    params, x = refs["drop2"]
    want = jep.dropped_tokens(params, jnp.asarray(x), world, 2, 0.25)
    assert all(int(z["dropped"]) == want for z in got[world]["drop2"])
    assert want > 0


@pytest.mark.parametrize("world", WORLDS)
def test_moe_gradients_match(worlds, world):
    refs, got = worlds
    params, x = refs["grad"]
    ranks = got[world]["grad"]
    np.testing.assert_allclose(
        _full(ranks), np.asarray(jep.moe_reference(params, jnp.asarray(x))),
        **TOL)
    g = jax.grad(lambda p: jnp.sum(
        jep.moe_reference(p, jnp.asarray(x)) ** 2))(params)
    e = 8 // world
    for r, z in enumerate(ranks):
        np.testing.assert_allclose(z["ggate"], np.asarray(g["gate"]), **TOL)
        for k in ("w1", "b1", "w2", "b2"):
            np.testing.assert_allclose(
                z[f"g{k}"], np.asarray(g[k])[r * e:(r + 1) * e], **TOL)
    assert np.abs(ranks[0]["gw1"]).sum() > 0


@pytest.mark.parametrize("world", WORLDS)
def test_indivisible_experts_raise(worlds, world):
    for z in worlds[1][world]["odd"]:
        assert "not divisible" in str(z["raised"])


def test_reference_and_drops_on_carried_params():
    """The port's own reference and drop count on carried-over params
    equal JAX's (the card checks hold the sharded MoE against them)."""
    params, x, _ = _inputs(8, 64, 2)
    tparams = weights.moe_params({k: np.asarray(v)
                                  for k, v in params.items()})
    tx = torch.from_numpy(x)
    for k in (1, 2):
        np.testing.assert_allclose(
            ep.moe_reference(tparams, tx, top_k=k).numpy(),
            np.asarray(jep.moe_reference(params, jnp.asarray(x), top_k=k)),
            **TOL)
        for n_ep, cf in ((2, 0.25), (4, 0.5), (8, 2.0)):
            assert ep.dropped_tokens(tparams, tx, n_ep, k, cf) == \
                jep.dropped_tokens(params, jnp.asarray(x), n_ep, k, cf)
