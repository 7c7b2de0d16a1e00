"""The port's sequence parallelism (``parallel/sequence.py``) on gloo
worlds of 2 and 4 ranks against the JAX package's full attention.

Seeded NumPy q, k, v go to every rank; each rank takes its contiguous
sequence shard and runs ring or Ulysses attention over the world (the
mesh's ``dp`` axis, as tests/test_sequence_parallel.py uses
``make_mesh``). The shards of the output, concatenated over the ranks,
equal JAX's ``attention_reference`` (rtol 2e-4, atol 2e-5), causal and
not; the gradients of sum(y**2) with respect to q, k and v, through the
ring's ppermutes and Ulysses' all-to-alls, equal ``jax.grad`` of the
reference (rtol 5e-4, atol 5e-4); a long ring (S = 512) holds the same;
a bf16 ring returns bf16 within 0.06 of the f32 reference (its state
accumulates in f32); Ulysses with heads that do not divide by the world
raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu.parallel.sequence import (
    attention_reference as jax_attention)

from paddlebox_tpu_torch.parallel import sequence as sp

from torch_multirank_spawn import run_parallel_cases

WORLDS = (2, 4)
MODES = ("ring", "ulysses")
TOL = dict(rtol=2e-4, atol=2e-5)
GTOL = dict(rtol=5e-4, atol=5e-4)
BF16_TOL = dict(rtol=0.06, atol=0.06)


def _qkv(B=2, S=64, H=8, D=16, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda: rng.normal(size=(B, S, H, D)).astype(np.float32) * 0.5
    return {"q": mk(), "k": mk(), "v": mk()}


def _cases(world):
    out = []
    for mode in MODES:
        for causal in (False, True):
            out.append(({"name": f"{mode}_{int(causal)}", "kind": "sp",
                         "mode": mode, "causal": causal}, _qkv()))
        out.append(({"name": f"grad_{mode}", "kind": "sp", "mode": mode,
                     "causal": True, "grads": True},
                    _qkv(B=1, S=32, H=8, D=8, seed=3)))
    out.append(({"name": "long", "kind": "sp", "mode": "ring",
                 "causal": False}, _qkv(B=1, S=512, H=2, D=8, seed=1)))
    out.append(({"name": "bf16", "kind": "sp", "mode": "ring",
                 "causal": False, "bf16": True}, _qkv(S=128)))
    out.append(({"name": "bf16_causal", "kind": "sp", "mode": "ring",
                 "causal": True, "bf16": True}, _qkv(S=128, seed=4)))
    # heads that do not divide by the world
    out.append(({"name": "bad_heads", "kind": "sp", "mode": "ulysses",
                 "causal": False, "expect_raise": True},
                _qkv(H=world + 1)))
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    refs, got = {}, {}
    for world in WORLDS:
        cases = _cases(world)
        for case, arrays in cases:
            refs[(world, case["name"])] = (case, arrays)
        got[world] = run_parallel_cases(
            str(tmp_path_factory.mktemp(f"sp{world}")), world, cases)
    return refs, got


def _full(ranks, key="out"):
    return np.concatenate([z[key] for z in ranks], axis=1)


def _want(a, causal):
    return np.asarray(jax_attention(jnp.asarray(a["q"]), jnp.asarray(a["k"]),
                                    jnp.asarray(a["v"]), causal=causal))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("causal", [False, True])
def test_matches_full_attention(worlds, world, mode, causal):
    refs, got = worlds
    name = f"{mode}_{int(causal)}"
    _, a = refs[(world, name)]
    np.testing.assert_allclose(_full(got[world][name]), _want(a, causal),
                               **TOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", MODES)
def test_gradients_match(worlds, world, mode):
    refs, got = worlds
    _, a = refs[(world, f"grad_{mode}")]
    ranks = got[world][f"grad_{mode}"]
    np.testing.assert_allclose(_full(ranks), _want(a, True), **TOL)

    def loss(q, k, v):
        return jnp.sum(jax_attention(q, k, v, causal=True) ** 2)

    g_ref = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(a["q"]), jnp.asarray(a["k"]), jnp.asarray(a["v"]))
    for name, g in zip("qkv", g_ref):
        np.testing.assert_allclose(_full(ranks, f"g{name}"), np.asarray(g),
                                   **GTOL)


@pytest.mark.parametrize("world", WORLDS)
def test_ring_long_sequence(worlds, world):
    refs, got = worlds
    _, a = refs[(world, "long")]
    np.testing.assert_allclose(_full(got[world]["long"]), _want(a, False),
                               **TOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name,causal", [("bf16", False),
                                         ("bf16_causal", True)])
def test_ring_bf16_accumulates_in_f32(worlds, world, name, causal):
    refs, got = worlds
    _, a = refs[(world, name)]
    ranks = got[world][name]
    assert all(str(z["dtype"]) == "torch.bfloat16" for z in ranks)
    np.testing.assert_allclose(_full(ranks), _want(a, causal), **BF16_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_ulysses_rejects_bad_heads(worlds, world):
    for z in worlds[1][world]["bad_heads"]:
        assert "not divisible" in str(z["raised"])


@pytest.mark.parametrize("causal", [False, True])
def test_reference_matches(causal):
    """The port's single-device reference equals JAX's (the card checks
    hold the sharded attention against it)."""
    a = _qkv(S=48, seed=7)
    got = sp.attention_reference(*(torch.from_numpy(a[k]) for k in "qkv"),
                                 causal=causal)
    np.testing.assert_allclose(got.numpy(), _want(a, causal), **TOL)
