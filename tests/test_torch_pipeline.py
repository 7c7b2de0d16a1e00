"""The port's pipeline parallelism (``parallel/pipeline.py``) on gloo
worlds of 2 and 4 ranks against the sequential stages of the JAX
package's ``mlp_stage_fn``.

Seeded stage parameters (stacked as JAX's ``stack_stage_params`` stacks
them, ``weights.stage_params``) and a batch go to every rank; rank i of
the ``pp`` axis runs stage i of the GPipe schedule (M + S - 1 ticks,
activations one ppermute hop a tick, a psum from the last stage). Every
rank's output equals the stages run back to back in JAX (rtol 2e-5,
atol 2e-5, as tests/test_pipeline.py), for several stage and microbatch
counts; the gradients of the mean squared error through the schedule
equal ``jax.grad`` of the sequential loss, stage by stage (rtol 1e-4,
atol 1e-5); a ("dp", "pp") mesh composes with data parallelism (forward
and gradients summed over dp); ``split_stages`` equals the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu.parallel import pipeline as jpp

from paddlebox_tpu_torch import weights
from paddlebox_tpu_torch.parallel import pipeline as pp

from torch_multirank_spawn import run_parallel_cases

WORLDS = (2, 4)
TOL = dict(rtol=2e-5, atol=2e-5)
GTOL = dict(rtol=1e-4, atol=1e-5)
MICRO = (1, 2, 8)


def _stage_params(rng, n_stages, layers, width):
    per = []
    for _ in range(n_stages):
        per.append({
            "w": jnp.asarray(rng.normal(size=(layers, width, width))
                             .astype(np.float32) / np.sqrt(width)),
            "b": jnp.asarray(rng.normal(size=(layers, width))
                             .astype(np.float32) * 0.01)})
    return per


def _inputs(n_stages, layers, width, batch, seed, tgt=False):
    rng = np.random.default_rng(seed)
    per = _stage_params(rng, n_stages, layers, width)
    stacked = jpp.stack_stage_params(per)
    x = rng.normal(size=(batch, width)).astype(np.float32)
    arrays = {"w": np.asarray(stacked["w"]), "b": np.asarray(stacked["b"]),
              "x": x}
    if tgt:
        arrays["tgt"] = rng.normal(size=(batch, width)).astype(np.float32)
    return per, stacked, arrays


def _sequential(stage_fn, per, x):
    h = jnp.asarray(x)
    for p in per:
        h = stage_fn(p, h)
    return np.asarray(h)


def _cases(world):
    out = []
    for m in MICRO:
        case = {"name": f"fwd_m{m}", "kind": "pp", "n_micro": m,
                "activation": "relu"}
        out.append((case, _inputs(world, 2, 16, 32, m)))
    out.append(({"name": "grad", "kind": "pp", "n_micro": 4,
                 "activation": "tanh", "grads": True},
                _inputs(world, 1, 8, 16, 11, tgt=True)))
    if world % 2 == 0:
        out.append(({"name": "dp", "kind": "pp", "n_micro": 4, "n_dp": 2,
                     "activation": "tanh", "grads": True},
                    _inputs(world // 2, 1, 8, 32, 12, tgt=True)))
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    refs, got = {}, {}
    for world in WORLDS:
        cases = _cases(world)
        for case, inputs in cases:
            refs[(world, case["name"])] = inputs
        got[world] = run_parallel_cases(
            str(tmp_path_factory.mktemp(f"pp{world}")), world,
            [(c, i[2]) for c, i in cases])
    return refs, got


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("n_micro", MICRO)
def test_gpipe_matches_sequential(worlds, world, n_micro):
    refs, got = worlds
    per, _, arrays = refs[(world, f"fwd_m{n_micro}")]
    want = _sequential(jpp.mlp_stage_fn(), per, arrays["x"])
    ranks = got[world][f"fwd_m{n_micro}"]
    assert sorted(int(z["stage"]) for z in ranks) == list(range(world))
    for z in ranks:                        # replicated over pp
        np.testing.assert_allclose(z["out"], want, **TOL)


def _grad_check(ranks, per, stacked, arrays, n_dp):
    stage_fn = jpp.mlp_stage_fn(activation=jnp.tanh)
    x, tgt = jnp.asarray(arrays["x"]), jnp.asarray(arrays["tgt"])
    n_stages = len(per)

    def loss_seq(stacked):
        p = [jax.tree.map(lambda a, i=i: a[i], stacked)
             for i in range(n_stages)]
        h = x
        for q in p:
            h = stage_fn(q, h)
        return jnp.mean((h - tgt) ** 2)

    g = jax.grad(loss_seq)(stacked)
    want = _sequential(stage_fn, per, arrays["x"])
    b = want.shape[0] // n_dp
    for r, z in enumerate(ranks):
        d, s = r // n_stages, int(z["stage"])
        np.testing.assert_allclose(z["out"], want[d * b:(d + 1) * b], **TOL)
        np.testing.assert_allclose(z["gw"][0], np.asarray(g["w"][s]),
                                   **GTOL)
        np.testing.assert_allclose(z["gb"][0], np.asarray(g["b"][s]),
                                   **GTOL)


@pytest.mark.parametrize("world", WORLDS)
def test_gpipe_backward_matches_sequential(worlds, world):
    refs, got = worlds
    per, stacked, arrays = refs[(world, "grad")]
    _grad_check(got[world]["grad"], per, stacked, arrays, 1)


@pytest.mark.parametrize("world", WORLDS)
def test_gpipe_composes_with_data_parallel(worlds, world):
    refs, got = worlds
    per, stacked, arrays = refs[(world, "dp")]
    _grad_check(got[world]["dp"], per, stacked, arrays, 2)


def test_split_stages_cut_list():
    layers = list(range(10))
    for kw in (dict(num_stages=2), dict(num_stages=3),
               dict(cut_list=[3, 7]), dict(num_stages=10)):
        assert pp.split_stages(layers, **kw) == jpp.split_stages(layers,
                                                                 **kw)
    assert pp.split_stages(layers, cut_list=[3, 7]) == [
        [0, 1, 2], [3, 4, 5, 6], [7, 8, 9]]
    for kw in (dict(cut_list=[7, 3]), dict(num_stages=11), dict()):
        with pytest.raises(ValueError):
            pp.split_stages(layers, **kw)


def test_stage_fn_and_stacking_match():
    per, stacked, arrays = _inputs(3, 2, 8, 4, 5)
    tstacked = weights.stage_params({"w": arrays["w"], "b": arrays["b"]})
    restacked = pp.stack_stage_params(
        [{k: v[i] for k, v in tstacked.items()} for i in range(3)])
    for k in ("w", "b"):
        np.testing.assert_array_equal(restacked[k].numpy(), arrays[k])
    h = torch.from_numpy(arrays["x"])
    for i in range(3):
        h = pp.mlp_stage_fn()({k: v[i] for k, v in tstacked.items()}, h)
    np.testing.assert_allclose(
        h.numpy(), _sequential(jpp.mlp_stage_fn(), per, arrays["x"]), **TOL)
