"""The PyTorch port stands alone: every module of it (found by walking
the package; the mesh's ``parallel`` and ``distributed`` modules among
them) and the multi-rank tests' rank programs (tests/
torch_multirank_worker.py, tests/torch_resilience_worker.py) import
with jax, jaxlib, optax and paddlebox_tpu blocked, the parameter server
serves there,
it parses through its native parser and runs a MultiSlotDataGenerator
pipe command (itself blocked the same way) there, the serving CLI
starts there, it names none of them in any import, and its entry points
(Trainer, PassWorkingSet, Predictor, ServingServer, PhasedTrainer, the
serving fleet's replicas, the exported program, the parallel modules'
meshes and initializers) refuse to run on the CPU unless asked."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddlebox_tpu_torch

PKG_DIR = os.path.dirname(paddlebox_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)
BLOCKED = ("jax", "jaxlib", "optax", "paddlebox_tpu")

_BLOCKER = f"""
import sys
BLOCKED = {BLOCKED!r}

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.partition(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"{{name!r}} blocked", name=name)
        return None

sys.meta_path.insert(0, Blocker())
"""

_IMPORTS = _BLOCKER + """
import importlib, os, pkgutil
import paddlebox_tpu_torch
# every module of the package, found by walking it: a new module cannot
# escape the check
walked = [m.name for m in pkgutil.walk_packages(
    paddlebox_tpu_torch.__path__, "paddlebox_tpu_torch.")]
for name in walked:
    importlib.import_module(name)
for name in ("paddlebox_tpu_torch.serving.server",
             "paddlebox_tpu_torch.inference.predictor",
             "paddlebox_tpu_torch.train.phased",
             "paddlebox_tpu_torch.metrics.auc_runner",
             "paddlebox_tpu_torch.ops.kernels",
             "paddlebox_tpu_torch.embedding.quant",
             "paddlebox_tpu_torch.embedding.spill_store",
             "paddlebox_tpu_torch.embedding.tiering",
             "paddlebox_tpu_torch.embedding.replica_cache",
             "paddlebox_tpu_torch.embedding.exchange",
             "paddlebox_tpu_torch.parallel.mesh",
             "paddlebox_tpu_torch.parallel.dense_sync",
             "paddlebox_tpu_torch.distributed.store",
             "paddlebox_tpu_torch.distributed.collectives",
             "paddlebox_tpu_torch.distributed.ownership",
             "paddlebox_tpu_torch.distributed.role_maker",
             "paddlebox_tpu_torch.distributed.launch",
             "paddlebox_tpu_torch.distributed.resilience",
             "paddlebox_tpu_torch.distributed.ps",
             "paddlebox_tpu_torch.data.shuffle",
             "paddlebox_tpu_torch.monitor.trace",
             "paddlebox_tpu_torch.serving.router",
             "paddlebox_tpu_torch.serving.fleet",
             "paddlebox_tpu_torch.inference.stablehlo",
             "paddlebox_tpu_torch.parallel.collective_ops",
             "paddlebox_tpu_torch.parallel.tensor",
             "paddlebox_tpu_torch.parallel.expert",
             "paddlebox_tpu_torch.parallel.sequence",
             "paddlebox_tpu_torch.parallel.pipeline"):
    assert name in walked, (name, walked)
# the multi-rank tests' rank program and its helpers: a spawned rank
# imports no JAX
tests_dir = os.path.join(os.path.dirname(paddlebox_tpu_torch.__path__[0]),
                         "tests")
sys.path.insert(0, tests_dir)
for name in ("torch_multirank_common", "torch_multirank_spawn",
             "torch_multirank_worker", "torch_resilience_worker",
             "torch_parallel_worker"):
    importlib.import_module(name)
from paddlebox_tpu_torch.models import MODEL_REGISTRY
assert len(MODEL_REGISTRY) == 7, sorted(MODEL_REGISTRY)

# the native parser parses, and a data generator runs as a pipe command
import os, tempfile
from paddlebox_tpu_torch.data import DataFeedSchema, ParseStats, SlotDataset
from paddlebox_tpu_torch.data import parser
schema = DataFeedSchema.ctr(num_sparse=2, num_float=1)
stats = ParseStats()
got = parser.parse_multislot_buffer(b"1 1 1 0.5 2 7 8 1 9\\n", schema,
                                    stats=stats)
assert parser.is_native() and stats.native == 1 and got.num == 1, stats
with tempfile.TemporaryDirectory() as d:
    gen = os.path.join(d, "gen.py")
    with open(gen, "w") as f:
        f.write(GENERATOR)
    raw = os.path.join(d, "raw")
    with open(raw, "w") as f:
        f.write("3 7,8\\n4 9\\n")
    ds = SlotDataset(schema)
    ds.set_filelist([raw])
    ds.set_pipe_command(f"{sys.executable} {gen}")
    ds.load_into_memory(global_shuffle=False)
assert ds.num_examples == 2 and ds.last_load_stats["native"] == 1
assert ds.records.sparse_values[0].tolist() == [3, 4]
assert ds.records.sparse_values[1].tolist() == [7, 8, 9]
bad = [m for m in sys.modules if m.partition(".")[0] in BLOCKED]
assert not bad, bad
print("OK")
"""

# a pipe_command script: the blocker, then only the port
_GENERATOR = _BLOCKER + """
from paddlebox_tpu_torch.data import DataFeedSchema
from paddlebox_tpu_torch.data.data_generator import MultiSlotDataGenerator


class Gen(MultiSlotDataGenerator):
    def generate_sample(self, line):
        a, b = line.split()
        yield [("label", [1]), ("dense_0", [0.5]), ("slot_0", [a]),
               ("slot_1", b.split(","))]


Gen(DataFeedSchema.ctr(num_sparse=2, num_float=1)).run_from_stdin()
bad = [m for m in sys.modules if m.partition(".")[0] in BLOCKED]
assert not bad, bad
"""


def test_imports_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    script = f"GENERATOR = {_GENERATOR!r}\n" + _IMPORTS
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("OK")


def _port_sources():
    out = []
    for root, dirs, files in os.walk(PKG_DIR):
        dirs[:] = [d for d in dirs if d != "_build"]    # build outputs
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out) + [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(REPO, "tests", f"torch_multirank_{m}.py")
        for m in ("common", "spawn", "worker")] + [
        os.path.join(REPO, "tests", "torch_resilience_worker.py")]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_source_imports_blocked_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.partition(".")[0] not in BLOCKED, (path, n)


def test_trainer_without_device_raises_on_a_host_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("needs a host without CUDA")
    from paddlebox_tpu_torch.data import DataFeedSchema
    from paddlebox_tpu_torch.embedding import (EmbeddingConfig,
                                               HostEmbeddingStore,
                                               PassWorkingSet)
    from paddlebox_tpu_torch.models import DeepFMModel
    from paddlebox_tpu_torch.train import Trainer
    store = HostEmbeddingStore(EmbeddingConfig(dim=4))
    schema = DataFeedSchema.ctr(num_sparse=2, num_float=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(DeepFMModel(2, 4, 1, hidden=(8,)), store, schema)
    with pytest.raises(RuntimeError, match="CUDA"):
        PassWorkingSet.begin_pass(store, [1, 2, 3])


def test_serving_cli_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    script = _BLOCKER + """
import runpy
sys.argv = ["server", "--help"]
try:
    runpy.run_module("paddlebox_tpu_torch.serving.server",
                     run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
bad = [m for m in sys.modules if m.partition(".")[0] in BLOCKED]
assert not bad, bad
print("OK")
"""
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "--health-port" in r.stdout and r.stdout.strip().endswith("OK")


def test_ps_server_runs_with_jax_blocked():
    """``python -m paddlebox_tpu_torch.distributed.ps`` serves with the
    JAX package blocked: a port client creates a table on it, pulls,
    and stops it."""
    env = dict(os.environ, PYTHONPATH=REPO)
    script = _BLOCKER + """
import runpy, threading, time
import numpy as np
sys.argv = ["ps", "--port", "0"]
from paddlebox_tpu_torch.distributed import ps
srv = ps.PSServer("127.0.0.1", 0).start()
c = ps.PSClient([(srv.host, srv.port)])
from paddlebox_tpu_torch.embedding import EmbeddingConfig
c.create_sparse_table("e", EmbeddingConfig(dim=2))
assert c.pull_sparse("e", np.arange(1, 3, dtype=np.uint64)).shape == (2, 5)
c.stop_servers()
srv.stop()
bad = [m for m in sys.modules if m.partition(".")[0] in BLOCKED]
assert not bad, bad
print("OK")
"""
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("OK")


def test_serving_entry_points_refuse_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("needs a host without CUDA")
    from paddlebox_tpu_torch.data import DataFeedSchema
    from paddlebox_tpu_torch.embedding import (EmbeddingConfig,
                                               HostEmbeddingStore)
    from paddlebox_tpu_torch.inference import Predictor, ServingTable
    from paddlebox_tpu_torch.models import DNNCTRModel
    from paddlebox_tpu_torch.serving import ServingServer
    from paddlebox_tpu_torch.train import PhasedTrainer
    from paddlebox_tpu_torch import weights
    schema = DataFeedSchema.ctr(num_sparse=2, num_float=1)
    model = DNNCTRModel(2, 4, 1, hidden=(8,))
    params = weights.model_params(model)
    table = ServingTable(np.zeros(0, np.uint64), np.zeros((0, 7),
                                                          np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(model, params, table, schema)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingServer(str(tmp_path / "serve"))
    store = HostEmbeddingStore(EmbeddingConfig(dim=4))
    upd = DNNCTRModel(2, 4, 1, hidden=(8,), use_cvm=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PhasedTrainer(model, upd, store, schema)
    # each runs when asked for the CPU
    assert Predictor(model, params, table, schema,
                     device="cpu").device.type == "cpu"
    assert ServingServer(str(tmp_path / "serve"),
                         device="cpu").device.type == "cpu"
    pt = PhasedTrainer(model, upd, store, schema, device="cpu")
    assert pt.join.device.type == pt.update.device.type == "cpu"


def test_fleet_export_and_parallel_entry_points_refuse_without_a_card(
        tmp_path):
    """The fleet's replicas, the exported program and the parallel
    modules' meshes and initializers run on the card unless asked for
    the CPU: without a card and without that request they raise."""
    if torch.cuda.is_available():
        pytest.skip("needs a host without CUDA")
    from paddlebox_tpu_torch.inference.stablehlo import load_stablehlo
    from paddlebox_tpu_torch.parallel import expert, pipeline, tensor
    from paddlebox_tpu_torch.serving.fleet import (FleetReplicaServer,
                                                   ReplicaFleet,
                                                   SubprocessReplica)
    root = str(tmp_path / "serve")
    for make in (lambda: ReplicaFleet(root, workdir=str(tmp_path / "fw")),
                 lambda: SubprocessReplica(0, root, staging_root=root,
                                           workdir=str(tmp_path / "w")),
                 lambda: FleetReplicaServer(root),
                 lambda: load_stablehlo(str(tmp_path / "prog")),
                 lambda: tensor.make_tp_mesh(1),
                 lambda: expert.make_ep_mesh(1),
                 lambda: pipeline.make_pp_mesh(1),
                 lambda: tensor.init_tp_mlp(0, (4, 8)),
                 lambda: expert.init_moe(0, 2, 4, 8)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    # each builds when asked for the CPU (the fleet spawns nothing yet)
    fleet = ReplicaFleet(root, workdir=str(tmp_path / "fw"), device="cpu")
    assert fleet.device == "cpu"
    assert all(r.device == "cpu" for r in fleet.replicas)
    assert FleetReplicaServer(root, device="cpu").device.type == "cpu"
    assert tensor.init_tp_mlp(0, (4, 8), device="cpu")[0]["w"].shape == (4,
                                                                           8)
