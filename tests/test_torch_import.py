"""The PyTorch port stands alone: it imports with jax, jaxlib, optax and
paddlebox_tpu blocked, parses through its native parser and runs a
MultiSlotDataGenerator pipe command (itself blocked the same way) there,
names none of them in any import, and its entry points refuse to run on
the CPU unless asked."""

import ast
import os
import subprocess
import sys

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
import paddlebox_tpu_torch
import paddlebox_tpu_torch.data, paddlebox_tpu_torch.embedding.sharded
import paddlebox_tpu_torch.embedding.feed_pass
import paddlebox_tpu_torch.fleet, paddlebox_tpu_torch.metrics
import paddlebox_tpu_torch.models, paddlebox_tpu_torch.ops.kernels
import paddlebox_tpu_torch.train, paddlebox_tpu_torch.weights
import paddlebox_tpu_torch.fleet.fleet_util, paddlebox_tpu_torch.metrics.metric
import paddlebox_tpu_torch.utils.checkpoint, paddlebox_tpu_torch.utils.fs
import paddlebox_tpu_torch.utils.faultpoint, paddlebox_tpu_torch.utils.pass_ckpt
import paddlebox_tpu_torch.data.archive, paddlebox_tpu_torch.data.channel
import paddlebox_tpu_torch.data.data_generator
import paddlebox_tpu_torch.data.queue_dataset, paddlebox_tpu_torch.train.heter
import paddlebox_tpu_torch.native.slot_parser, paddlebox_tpu_torch.utils.hashing
import paddlebox_tpu_torch.models.base, paddlebox_tpu_torch.models.dnn_ctr
import paddlebox_tpu_torch.models.wide_deep, paddlebox_tpu_torch.models.dcn
import paddlebox_tpu_torch.models.dlrm, paddlebox_tpu_torch.models.mmoe
import paddlebox_tpu_torch.models.pv_rank, paddlebox_tpu_torch.ops.batch_fc
import paddlebox_tpu_torch.ops.rank_attention
import paddlebox_tpu_torch.ops.cross_norm
import paddlebox_tpu_torch.ops.extended, paddlebox_tpu_torch.ops.fused_concat
import paddlebox_tpu_torch.ops.share_embedding
import paddlebox_tpu_torch.train.optimizers, paddlebox_tpu_torch.utils.profiler
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
    return sorted(out) + [os.path.join(REPO, "chip_smoke.py")]


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
