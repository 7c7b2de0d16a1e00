"""The PyTorch port stands alone: it imports with jax, jaxlib, optax and
paddlebox_tpu blocked, names none of them in any import, and its entry
points refuse to run on the CPU unless asked."""

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
import paddlebox_tpu_torch
import paddlebox_tpu_torch.data, paddlebox_tpu_torch.embedding.sharded
import paddlebox_tpu_torch.embedding.feed_pass
import paddlebox_tpu_torch.fleet, paddlebox_tpu_torch.metrics
import paddlebox_tpu_torch.models, paddlebox_tpu_torch.ops.kernels
import paddlebox_tpu_torch.train, paddlebox_tpu_torch.weights
import paddlebox_tpu_torch.fleet.fleet_util, paddlebox_tpu_torch.metrics.metric
import paddlebox_tpu_torch.utils.checkpoint, paddlebox_tpu_torch.utils.fs
import paddlebox_tpu_torch.utils.faultpoint, paddlebox_tpu_torch.utils.pass_ckpt
bad = [m for m in sys.modules if m.partition(".")[0] in BLOCKED]
assert not bad, bad
print("OK")
"""


def test_imports_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _BLOCKER], env=env,
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
