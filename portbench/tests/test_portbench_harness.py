"""The harness: the no-JAX rule, a run's last line, and a cell added by
files and entries alone."""

from __future__ import annotations

import json
import os
import shutil

from portbench import harness
from portbench.tests.portbench_tiny import ROOT, run_cell


def test_forbidden_names_compare_whole_top_level_names():
    loaded = ["paddlebox_tpu_torch", "paddlebox_tpu_torch.train",
              "jaxtyping", "flaxen.x", "numpy"]
    assert harness.forbidden_modules(loaded) == []
    bad = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
           "paddlebox_tpu", "paddlebox_tpu.ops"]
    assert harness.forbidden_modules(loaded + bad) == sorted(bad)


def test_tiny_run_prints_a_result_line():
    res = run_cell("deepfm_criteo.train", trace=1)
    assert set(res) >= {"correct", "attempted", "failed", "metrics",
                        "device", "checks"}
    assert list(res)[-1] == "checks"
    # a CPU run reads no device metric, and its host metrics are there
    assert "mfu.train" not in res["metrics"]
    assert res["metrics"]["pack_ms.train"]["value"] > 0


def test_a_new_mix_is_found_by_name(tmp_path):
    """A later change adds a cell with files and BENCHMARK.json entries
    only: a throwaway mix beside the shipped ones, in a copy of the
    harness, runs without an edit to any file that was there."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "paddlebox_tpu_torch"),
               root / "paddlebox_tpu_torch")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(root / "portbench" / "traffic" / "train.json") as f:
        mix = json.load(f)
    mix["pass_batches"] = 2
    with open(root / "portbench" / "traffic" / "short_passes.json",
              "w") as f:
        json.dump(mix, f)
    (root / "portbench" / "limits" / "deepfm_criteo.short_passes.json") \
        .write_text((root / "portbench" / "limits"
                     / "deepfm_criteo.train.json").read_text())
    bench["workloads"].append({"name": "deepfm_criteo.short_passes",
                               "config": "deepfm_criteo",
                               "traffic": "short_passes", "chips": 1,
                               "why": "a throwaway cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "deepfm_criteo.train" in m.get("workloads", []):
            m["workloads"].append("deepfm_criteo.short_passes")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run_cell("deepfm_criteo.short_passes", root=str(root))
    assert res["correct"]
    assert res["metrics"]["train_examples_per_s"]["value"] > 0
