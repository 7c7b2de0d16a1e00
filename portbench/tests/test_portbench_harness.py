"""The harness: the no-JAX rule, a run's last line, and a cell, a mix
or a model family added by files and entries alone."""

from __future__ import annotations

import filecmp
import json
import os
import shutil

import pytest

from portbench import harness, program
from portbench.counts import flops
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


def _checkout(tmp_path):
    """A copy of the harness beside the program, and BENCHMARK.json."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "paddlebox_tpu_torch"),
               root / "paddlebox_tpu_torch")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return root, json.load(f)


def _add_cell(bench: dict, name: str, config: str, traffic: str) -> None:
    """The cell's entry, and its name wherever the DeepFM training cell's
    is."""
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": traffic, "chips": 1,
                               "why": "a throwaway cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "deepfm_criteo.train" in m.get("workloads", []):
            m["workloads"].append(name)


def _unedited(root) -> None:
    """Every file the harness had is in the copy as it was."""
    for dirpath, dirs, files in os.walk(os.path.join(ROOT, "portbench")):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in files:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, ROOT)
            assert filecmp.cmp(path, root / rel, shallow=False), rel


def test_a_new_mix_is_found_by_name(tmp_path):
    """A later change adds a cell with files and BENCHMARK.json entries
    only: a throwaway mix beside the shipped ones, in a copy of the
    harness, runs without an edit to any file that was there."""
    root, bench = _checkout(tmp_path)
    with open(root / "portbench" / "traffic" / "train.json") as f:
        mix = json.load(f)
    mix["pass_batches"] = 2
    with open(root / "portbench" / "traffic" / "short_passes.json",
              "w") as f:
        json.dump(mix, f)
    (root / "portbench" / "limits" / "deepfm_criteo.short_passes.json") \
        .write_text((root / "portbench" / "limits"
                     / "deepfm_criteo.train.json").read_text())
    _add_cell(bench, "deepfm_criteo.short_passes", "deepfm_criteo",
              "short_passes")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    _unedited(root)
    res = run_cell("deepfm_criteo.short_passes", root=str(root))
    assert res["correct"]
    assert res["metrics"]["train_examples_per_s"]["value"] > 0


def test_a_new_family_is_found_by_name(tmp_path):
    """A model family is added by files and entries alone: a throwaway
    family (``families/`` and ``reference/`` files, copies of DeepFM's),
    its configuration, limits and BENCHMARK.json entries, in a copy of
    the harness, with no file that was there edited."""
    root, bench = _checkout(tmp_path)
    pb = root / "portbench"
    for kind in ("families", "reference"):
        shutil.copy(pb / kind / "deepfm.py", pb / kind / "fm_copy.py")
    with open(pb / "configs" / "deepfm_criteo.json") as f:
        cfg = json.load(f)
    cfg.update(name="fm_copy_criteo", family="fm_copy")
    (pb / "configs" / "fm_copy_criteo.json").write_text(json.dumps(cfg))
    (pb / "limits" / "fm_copy_criteo.train.json").write_text(
        (pb / "limits" / "deepfm_criteo.train.json").read_text())
    entry = next(c for c in bench["configs"]
                 if c["name"] == "deepfm_criteo")
    bench["configs"].append(dict(
        entry, name="fm_copy_criteo",
        file="portbench/configs/fm_copy_criteo.json"))
    _add_cell(bench, "fm_copy_criteo.train", "fm_copy_criteo", "train")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    _unedited(root)
    res = run_cell("fm_copy_criteo.train", root=str(root))
    assert res["correct"], res["checks"]
    assert res["metrics"]["train_examples_per_s"]["value"] > 0


def test_an_unknown_family_names_its_missing_file():
    cfg = {"family": "no_such_family", "num_sparse": 2, "num_dense": 1,
           "embedding_dim": 4}
    for call in (program.model, flops.train_flops_per_example):
        with pytest.raises(harness.BenchError,
                           match="families/no_such_family.py is missing"):
            call(cfg)
