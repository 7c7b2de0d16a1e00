"""The exported-program artifact — the port of
``paddlebox_tpu/inference/stablehlo.py`` (``export_stablehlo`` :29,
``load_stablehlo`` :84).

The dense half of the model (everything after the embedding pull,
``make_serving_fn``: sigmoid of the forward) is exported at a fixed
batch size with its parameters baked in, so that a runtime loads and
runs it without the model's Python classes. The host half (the
``ServingTable`` lookup) stays the sorted-array gather any language can
implement against ``serving.npz``.

The artifact here is a ``torch.export`` program (``model.pt2``), not the
reference's StableHLO module: the two are NOT interchangeable, and
neither package loads the other's. The functions keep the reference's
names so that a reader finds the counterpart, and the meta file keeps
its name and keys (``batch_size``, ``total_len``, ``pull_width``,
``num_dense``, ``multi_task``, ``module_crc32``; ``format`` names the
program's kind). Inputs: ``pulled (B, T, P)`` f32, ``mask (B, T)`` bool,
``dense (B, F)`` f32.

The module commits first and the meta naming its CRC32 second, each
atomically: a crash between the two leaves an old meta beside a new
module, which the loader rejects by CRC with ``CheckpointCorruptError``
instead of running the new program against the old static shapes. A
meta written before the CRC existed loads without the check.

An exported program fixes the device it was traced on;
``load_stablehlo`` moves it to the device asked for, the card unless
``device="cpu"``.
"""

from __future__ import annotations

import io
import json
import os
import zlib
from typing import Any

import numpy as np
import torch
from torch import nn

from paddlebox_tpu_torch.data.schema import DataFeedSchema
from paddlebox_tpu_torch.data.slot_record import SparseLayout
from paddlebox_tpu_torch.device import resolve_device
from paddlebox_tpu_torch.inference.predictor import _module, make_serving_fn
from paddlebox_tpu_torch.utils import checkpoint as ckpt_lib

MODULE_FILE = "model.pt2"
META_FILE = "stablehlo_meta.json"
FORMAT = "torch.export"


class _ServingProgram(nn.Module):
    """sigmoid(model(pulled, mask, dense)) with the layout baked in."""

    def __init__(self, model: nn.Module, segment_ids, num_slots: int):
        super().__init__()
        self.model = model
        self._fwd = make_serving_fn(model, segment_ids, num_slots)

    def forward(self, pulled, mask, dense):
        return self._fwd(pulled, mask, dense)


def export_stablehlo(path: str, model: Any, params: Any,
                     schema: DataFeedSchema, batch_size: int,
                     pull_width: int, num_dense: int | None = None,
                     label_slot: str = "label",
                     device: str | torch.device | None = None) -> str:
    """Export sigmoid(model(params, ...)) at a fixed batch size into
    ``path``; returns the module file's path. ``params`` is a JAX-layout
    tree (``weights.model_params``); the program is traced on ``device``
    (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    layout = SparseLayout.from_schema(schema)
    if num_dense is None:
        _, lw, total = schema.float_split_cols(label_slot)
        num_dense = total - lw
    multi_task = hasattr(model, "apply_tasks")
    prog = _ServingProgram(_module(model, params, dev),
                           layout.segment_ids, layout.num_slots).eval()
    B, T = int(batch_size), int(layout.total_len)
    args = (torch.zeros((B, T, int(pull_width)), dtype=torch.float32,
                        device=dev),
            torch.ones((B, T), dtype=torch.bool, device=dev),
            torch.zeros((B, int(num_dense)), dtype=torch.float32,
                        device=dev))
    with torch.no_grad():
        exported = torch.export.export(prog, args)
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    payload = buf.getvalue()
    os.makedirs(path, exist_ok=True)
    fname = os.path.join(path, MODULE_FILE)
    with ckpt_lib.atomic_file(fname) as tmp:
        with open(tmp, "wb") as f:
            f.write(payload)
    with ckpt_lib.atomic_file(os.path.join(path, META_FILE)) as tmp:
        with open(tmp, "w") as f:
            json.dump({"batch_size": B, "total_len": T,
                       "pull_width": int(pull_width),
                       "num_dense": int(num_dense),
                       "multi_task": multi_task,
                       "module_crc32": zlib.crc32(payload) & 0xFFFFFFFF,
                       "format": FORMAT}, f)
    return fname


def load_stablehlo(path: str, device: str | torch.device | None = None):
    """Reload the artifact → ``call(pulled, mask, dense) -> probs``
    (NumPy), running on ``device`` (the card unless ``"cpu"``).

    Rejects a module/meta pair from different exports: the meta's
    ``module_crc32`` must match the module's bytes. A meta without the
    CRC loads without the check."""
    dev = resolve_device(device)
    with open(os.path.join(path, MODULE_FILE), "rb") as f:
        raw = f.read()
    meta_path = os.path.join(path, META_FILE)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        want = meta.get("module_crc32")
        got = zlib.crc32(raw) & 0xFFFFFFFF
        if want is not None and int(want) != got:
            raise ckpt_lib.CheckpointCorruptError(
                meta_path,
                f"exported program module/meta pair mismatch (meta names "
                f"crc {want}, module bytes hash {got}) — torn export; "
                "re-export to re-pair")
    exported = torch.export.load(io.BytesIO(raw))
    from torch.export.passes import move_to_device_pass
    fn = move_to_device_pass(exported, dev).module()

    def call(pulled, mask, dense):
        with torch.no_grad():
            out = fn(torch.as_tensor(np.asarray(pulled, np.float32),
                                     device=dev),
                     torch.as_tensor(np.asarray(mask, bool), device=dev),
                     torch.as_tensor(np.asarray(dense, np.float32),
                                     device=dev))
        return out.cpu().numpy()

    call.device = dev
    call.program = fn
    return call
