"""Flag registry — the port's copy of ``paddlebox_tpu.config``.

Only the flags this package reads, under the same names, defaults and
``PBTPU_<NAME>`` environment overrides as the JAX package, so a forced
value means the same thing in both.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any


@dataclasses.dataclass
class Flags:
    # parse/download threads of SlotDataset.load_into_memory
    dataset_load_thread_num: int = 8
    # pack-pipeline depth: translate + host plan for batch k+1 run on a
    # background thread while step k trains. 0 = synchronous.
    prefetch_batches: int = 2
    # physical column count of the f32 device table: 0 = logical row
    # width, "auto" = 64 for widths in [14, 64), N = explicit width
    table_pad_width: Any = 0
    # host-plan dedup pre-merge: "auto" | "on" | "off" (see
    # train.trainer.Trainer._dedup_premerge)
    push_dedup_premerge: str = "auto"
    # fused gather-pool pull: "auto" | "on" | "off" (see
    # train.trainer.Trainer._select_pull_engine)
    fused_gather_pool: str = "auto"
    # push merge-engine override: "auto" or one of ops.kernels.PUSH_ENGINES
    # (legacy "kernel"/"scatter"/"fused" spellings normalize)
    push_engine: str = "auto"
    # enable knob of the binned push engine: "auto" sends narrow raw
    # token streams on the card to binned_kernel only while this is set
    # (a forced flags.push_engine="binned_kernel" ignores it)
    binned_push: bool = True

    def set(self, name: str, value: Any) -> None:
        if not hasattr(self, name):
            raise KeyError(f"unknown flag {name!r}")
        setattr(self, name, value)

    @classmethod
    def from_env(cls) -> "Flags":
        f = cls()
        for field in dataclasses.fields(cls):
            env_key = "PBTPU_" + field.name.upper()
            if env_key in os.environ:
                raw = os.environ[env_key]
                if field.type in ("int", int):
                    f.set(field.name, int(raw))
                elif field.type in ("bool", bool):
                    f.set(field.name, raw.lower() in ("1", "true", "yes"))
                else:
                    f.set(field.name, raw)
        return f


flags = Flags.from_env()
