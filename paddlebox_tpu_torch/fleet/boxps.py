"""Pass/day lifecycle façade — the port of ``fleet/boxps.py``.

The user-facing lifecycle is

    box.set_date(d)
    box.begin_pass()
    trainer.train_pass(dataset)   # builds and writes back the working set
    box.end_pass()

``Trainer.train_pass`` does the per-pass device working-set build and
write-back itself, so begin/end here is pass bookkeeping. Checkpointing
(``end_pass(checkpointer=...)``), delta saves, publishing and multi-host
barriers are not ported yet (ROADMAP).
"""

from __future__ import annotations

import time
from typing import Any

from paddlebox_tpu_torch.embedding.store import HostEmbeddingStore


class BoxPS:
    """Owns the sparse store and the pass state for one job."""

    def __init__(self, store: HostEmbeddingStore):
        self.store = store
        self.date: int | None = None
        self.pass_id = 0
        self.in_pass = False
        self._pass_t0 = 0.0

    def set_date(self, date: int) -> None:
        self.date = int(date)

    def begin_pass(self) -> None:
        if self.in_pass:
            raise RuntimeError("begin_pass while a pass is open")
        self.in_pass = True
        self.pass_id += 1
        self._pass_t0 = time.time()

    def end_pass(self) -> dict[str, Any]:
        if not self.in_pass:
            raise RuntimeError("end_pass without begin_pass")
        self.in_pass = False
        return {"pass_id": self.pass_id,
                "seconds": time.time() - self._pass_t0}
