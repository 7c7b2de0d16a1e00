"""Per-stage wall-clock timers — the import path of the JAX package's
``utils/timer.py``; ``StageTimers`` lives in
:mod:`paddlebox_tpu_torch.monitor.timers`.
"""

from __future__ import annotations

from paddlebox_tpu_torch.monitor.timers import StageTimers  # noqa: F401
