"""paddlebox_tpu_torch.monitor — the telemetry hub; the port of the JAX
package's ``monitor/``.

The write side: one API over counters, gauges, spans and events with
pass/step context that worker threads inherit (``context.spawn``),
pluggable sinks (``MemorySink``, ``JsonlSink``, ``ParityLogSink``),
per-pass flight records and Prometheus exposition. The read side, each
module imported on its own: ``aggregate`` (per-rank streams into one
world view), ``critical_path`` (who owns the pass wall), ``doctor``
(named findings; ``python -m paddlebox_tpu_torch.monitor.doctor``) and
``trace`` (the world trace and its per-pass device capture; ``python -m
paddlebox_tpu_torch.monitor.trace``). The records and the JSONL stream
are the JAX package's formats, so either package's readers read the
other's.

This package imports nothing from ``paddlebox_tpu_torch.utils`` at import
time: ``utils.profiler`` and ``utils.timer`` import it.
"""

from paddlebox_tpu_torch.monitor import context  # noqa: F401
from paddlebox_tpu_torch.monitor.registry import STATS, StatRegistry  # noqa: F401
from paddlebox_tpu_torch.monitor.sinks import (JsonlSink, MemorySink,  # noqa: F401
                                               ParityLogSink, Sink)
from paddlebox_tpu_torch.monitor.flight import (  # noqa: F401
    EVENT_REQUIRED_KEYS, FLIGHT_REQUIRED_FIELDS, validate_event,
    validate_events_file, validate_flight_record)
from paddlebox_tpu_torch.monitor.hub import (TelemetryHub,  # noqa: F401
                                             counter_add, event, gauge_set,
                                             hub, span,
                                             start_metrics_endpoint)
from paddlebox_tpu_torch.monitor.timers import StageTimers  # noqa: F401
