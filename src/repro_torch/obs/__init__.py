"""Flight recorder for the port's serving core (own copy of ``repro.obs``):
low-overhead tracing (:mod:`repro_torch.obs.trace`), a metrics registry
with Prometheus/JSONL exposition (:mod:`repro_torch.obs.metrics`), and
Chrome-trace-event timeline export for Perfetto
(:mod:`repro_torch.obs.timeline`).

Everything here is **host-side bookkeeping** and imports no torch:
recording reads only values the engine already holds on the host
(``perf_counter`` stamps, the transport's virtual-clock floats, the ints
and numpy rows of the one device-to-host copy a tick makes anyway) and is
gated behind ``EngineConfig(trace=...)``, so the hot path pays nothing
when tracing is off.  The ``obs-hot-path`` rule of
:mod:`repro_torch.analysis.lint` enforces that no recording call reads a
value still on the card.
"""

from repro_torch.obs.metrics import Metrics
from repro_torch.obs.trace import Event, TraceRecorder
from repro_torch.obs.timeline import (chrome_trace_events,
                                      validate_chrome_trace,
                                      write_chrome_trace)

__all__ = ["TraceRecorder", "Event", "Metrics", "chrome_trace_events",
           "write_chrome_trace", "validate_chrome_trace"]
