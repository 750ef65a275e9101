"""repro_torch.obs — runtime observability of the serving path: the
always-on metrics registry (:mod:`.metrics`, Prometheus text exposition)
and the span tracer (:mod:`.trace`, Chrome/Perfetto export; a no-op until
``install_tracer``).  Both are copies of the reference's pure-Python
modules.  The reference's communication ledger and its report wait for
the port's collective counter (Alg. 1)."""
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      get_metrics, set_metrics)
from .trace import (SpanRecord, Tracer, current_span_id, get_tracer,
                    install_tracer, span, uninstall_tracer)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_metrics",
    "set_metrics",
    "SpanRecord", "Tracer", "current_span_id", "get_tracer",
    "install_tracer", "span", "uninstall_tracer",
]
