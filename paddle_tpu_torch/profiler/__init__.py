"""Observability (port of the always-on half of paddle_tpu/profiler/).

- :mod:`.metrics` — the metrics registry: counters, gauges, histograms and
  the per-rank exporter (``get_registry``);
- :mod:`.tracing` — request-level tracing with tail-based retention
  (``RequestTracer``, ``get_tracer``, ``set_tracer``);
- :mod:`.steptimer` — step-phase attribution (``StepTimer``,
  ``get_steptimer``), which ``hapi.Model.fit`` and ``io`` feed.

The host recorder and chrome-trace export and ``RecordEvent`` wait for
ROADMAP A11; timelines on the card come from ``torch.profiler``.
"""
from . import metrics, steptimer, tracing  # noqa: F401
from .metrics import get_registry  # noqa: F401
from .steptimer import get_steptimer  # noqa: F401
from .tracing import RequestTracer, get_tracer, set_tracer  # noqa: F401

__all__ = ["metrics", "steptimer", "tracing", "get_registry",
           "get_steptimer", "RequestTracer", "get_tracer", "set_tracer"]
