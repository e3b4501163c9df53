"""Observability (port of the always-on half of paddle_tpu/profiler/).

- :mod:`.metrics` — the metrics registry: counters, gauges, histograms and
  the per-rank exporter (``get_registry``);
- :mod:`.tracing` — request-level tracing with tail-based retention
  (``RequestTracer``, ``get_tracer``, ``set_tracer``).

The host recorder and chrome-trace export, ``RecordEvent`` and the
StepTimer wait for ROADMAP A11; timelines on the card come from
``torch.profiler``.
"""
from . import metrics, tracing  # noqa: F401
from .metrics import get_registry  # noqa: F401
from .tracing import RequestTracer, get_tracer, set_tracer  # noqa: F401

__all__ = ["metrics", "tracing", "get_registry", "RequestTracer",
           "get_tracer", "set_tracer"]
