"""Runtime bottleneck observability on the card (the port of
``repro.serving.obs``): a live roofline from an analytic census and
CUDA-event device time, request-lifecycle Chrome/Perfetto tracing, the
memory-gap auditor, windowed telemetry and SLOs, registry-backed metrics
export and a dashboard. See :mod:`repro_torch.serving.obs.observer` for
the wiring overview.

Submodule attributes resolve lazily (PEP 562): the engine imports
``obs.series`` at module load, and an eager import of the rest here would
cycle back into the half-initialised engine module.
"""
import importlib

_EXPORTS = {
    "BoundedSeries": "series", "DEFAULT_SERIES_MAXLEN": "series",
    "Tracer": "trace", "validate_chrome_trace": "trace",
    "LiveRoofline": "roofline", "RooflineSample": "roofline",
    "StepCensus": "roofline", "StepCensusCache": "roofline",
    "EngineObserver": "observer", "Observability": "observer",
    "StepPhases": "observer",
    "SERVING_SPECS": "export", "CLUSTER_SPECS": "export",
    "MetricSpec": "export", "MetricsEmitter": "export",
    "lint_prometheus": "export", "metrics_from_json": "export",
    "metrics_to_json": "export", "prometheus_text": "export",
    "MemoryGapAuditor": "auditor", "MemoryGapStats": "auditor",
    "WasteBreakdown": "auditor", "audit_engine": "auditor",
    "SLO": "windows", "SLOEvent": "windows", "SLOMonitor": "windows",
    "WindowAggregator": "windows", "WindowStat": "windows",
    "default_slos": "windows",
    "Dashboard": "dashboard", "html_report": "dashboard",
    "write_html_report": "dashboard",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)


def __dir__():
    return __all__
