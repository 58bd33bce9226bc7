"""Device-resident telemetry: the round step's metrics dict, host-side
JSONL export, and profiler ranges.

The port of the reference's ``telemetry`` package:

  metrics.py — a :class:`MetricsSpec` registry of metric *groups*
               (``selection`` / ``training`` / ``fairness`` /
               ``async``); each enabled group contributes fields to a
               flat ``{"group/field": tensor}`` dict, an extra output of
               the round step in every driver (host loop, scanned
               driver, seed sweep, async tick).  Disabled groups are
               zero-width tensors: the same structure, no second code
               path, one capture.
  export.py  — flattens stacked telemetry to JSONL and a summary dict,
               and stamps environment metadata (torch version, backend,
               git SHA) for benchmark artifacts.
  trace.py   — ``torch.profiler`` ranges behind the ``REPRO_TRACE=1``
               switch on the kernel entry points.
"""
from repro_torch.telemetry.export import (env_stamp, read_jsonl,
                                          records_from_telemetry, summarize,
                                          telemetry_from_records,
                                          write_jsonl, write_run,
                                          write_sweep)
from repro_torch.telemetry.metrics import (GROUPS, Metrics, MetricsSpec,
                                           TelemetryCtx, client_true_entropy,
                                           make_metrics)
from repro_torch.telemetry.trace import annotate, trace_enabled, trace_span

__all__ = [
    "GROUPS", "Metrics", "MetricsSpec", "TelemetryCtx",
    "client_true_entropy", "make_metrics",
    "env_stamp", "read_jsonl", "records_from_telemetry", "summarize",
    "telemetry_from_records", "write_jsonl", "write_run", "write_sweep",
    "annotate", "trace_enabled", "trace_span",
]
