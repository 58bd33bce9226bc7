"""Profiler ranges behind the ``REPRO_TRACE=1`` switch.

``torch.profiler`` traces of a run list anonymous kernels and torch
ops.  These two wrappers label the port's subsystems:

  * :func:`annotate` decorates a function so that each call shows up
    as a named ``torch.profiler.record_function`` range; the kernel
    entry points of ``repro_torch.kernels.ops`` are wrapped with
    ``kernels/<name>`` labels, one range a call.
  * :func:`trace_span` is the context-manager form.

Both are exact no-ops unless ``REPRO_TRACE=1`` is set in the
environment when this module is imported: :func:`annotate` returns the
function itself and :func:`trace_span` a ``contextlib.nullcontext()``.

The drivers' segment ranges (``fed/scan_segment[n]``,
``fed/async_tick_segment[n]``, ``sweep/<scenario>/<selector>``) do
not go through this switch: they are recorded on every run, one range
a segment.  A range recorded while a CUDA graph is captured is not
replayed with the graph, so the ``kernels/*`` ranges label the host
loop's and other eager launches only.

Usage::

    REPRO_TRACE=1 python - <<'PY'
    import torch
    with torch.profiler.profile() as prof:
        ...   # ranges now carry kernels/... labels
    PY

This module imports nothing of ``repro_torch``: ``repro_torch.kernels``
wraps its entry points with it, so the package's import chain stays
free of cycles.
"""
from __future__ import annotations

import contextlib
import functools
import os
from typing import Callable

_ENABLED = os.environ.get("REPRO_TRACE", "") == "1"


def trace_enabled() -> bool:
    """Whether ``REPRO_TRACE=1`` was set when the process started."""
    return _ENABLED


def annotate(name: str) -> Callable:
    """Decorator: label each call of a function as a profiler range
    (no-op unless ``REPRO_TRACE=1``)."""
    def deco(fn: Callable) -> Callable:
        if not _ENABLED:
            return fn
        import torch

        @functools.wraps(fn)
        def ranged(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return ranged

    return deco


def trace_span(name: str):
    """Context manager: label a code region as a profiler range (no-op
    unless ``REPRO_TRACE=1``)."""
    if not _ENABLED:
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(name)
