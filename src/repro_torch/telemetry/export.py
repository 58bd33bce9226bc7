"""Host-side telemetry export: JSONL runs, summaries, env stamps.

The port of the reference's ``telemetry/export.py``.  The device side
(:mod:`repro_torch.telemetry.metrics`) hands back a flat
``{"group/field": array}`` dict with a leading time axis: ``(T, ...)``
from a single run, ``(S, T, ...)`` from the sweep.  This module is the
one host transfer at the end of a run:

  * :func:`write_run` / :func:`write_sweep` — flatten to JSONL, one
    record per round (per seed/cell for sweeps), preceded by a header
    record carrying the env stamp, user metadata and field list.
    Zero-width fields (disabled groups) are simply absent from the
    records, so a reader never confuses "off" with "measured 0".
  * :func:`read_jsonl` / :func:`telemetry_from_records` — the inverse.
  * :func:`summarize` — compact ``{field: {last, mean, min, max}}``
    digest for logs and benchmark payloads.
  * :func:`env_stamp` — torch version, backend and device kind, CPU
    count, git SHA: the keys of the reference's stamp, ``"torch"``
    where it has ``"jax"``, so its ``tools/bench_gate.py`` reads a
    stamp of the port unchanged.

Everything here is plain Python and numpy (``env_stamp`` imports torch
when called); nothing is called from inside a round step.
"""
from __future__ import annotations

import json
import os
import platform
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional

import numpy as np


# ---------------------------------------------------------------------------
# environment stamp
# ---------------------------------------------------------------------------

def _git_sha() -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else None
    except Exception:
        return None


def env_stamp() -> Dict[str, Any]:
    """Machine/runtime identity for benchmark artifacts.

    The comparison key for the bench gate is the subset that changes
    perf characteristics: backend, device kind and CPU count.  The rest
    (versions, SHA) is provenance.  ``backend`` is ``"cuda"`` where a
    card is visible, else ``"cpu"``.
    """
    import torch
    cuda = torch.cuda.is_available()
    return {
        "torch": torch.__version__,
        "backend": "cuda" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 1,
        "cpu_count": os.cpu_count(),
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "git_sha": _git_sha(),
    }


#: env-stamp keys that must match for a benchmark comparison to be fair.
COMPARE_KEYS = ("backend", "device_kind", "cpu_count")


def env_comparable(a: Dict[str, Any], b: Dict[str, Any]) -> bool:
    """Whether two env stamps came from perf-equivalent machines."""
    return all(a.get(k) == b.get(k) for k in COMPARE_KEYS)


# ---------------------------------------------------------------------------
# telemetry -> records
# ---------------------------------------------------------------------------

def _live_fields(telemetry: Dict[str, Any]) -> List[str]:
    """Field names whose trailing width is non-zero (enabled groups)."""
    out = []
    for name in sorted(telemetry):
        arr = np.asarray(telemetry[name])
        if arr.ndim == 0 or 0 not in arr.shape:
            out.append(name)
    return out


def _jsonify(v: np.ndarray):
    arr = np.asarray(v)
    if arr.ndim == 0:
        return arr.item()
    return arr.tolist()


def records_from_telemetry(telemetry: Dict[str, Any],
                           extra: Optional[Dict[str, Any]] = None,
                           ) -> List[Dict[str, Any]]:
    """One JSON-ready record per round from a ``(T, ...)``-stacked
    telemetry dict.  Zero-width fields are dropped; ``extra`` keys
    (e.g. ``{"seed": 3, "cell": "hics"}``) are merged into every
    record."""
    fields = _live_fields(telemetry)
    if not fields:
        return []
    arrays = {k: np.asarray(telemetry[k]) for k in fields}
    steps = {a.shape[0] for a in arrays.values()}
    if len(steps) != 1:
        raise ValueError(f"inconsistent time axes across fields: {steps}")
    (T,) = steps
    records = []
    for t in range(T):
        rec: Dict[str, Any] = {"kind": "round", "t": t}
        if extra:
            rec.update(extra)
        for k in fields:
            rec[k] = _jsonify(arrays[k][t])
        records.append(rec)
    return records


def telemetry_from_records(records: Iterable[Dict[str, Any]],
                           ) -> Dict[str, np.ndarray]:
    """Inverse of :func:`records_from_telemetry` for a single run:
    stacks round records back into ``{field: (T, ...) ndarray}``."""
    rounds = sorted((r for r in records if r.get("kind") == "round"),
                    key=lambda r: r["t"])
    if not rounds:
        return {}
    fields = [k for k in rounds[0] if "/" in k]
    return {k: np.asarray([r[k] for r in rounds]) for k in fields}


def summarize(telemetry: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Compact per-field digest: last/mean/min/max over the time axis
    (vector fields summarize their final row).  Zero-width fields are
    omitted."""
    out: Dict[str, Dict[str, Any]] = {}
    for name in _live_fields(telemetry):
        arr = np.asarray(telemetry[name], dtype=np.float64)
        if arr.ndim == 1:
            out[name] = {"last": float(arr[-1]), "mean": float(arr.mean()),
                         "min": float(arr.min()), "max": float(arr.max())}
        else:
            last = arr[-1]
            out[name] = {"last": last.tolist(),
                         "mean": float(arr.mean())}
    return out


# ---------------------------------------------------------------------------
# JSONL I/O
# ---------------------------------------------------------------------------

def write_jsonl(path, records: Iterable[Dict[str, Any]]) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as fh:
        for rec in records:
            fh.write(json.dumps(rec) + "\n")


def read_jsonl(path) -> List[Dict[str, Any]]:
    with Path(path).open() as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _header(telemetry_fields: List[str],
            meta: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    return {"kind": "header", "env": env_stamp(),
            "meta": dict(meta or {}), "fields": telemetry_fields}


def write_run(path, telemetry: Dict[str, Any],
              meta: Optional[Dict[str, Any]] = None,
              ) -> Dict[str, Dict[str, Any]]:
    """Write one run's telemetry as JSONL (header + per-round records)
    and return its :func:`summarize` digest."""
    records = [_header(_live_fields(telemetry), meta)]
    records += records_from_telemetry(telemetry)
    write_jsonl(path, records)
    return summarize(telemetry)


def write_sweep(path, cells: Dict[str, Dict[str, Any]],
                meta: Optional[Dict[str, Any]] = None,
                ) -> Dict[str, Dict[str, Dict[str, Any]]]:
    """Write sweep telemetry as JSONL.

    ``cells`` maps a cell name (e.g. ``"pathological/hics"``) to a
    telemetry dict whose fields carry a leading *seed* axis:
    ``(S, T, ...)``.  Each (cell, seed) pair becomes a run of round
    records tagged ``{"cell": ..., "seed": ...}``.  Returns
    ``{cell: summary-of-seed-mean}``.
    """
    all_fields = sorted({f for tel in cells.values()
                         for f in _live_fields(tel)})
    records: List[Dict[str, Any]] = [_header(all_fields, meta)]
    summaries: Dict[str, Dict[str, Dict[str, Any]]] = {}
    for cell, tel in cells.items():
        live = _live_fields(tel)
        n_seeds = {np.asarray(tel[f]).shape[0] for f in live}
        if len(n_seeds) > 1:
            raise ValueError(f"inconsistent seed axes in cell {cell!r}: "
                             f"{n_seeds}")
        for s in range(next(iter(n_seeds), 0)):
            per_seed = {f: np.asarray(tel[f])[s] for f in live}
            records += records_from_telemetry(
                per_seed, extra={"cell": cell, "seed": s})
        seed_mean = {f: np.asarray(tel[f], dtype=np.float64).mean(axis=0)
                     for f in live}
        summaries[cell] = summarize(seed_mean)
    write_jsonl(path, records)
    return summaries
