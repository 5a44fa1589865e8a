"""Trace export: Chrome-trace/Perfetto JSON and a JSONL event log.

Both formats are plain files a human can open — ``chrome://tracing``
or https://ui.perfetto.dev for the JSON, ``jq`` for the JSONL — and
both are **deterministic**: records sort by ``(t0, sid)``, dict keys
are sorted, and no wall-clock or randomness enters the rendering, so
a chaos run replayed under the same :class:`~repro_torch.serve.faults.
VirtualClock` seed exports byte-identical files, and the same files as
the reference's for the same run (tests pin both).

The port's copy of ``repro/obs/export.py``.

Chrome-trace mapping (the subset Perfetto loads):

  * finished spans -> phase ``"X"`` complete events with ``ts``/
    ``dur`` in microseconds;
  * instant events -> phase ``"i"``, thread scope;
  * span attributes ride in ``args``; threads map to ``tid`` tracks.
"""

from __future__ import annotations

import json
from pathlib import Path

from .tracer import KIND_INSTANT, Span, Tracer

#: single synthetic process id for the whole trace
_PID = 1


def _tid_index(records) -> dict[str, int]:
    """Stable thread-name -> integer tid mapping (Chrome trace wants
    numeric tids; sort for determinism, main thread first)."""
    names = sorted({s.tid for s in records})
    names.sort(key=lambda n: (n != "MainThread", n))
    return {name: i + 1 for i, name in enumerate(names)}


def _jsonable(attrs: dict) -> dict:
    """Attributes coerced to JSON-safe values (repr fallback)."""
    out = {}
    for k in sorted(attrs):
        v = attrs[k]
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        else:
            out[k] = repr(v)
    return out


def chrome_trace(tracer: Tracer, metrics=None) -> dict:
    """The tracer's records as a Chrome-trace dict (Perfetto-loadable).

    Open spans are exported with ``dur=0`` and an ``unfinished`` arg
    rather than dropped — a crashed request should still be visible.
    A metrics registry's snapshot, if given, rides in ``otherData``.
    """
    records = sorted(tracer.records, key=lambda s: (s.t0, s.sid))
    tids = _tid_index(records)
    events = []
    for s in records:
        args = _jsonable(s.attrs)
        base = {
            "name": s.name,
            "pid": _PID,
            "tid": tids[s.tid],
            "ts": round(s.t0 * 1e6, 3),
            "args": args,
        }
        if s.kind == KIND_INSTANT:
            base["ph"] = "i"
            base["s"] = "t"
        else:
            base["ph"] = "X"
            if s.t1 is None:
                base["dur"] = 0.0
                args["unfinished"] = True
            else:
                base["dur"] = round((s.t1 - s.t0) * 1e6, 3)
        events.append(base)
    # thread-name metadata rows so Perfetto labels the tracks
    for name, tid in sorted(tids.items(), key=lambda kv: kv[1]):
        events.append({"name": "thread_name", "ph": "M", "pid": _PID,
                       "tid": tid, "args": {"name": name}})
    out = {"traceEvents": events, "displayTimeUnit": "ms"}
    other = {"dropped_records": tracer.dropped}
    if metrics is not None:
        other["metrics"] = metrics.snapshot()
    out["otherData"] = other
    return out


def events_jsonl(tracer: Tracer) -> str:
    """One JSON object per record (begin order), ``jq``-friendly."""
    lines = []
    for s in sorted(tracer.records, key=lambda r: (r.t0, r.sid)):
        lines.append(json.dumps({
            "sid": s.sid,
            "parent": s.parent,
            "name": s.name,
            "kind": s.kind,
            "t0": s.t0,
            "t1": s.t1,
            "tid": s.tid,
            "attrs": _jsonable(s.attrs),
        }, sort_keys=True))
    return "\n".join(lines) + ("\n" if lines else "")


def write_trace(path, tracer: Tracer, metrics=None) -> Path:
    """Write the Perfetto JSON to ``path`` and the JSONL event log
    next to it (``<path>.jsonl``); returns the JSON path."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(chrome_trace(tracer, metrics),
                               sort_keys=True, indent=1) + "\n")
    Path(str(path) + ".jsonl").write_text(events_jsonl(tracer))
    return path
