"""Chrome trace-event JSON export + the span-pairing validator — the
port of ``repro.obs.chrome``: the same events in, the same JSON text out.

The trace-event format is the lingua franca of timeline viewers:
Perfetto and ``chrome://tracing`` load it directly.
:func:`export_chrome` maps the tracer's model onto it:

  * each *track* becomes a Chrome **process** (``pid``), named via a
    ``process_name`` metadata event — one per node / pool / engine;
  * each *tid* becomes a **thread** within it — one per task, so each
    task's lifecycle renders as its own row;
  * spans emit matched ``B``/``E`` duration events.  Within one
    ``(pid, tid)`` row the exporter *orders* the B/E stream itself
    (children open after parents, close before them — ties broken by
    span length), so properly-nested input always produces a
    well-formed stream; partially-overlapping spans on one row are
    rejected rather than silently emitting an unbalanced trace;
  * instants emit ``i`` events (thread scope).

Timestamps are seconds on the caller's clock (virtual or wall) and are
exported in microseconds, the format's unit.

:func:`validate_chrome` is the matching checker — every ``B`` has a
matching ``E``, stacks close LIFO with children inside parents,
timestamps are monotone per track — used by the tests, the benchmark
smoke gate, and anyone handed a ``trace.json`` of unknown provenance.
"""
from __future__ import annotations

import json
import os
from typing import Optional

__all__ = ["export_chrome", "validate_chrome"]

#: scale: tracer seconds -> trace-event microseconds
_US = 1e6


def _trace_events(tracer) -> list[dict]:
    """The ordered traceEvents list for one tracer's contents."""
    pids: dict[str, int] = {}
    events: list[dict] = []

    def pid_of(track: str) -> int:
        pid = pids.get(track)
        if pid is None:
            pid = len(pids)
            pids[track] = pid
            events.append({"name": "process_name", "ph": "M", "pid": pid,
                           "tid": 0, "args": {"name": track}})
        return pid

    # group spans per (track, tid) row and emit each row's B/E stream in
    # stack order: sort by (start, -duration) so parents open before
    # their children, close everything that ends at or before the next
    # span's start, then drain the stack LIFO
    rows: dict[tuple, list] = {}
    for sp in tracer.all_spans():
        rows.setdefault((sp.track, sp.tid), []).append(sp)
    for (track, tid), spans in rows.items():
        pid = pid_of(track)
        stack: list = []

        def close_until(t: Optional[float]) -> None:
            while stack and (t is None or stack[-1].t1 <= t):
                top = stack.pop()
                events.append({"name": top.name, "ph": "E", "pid": pid,
                               "tid": tid, "ts": top.t1 * _US})

        for sp in sorted(spans, key=lambda s: (s.t0, s.t0 - s.t1)):
            close_until(sp.t0)
            if stack and stack[-1].t1 < sp.t1:
                raise ValueError(
                    f"spans on track {track!r} tid {tid} partially "
                    f"overlap: {stack[-1].name!r} [{stack[-1].t0}, "
                    f"{stack[-1].t1}] vs {sp.name!r} [{sp.t0}, {sp.t1}]")
            ev = {"name": sp.name, "ph": "B", "pid": pid, "tid": tid,
                  "ts": sp.t0 * _US}
            if sp.args:
                ev["args"] = dict(sp.args)
            events.append(ev)
            stack.append(sp)
        close_until(None)

    for inst in tracer.all_instants():
        ev = {"name": inst.name, "ph": "i", "pid": pid_of(inst.track),
              "tid": inst.tid, "ts": inst.ts * _US, "s": "t"}
        if inst.args:
            ev["args"] = dict(inst.args)
        events.append(ev)
    # final ordering: metadata first, then a *stable* global sort by
    # timestamp.  Each row's B/E stream is already monotone in ts, so
    # the stable sort preserves its internal order while interleaving
    # instants (whose ingestion order need not be time order — the
    # fleet engine batches them per phase) and other rows time-sorted.
    meta = [e for e in events if e["ph"] == "M"]
    rest = sorted((e for e in events if e["ph"] != "M"),
                  key=lambda e: e["ts"])
    return meta + rest


def export_chrome(tracer, path: Optional[str]) -> dict:
    """Export ``tracer`` as a Chrome trace object; write it to ``path``
    as JSON when given.  Returns the trace dict (callers can validate
    or post-process without re-reading the file)."""
    trace = {"traceEvents": _trace_events(tracer),
             "displayTimeUnit": "ms"}
    if path is not None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(trace, f, indent=1, default=float)
    return trace


def validate_chrome(trace) -> dict:
    """Span-pairing checker for a Chrome trace (dict, traceEvents list,
    or a path to a ``trace.json``).

    Verifies, per ``(pid, tid)`` track, in file order:

      * every ``B`` has a matching ``E`` (same name, LIFO) and no ``E``
        arrives on an empty stack;
      * children nest inside parents (an enclosing span never ends
        before one it contains — guaranteed by LIFO closing with
        monotone timestamps, checked explicitly anyway);
      * ``B``/``E`` timestamps are monotone non-decreasing per track;
      * all ``B`` stacks are closed at end of trace.

    Returns ``{"n_events", "n_spans", "n_instants", "n_tracks"}``;
    raises :class:`ValueError` on the first violation.
    """
    if isinstance(trace, str):
        with open(trace) as f:
            trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    stacks: dict[tuple, list] = {}
    last_ts: dict[tuple, float] = {}
    n_spans = n_instants = 0
    for k, ev in enumerate(events):
        ph = ev.get("ph")
        if ph == "M":
            continue
        key = (ev.get("pid", 0), ev.get("tid", 0))
        ts = float(ev["ts"])
        if ph in ("B", "E", "i"):
            prev = last_ts.get(key)
            if prev is not None and ts < prev:
                raise ValueError(
                    f"event {k} ({ev.get('name')!r}): timestamp {ts} "
                    f"goes backwards on track {key} (prev {prev})")
            last_ts[key] = ts
        if ph == "B":
            stack = stacks.setdefault(key, [])
            stack.append((ev.get("name"), ts))
            n_spans += 1
        elif ph == "E":
            stack = stacks.get(key)
            if not stack:
                raise ValueError(
                    f"event {k}: 'E' {ev.get('name')!r} on track {key} "
                    f"with no open 'B'")
            name, t0 = stack.pop()
            if name != ev.get("name"):
                raise ValueError(
                    f"event {k}: 'E' {ev.get('name')!r} does not match "
                    f"open 'B' {name!r} on track {key} (spans must "
                    f"close LIFO)")
            if ts < t0:
                raise ValueError(
                    f"event {k}: span {name!r} on track {key} ends at "
                    f"{ts} before it begins at {t0}")
        elif ph == "i":
            n_instants += 1
        else:
            raise ValueError(f"event {k}: unknown phase {ph!r}")
    for key, stack in stacks.items():
        if stack:
            raise ValueError(
                f"track {key}: {len(stack)} unmatched 'B' events at end "
                f"of trace (first: {stack[0][0]!r})")
    return {"n_events": len(events), "n_spans": n_spans,
            "n_instants": n_instants, "n_tracks": len(last_ts)}
