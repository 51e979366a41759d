"""Schema-free reader for XLA profiler traces (xplane.pb).

``jax.profiler.start_trace`` writes an XSpace protobuf containing the
device's own execution timeline, with picosecond durations measured ON
the device — the basis for BASELINE.md's per-block p99 gate (host-observed
per-block times include the host link and the host loop). On the GPU the
device plane holds one XEvent per KERNEL, not per executable, so a step
is many events (PERF.md; see per_block_stats).

The program needs no tensorflow (the xplane proto's home), so the file is
decoded with a minimal protobuf wire-format walker against the stable
field numbers of tsl/profiler/protobuf/xplane.proto:

  XSpace:          planes = 1 (repeated XPlane)
  XPlane:          name = 2, lines = 3 (XLine), event_metadata = 4 (map)
  XLine:           name = 2, events = 4 (XEvent)
  XEvent:          metadata_id = 1, offset_ps = 2, duration_ps = 3
  XEventMetadata entry (map): key = 1, value = 2 (XEventMetadata)
  XEventMetadata:  id = 1, name = 2

Only varint and length-delimited wire types appear on the fields we
touch; everything else is skipped structurally.
"""

from __future__ import annotations

import glob
import os


def _walk(buf: bytes):
    """Yield (field_number, wire_type, value) over one message's fields.
    value is an int for varint/fixed and a memoryview for bytes fields."""
    view = memoryview(buf)
    i, n = 0, len(view)
    while i < n:
        tag = 0
        shift = 0
        while True:
            b = view[i]
            i += 1
            tag |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        field, wire = tag >> 3, tag & 7
        if wire == 0:                       # varint
            val = 0
            shift = 0
            while True:
                b = view[i]
                i += 1
                val |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            yield field, wire, val
        elif wire == 2:                     # length-delimited
            ln = 0
            shift = 0
            while True:
                b = view[i]
                i += 1
                ln |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            yield field, wire, view[i:i + ln]
            i += ln
        elif wire == 5:                     # fixed32
            yield field, wire, int.from_bytes(view[i:i + 4], "little")
            i += 4
        elif wire == 1:                     # fixed64
            yield field, wire, int.from_bytes(view[i:i + 8], "little")
            i += 8
        else:                               # groups: not emitted by xplane
            raise ValueError(f"unsupported wire type {wire}")


def _event_durations_ps(line_buf) -> list[tuple[int, int]]:
    """[(metadata_id, duration_ps)] for one XLine."""
    out = []
    for field, wire, val in _walk(line_buf):
        if field == 4 and wire == 2:        # XEvent
            mid = dur = 0
            for f2, w2, v2 in _walk(val):
                if f2 == 1 and w2 == 0:
                    mid = v2
                elif f2 == 3 and w2 == 0:
                    dur = v2
            out.append((mid, dur))
    return out


def plane_events(path: str):
    """Parse one .xplane.pb file.

    Returns {plane_name: {event_name: [duration_ps, ...]}} with event
    order preserved per line (XEvents are serialized in timeline order).
    """
    with open(path, "rb") as fh:
        space = fh.read()
    planes = {}
    for field, wire, plane_buf in _walk(space):
        if field != 1 or wire != 2:
            continue
        name = ""
        meta = {}
        lines = []
        for f2, w2, v2 in _walk(plane_buf):
            if f2 == 2 and w2 == 2:
                name = bytes(v2).decode(errors="replace")
            elif f2 == 3 and w2 == 2:
                lines.append(v2)
            elif f2 == 4 and w2 == 2:       # event_metadata map entry
                mid, mname = 0, ""
                for f3, w3, v3 in _walk(v2):
                    if f3 == 1 and w3 == 0:
                        mid = v3
                    elif f3 == 2 and w3 == 2:
                        for f4, w4, v4 in _walk(v3):   # XEventMetadata
                            if f4 == 1 and w4 == 0:
                                mid = v4
                            elif f4 == 2 and w4 == 2:
                                mname = bytes(v4).decode(errors="replace")
                meta[mid] = mname
        events = planes.setdefault(name, {})
        for line_buf in lines:
            for mid, dur in _event_durations_ps(line_buf):
                events.setdefault(meta.get(mid, f"#{mid}"), []).append(dur)
    return planes


def newest_trace(logdir: str) -> str | None:
    """The newest .xplane.pb under a jax.profiler trace dir."""
    paths = glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                      recursive=True)
    return max(paths, key=os.path.getmtime) if paths else None


def device_step_durations_ms(logdir: str, name_substr: str,
                             exclude=("thread", "host")):
    """Durations (ms) of every device-side execution of executables whose
    event name contains ``name_substr``, from the newest trace in
    ``logdir``. Host/python planes are excluded by plane-name substring;
    returns {} when nothing matches (caller decides the fallback)."""
    path = newest_trace(logdir)
    if path is None:
        return {}
    out = {}
    for plane, events in plane_events(path).items():
        lname = plane.lower()
        if any(x in lname for x in exclude):
            continue
        for ev_name, durs in events.items():
            if name_substr in ev_name:
                out.setdefault(ev_name, []).extend(
                    d / 1e9 for d in durs)    # ps -> ms
    return out


def per_block_stats(logdir: str, n_blocks: int):
    """Per-block latency distribution of the dominant once-per-block
    event in the newest ``jax.profiler.trace`` under ``logdir``.

    The heuristic (shared by bench.py's p99_block leg and the soak's
    per-segment on-device evidence): among all planes, keep events whose
    occurrence count matches ``n_blocks`` within 5% (once per step),
    prefer DEVICE planes over host ones (host planes only qualify via
    their 'Execute' span), and pick the event with the largest total
    duration — the step executable. Returns a dict with blocks/p50_ms/
    p99_ms/max_ms/event/plane/on_device, or a {'skipped': reason} dict
    when no trace, an unparseable trace, or no once-per-step event is
    found (callers decide whether that is an error)."""
    path = newest_trace(logdir)
    if path is None:
        return {"skipped": "profiler produced no trace on this backend"}
    try:
        planes = plane_events(path)
    except (ValueError, IndexError) as exc:
        return {"skipped": f"unparseable trace: {exc}"}
    candidates = []   # (on_device, total_ms, plane, event, durs_ms)
    for plane, events in planes.items():
        on_device = not any(s in plane.lower()
                            for s in ("host", "task environment",
                                      "metadata", "python", "thread"))
        for ev_name, durs in events.items():
            if abs(len(durs) - n_blocks) > max(2, n_blocks // 20):
                continue   # not once-per-step
            if not on_device and "Execute" not in ev_name:
                continue   # host plane: only the executor is a step
            ms = [d / 1e9 for d in durs]
            candidates.append((on_device, sum(ms), plane, ev_name, ms))
    if not candidates:
        return {"skipped": f"no once-per-step event in the trace "
                           f"(n={n_blocks})"}
    on_device, _tot, plane, ev_name, ms = max(
        candidates, key=lambda c: (c[0], c[1]))
    return dict(duration_stats_ms(ms),
                event=ev_name, plane=plane, on_device=on_device)


def duration_stats_ms(ms):
    """blocks/p50/p99/max summary of a per-block duration list (ms) —
    the one shape both bench's p99_block leg and the soak's per-segment
    device evidence report."""
    import numpy as np

    arr = np.asarray(ms)
    return {"blocks": int(arr.size),
            "p50_ms": round(float(np.percentile(arr, 50)), 3),
            "p99_ms": round(float(np.percentile(arr, 99)), 3),
            "max_ms": round(float(arr.max()), 3)}
