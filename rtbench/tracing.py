"""The benchmark's reading of a device trace: intervals from torch.profiler,
device-busy time as their union, idle gaps labelled by the harness's own
span open on the host, and the device operations that took most time.

The harness opens its own profiler (CPU and CUDA activities) around the
measured window and its own `record_function` spans around each call into
the program (SPANS); nothing here reads a span of the program.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

# The harness's spans around the calls into each layer, and the one
# around the whole window.
SPANS = ("init", "solve", "backward", "result", "readback")
WINDOW_SPAN = "window"

Interval = Tuple[str, float, float]      # (name, start_us, end_us)


def from_profiler(prof) -> Tuple[List[Interval], List[Interval]]:
    """(device intervals, host spans) of a finished torch.profiler run:
    every kernel, copy and set on the device, and the harness's spans. The
    profiler also draws each span on the device's timeline (from its first
    to its last operation there); those are not work and are left out."""
    device, host = [], []
    ours = set(SPANS) | {WINDOW_SPAN}
    for ev in prof.events():
        start, end = ev.time_range.start, ev.time_range.end
        if str(ev.device_type).endswith("CUDA"):
            if ev.name not in ours:
                device.append((ev.name, float(start), float(end)))
        elif ev.name in ours:
            host.append((ev.name, float(start), float(end)))
    return device, host


def window_of(host: Iterable[Interval]) -> Optional[Tuple[float, float]]:
    """The traced window's (start_us, end_us): its span's."""
    for name, s, e in host:
        if name == WINDOW_SPAN:
            return s, e
    return None


def union(intervals: Iterable[Tuple[float, float]],
          lo: float, hi: float) -> List[Tuple[float, float]]:
    """The union of `intervals` clipped to [lo, hi], as sorted disjoint
    intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_seconds(device: List[Interval], lo: float, hi: float) -> float:
    """Seconds in [lo, hi] in which some operation ran on the device."""
    return sum(e - s for s, e in union(((s, e) for _, s, e in device),
                                       lo, hi)) * 1e-6


def idle_gaps(device: List[Interval], lo: float, hi: float
              ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] in which nothing ran on the device."""
    gaps, t = [], lo
    for s, e in union(((s, e) for _, s, e in device), lo, hi):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < hi:
        gaps.append((t, hi))
    return gaps


def span_at(host: List[Interval], t: float) -> str:
    """The innermost harness span open on the host at time `t` (the one
    that started last), or "loop" between them."""
    best, start = "loop", None
    for name, s, e in host:
        if name in SPANS and s <= t <= e and (start is None or s > start):
            best, start = name, s
    return best


def idle_by_span(device: List[Interval], host: List[Interval], lo: float,
                 hi: float, top: int = 10) -> List[List]:
    """Idle seconds of the window summed by the span the host was in at
    each gap's middle, longest first."""
    acc: Dict[str, float] = {}
    for s, e in idle_gaps(device, lo, hi):
        label = span_at(host, 0.5 * (s + e))
        acc[label] = acc.get(label, 0.0) + (e - s) * 1e-6
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])
            ][:top]


def short_name(name: str) -> str:
    """A kernel's name without its parameter list (the last balanced
    parenthesis group of a C++ signature); other names as they are."""
    if "::" not in name or not name.endswith(")"):
        return name
    depth = 0
    for k in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[k], 0)
        if depth == 0:
            return name[:k].strip() or name
    return name


def top_ops(device: List[Interval], lo: float, hi: float,
            top: int = 10) -> List[List]:
    """Device seconds in [lo, hi] summed by operation name, largest
    first."""
    acc: Dict[str, float] = {}
    for name, s, e in device:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            key = short_name(name)
            acc[key] = acc.get(key, 0.0) + (e - s) * 1e-6
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])
            ][:top]


def seconds_matching(device: List[Interval], lo: float, hi: float,
                     needle: str) -> float:
    """Device seconds in [lo, hi] of operations whose name holds `needle`
    (any case)."""
    needle = needle.lower()
    return sum(min(e, hi) - max(s, lo) for name, s, e in device
               if needle in name.lower() and min(e, hi) > max(s, lo)) * 1e-6


def summarize(device: List[Interval], host: List[Interval]) -> dict:
    """What the metric readers and the result line take from one rank's
    trace."""
    win = window_of(host)
    if win is None:
        raise RuntimeError("the trace holds no window span")
    lo, hi = win
    return {"busy_s": busy_seconds(device, lo, hi),
            "window_s": (hi - lo) * 1e-6,
            "nccl_s": seconds_matching(device, lo, hi, "nccl"),
            "device_ops": top_ops(device, lo, hi),
            "idle_gaps": idle_by_span(device, host, lo, hi)}
