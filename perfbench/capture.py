"""The benchmark's own device trace: a ``torch.profiler`` capture of a steady part of the
window, reduced to busy time, kernel time by name and idle gaps named by what the host
was doing.

The device's operations are read from the capture's Chrome trace, which holds every
operation on the device whichever thread launched it.  Its clock is tied to the host's
wall clock by one marker range opened at a known ``time.time_ns()``.  Host activity comes
from spans with wall-clock starts: the program's ``RECORDER`` spans and the benchmark's
own spans around each call.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

_MARK = "perfbench.mark"
TOP = 10
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _device_events(prof) -> Tuple[List[Tuple[str, int, int]], Optional[int]]:
    """([(name, start ns, end ns)] of every operation on the device, marker start ns),
    from the capture's Chrome trace (written to a temporary file and removed)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    out, mark = [], None
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        start = int(round(float(ev["ts"]) * 1000))
        if ev.get("name") == _MARK and mark is None:
            mark = start
        elif ev.get("cat") in DEVICE_CATS:
            out.append((ev["name"], start, start + int(round(float(ev.get("dur", 0)) * 1000))))
    return out, mark


def prime(device) -> None:
    """A first, short capture around work of this thread: the first capture of a process
    reports no device operation when other threads launch all of the work it spans."""
    with torch.profiler.profile(activities=_activities()):
        torch.ones(8, device=device).add_(1)
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class Capture:
    """Start and stop a capture; ``reduce`` turns it into the numbers metrics read."""

    def __init__(self):
        self._prof = None
        self.t0_ns = self.t1_ns = self.mark_wall_ns = 0

    def start(self) -> None:
        self._prof = torch.profiler.profile(activities=_activities())
        self._prof.__enter__()
        self.mark_wall_ns = time.time_ns()
        with torch.profiler.record_function(_MARK):
            pass
        self.t0_ns = time.time_ns()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self._prof.__exit__(None, None, None)

    def reduce(self, host_spans: Sequence[Tuple[str, int, int]]) -> Dict:
        """``host_spans``: (name, wall start ns, wall end ns) of host activity.  Returns
        window_s, busy_s, kernels {name: [seconds, launches]}, and the breakdown's
        device_ops and idle_gaps (at most ``TOP`` each, the longest first)."""
        events, mark = _device_events(self._prof)
        shift = (mark - self.mark_wall_ns) if mark is not None else 0
        lo, hi = self.t0_ns + shift, self.t1_ns + shift
        kernels: Dict[str, List[float]] = {}
        spans = []
        for name, s, e in events:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            k = kernels.setdefault(name, [0.0, 0])
            k[0] += (e - s) * 1e-9
            k[1] += 1
            spans.append((s, e))
        spans.sort()
        busy, gaps, cur = 0, [], lo
        for s, e in spans:
            if s > cur:
                gaps.append((cur, s))
            if e > cur:
                busy += e - max(s, cur)
                cur = e
        if hi > cur:
            gaps.append((cur, hi))
        host = sorted((s + shift, e + shift, n) for n, s, e in host_spans)
        starts = [h[0] for h in host]
        longest = max((e - s for s, e, _ in host), default=0)
        idle: Dict[str, float] = {}
        for s, e in gaps:
            t = (s + e) // 2
            a, b = bisect.bisect_left(starts, t - longest), bisect.bisect_right(starts, t)
            name = _activity(host[a:b], t)
            idle[name] = idle.get(name, 0.0) + (e - s) * 1e-9
        ops = sorted(([n, v[0]] for n, v in kernels.items()), key=lambda x: -x[1])
        starts = sorted(s for _, s, _ in events)
        return {
            "events": {"device": len(events), "mark": mark is not None,
                       "first_s": (starts[0] - lo) * 1e-9 if starts else None,
                       "last_s": (starts[-1] - lo) * 1e-9 if starts else None},
            "window_s": (hi - lo) * 1e-9,
            "busy_s": busy * 1e-9,
            "kernels": kernels,
            "device_ops": ops[:TOP],
            "idle_gaps": sorted(([n, v] for n, v in idle.items()), key=lambda x: -x[1])[:TOP],
        }


def _activity(host: Sequence[Tuple[int, int, str]], t: int) -> str:
    """What the host was doing at ``t``: the program's spans open then (joined), else
    ``engine.other`` inside a call, else ``client``."""
    names = {n for s, e, n in host if s <= t < e}
    inner = sorted(n for n in names if n != "client.call")
    if inner:
        return "+".join(inner)
    return "engine.other" if "client.call" in names else "client"
