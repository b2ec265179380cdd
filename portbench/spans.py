"""Spans around the calls into the port, and the reduction of a profiler
trace to device busy time, idle gaps and device time by span.

The harness opens a span (``torch.profiler.record_function``) around
each call it makes into the port: ``portbench.apply``,
``portbench.solve``, ``portbench.matvec``.  A device operation belongs
to the span that was open on the host when the operation was launched:
the profiler gives each device operation the correlation id of the host
runtime call that launched it, and that call's start falls inside the
span.  Nothing is written to disk; the trace is reduced in memory.  The
profiler's own host cost lengthens a traced stretch where the host paces
the card, so idle shares of a traced stretch read above the untraced
window's.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

SPAN_PREFIX = "portbench."
#: prefix of the host runtime calls that launch device work
#: (cudaLaunchKernel, cudaMemcpyAsync..., cuLaunchKernel)
_RUNTIME = "cu"


def span(name: str, on: bool):
    """A profiler span around one call into the port, or nothing when the
    run is not traced (so the untraced window pays nothing for it)."""
    if on:
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return contextlib.nullcontext()


@dataclasses.dataclass
class TraceSummary:
    window_s: float                 # host clock over the traced stretch
    busy_s: float                   # union of device operations
    device_s_by_span: Dict[str, float]   # device seconds launched in each
    spans: Dict[str, int]                # spans of each name
    device_ops: List[Tuple[str, float]]  # top device operations by time
    idle_gaps: List[Tuple[str, float]]   # idle seconds by host activity

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def _is_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def _is_span(e) -> bool:
    return e.name.startswith(SPAN_PREFIX)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class _Spans:
    """Host intervals of the harness's spans, by name, for lookups."""

    def __init__(self, events):
        by: Dict[str, List[Tuple[float, float]]] = collections.defaultdict(list)
        for e in events:
            if _is_span(e) and not _is_device(e):
                by[e.name[len(SPAN_PREFIX):]].append(
                    (e.time_range.start, e.time_range.end))
        self.by = {k: sorted(v) for k, v in by.items()}
        self.starts = {k: [s for s, _ in v] for k, v in self.by.items()}

    def holding(self, name: str, t: float) -> bool:
        i = bisect.bisect_right(self.starts.get(name, []), t) - 1
        return i >= 0 and self.by[name][i][1] >= t


def reduce_events(events, window_s: float, top: int = 10) -> TraceSummary:
    """Reduce ``prof.events()`` of one traced stretch."""
    device = [e for e in events if _is_device(e) and not _is_span(e)
              and not getattr(e, "is_user_annotation", False)]
    host = [e for e in events if not _is_device(e)]
    spans = _Spans(host)
    busy = _union([(e.time_range.start, e.time_range.end) for e in device])
    busy_s = sum(e - s for s, e in busy) * 1e-6

    by_name: Dict[str, float] = collections.Counter()
    for e in device:
        by_name[e.name] += (e.time_range.end - e.time_range.start) * 1e-6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    # device time by the span that was open when each operation was
    # launched: a device event shares its correlation id with the host
    # runtime call (cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync...)
    # that launched it
    launched_at = {e.id: e.time_range.start for e in host
                   if e.name.startswith(_RUNTIME) and not _is_span(e)}
    names = sorted(spans.by)
    dev_by_span: Dict[str, float] = collections.Counter()
    for e in device:
        t = launched_at.get(e.id)
        if t is None:
            continue
        sec = (e.time_range.end - e.time_range.start) * 1e-6
        for n in names:
            if spans.holding(n, t):
                dev_by_span[n] += sec

    # idle gaps between device operations, by what the host was running
    gaps: Dict[str, float] = collections.Counter()
    plain = sorted((e for e in host if not _is_span(e)),
                   key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in plain]
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        mid = 0.5 * (end + nxt)
        label = _host_at(plain, starts, mid)
        outer = [n for n in names if spans.holding(n, mid)]
        key = "/".join(outer + [label]) if outer else label
        gaps[key] += (nxt - end) * 1e-6
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return TraceSummary(window_s=window_s, busy_s=busy_s,
                        device_s_by_span=dict(dev_by_span),
                        spans={k: len(v) for k, v in spans.by.items()},
                        device_ops=device_ops, idle_gaps=idle)


def _host_at(plain, starts, t: float) -> str:
    """The innermost host event running at time ``t`` (the latest started
    one that has not ended), else ``host between ops``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 64, -1), -1):
        if plain[j].time_range.end >= t:
            return plain[j].name
    return "host between ops"


class Traced:
    """The profiler over one stretch of work, reduced when it closes.

    ``with Traced() as tr: ...`` synchronises the card before and after,
    and leaves ``tr.summary``."""

    def __init__(self):
        self.summary: Optional[TraceSummary] = None

    def __enter__(self):
        torch.cuda.synchronize()
        act = torch.profiler.ProfilerActivity
        self._prof = torch.profiler.profile(activities=[act.CPU, act.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = reduce_events(self._prof.events(), window_s)
        return False
