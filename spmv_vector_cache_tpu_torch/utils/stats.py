"""String-keyed stat registry with CSV emission.

Pattern carried over from the reference's tiny metrics system: every SpMV
implementation exports ``statKeys()`` (ordered key list) and ``statInt(key)``
(``software/SpMV.h:28-29``), and the benchmark app prints one CSV header row
plus one row per run (``software/main.cpp:49-66``).  Here a
:class:`StatRegistry` is a plain ordered mapping that kernels and strategies
populate with their counters (bytes moved, achieved GB/s, tile switches,
padding overhead, ...) — the roofline observatory's data plane.

Beside it, the port's spans and counters (:func:`span`, :data:`counters`):
a span times one stage of the port (planning, an apply, a launch, a
solve) and, while a torch profiler records, opens a
``torch.profiler.record_function`` of the same name, so that the stage
appears in the profiler's trace on the clock of the device operations it
launched; :data:`span_totals` keeps each name's count, host seconds and
self seconds.  With no profiler recording, a span costs one flag read.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import io
import threading
import time
from collections import OrderedDict
from typing import Dict, Iterable, List, Mapping, Optional, Union

import torch

Number = Union[int, float]


class StatRegistry:
    """Ordered name -> number mapping mirroring statKeys/statInt."""

    def __init__(self, initial: Optional[Mapping[str, Number]] = None):
        self._stats: "OrderedDict[str, Number]" = OrderedDict()
        if initial:
            for k, v in initial.items():
                self[k] = v

    # -- mapping surface --------------------------------------------------
    def __setitem__(self, key: str, value: Number) -> None:
        self._stats[key] = value

    def __getitem__(self, key: str) -> Number:
        return self._stats[key]

    def __contains__(self, key: str) -> bool:
        return key in self._stats

    def get(self, key: str, default: Optional[Number] = None):
        return self._stats.get(key, default)

    def update(self, other: Mapping[str, Number]) -> None:
        for k, v in other.items():
            self[k] = v

    def add(self, key: str, delta: Number) -> None:
        self._stats[key] = self._stats.get(key, 0) + delta

    def keys(self) -> List[str]:
        """The reference's ``statKeys()`` (``SpMV.h:28``)."""
        return list(self._stats.keys())

    def stat(self, key: str) -> Number:
        """The reference's ``statInt(name)`` (``SpMV.h:29``)."""
        return self._stats[key]

    def as_dict(self) -> Dict[str, Number]:
        return dict(self._stats)

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={v}" for k, v in self._stats.items())
        return f"StatRegistry({inner})"


def csv_header(registries: Iterable[StatRegistry],
               extra_keys: Iterable[str] = ()) -> str:
    """Union of keys in first-seen order (``main.cpp:49-55`` printKeys role)."""
    keys: "OrderedDict[str, None]" = OrderedDict((k, None) for k in extra_keys)
    for reg in registries:
        for k in reg.keys():
            keys.setdefault(k, None)
    return ",".join(keys.keys())


def csv_rows(registries: Iterable[StatRegistry],
             extra: Optional[List[Mapping[str, Number]]] = None) -> str:
    """CSV emission for a sweep (``main.cpp:56-66`` printResults role)."""
    regs = list(registries)
    extras = extra or [{} for _ in regs]
    header = csv_header(regs, extra_keys=[k for e in extras for k in e])
    keys = header.split(",") if header else []
    buf = io.StringIO()
    buf.write(header + "\n")
    for reg, ext in zip(regs, extras):
        merged = {**ext, **reg.as_dict()}
        buf.write(",".join(str(merged.get(k, "")) for k in keys) + "\n")
    return buf.getvalue()


# -- spans and counters ------------------------------------------------------

#: process-wide event counts by name (``cg.solves``, ``cg.host_syncs``,
#: ...): plain integer increments, always on
counters: collections.Counter = collections.Counter()


@dataclasses.dataclass
class SpanTotals:
    """What the spans of one name recorded while a profiler recorded."""
    count: int = 0
    seconds: float = 0.0          # host seconds, child spans included
    self_seconds: float = 0.0     # less the child spans, ranges and all
    #: spans of each name that enclosed one of these ("" for none)
    parents: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)


#: span name -> its totals; filled only while a torch profiler records
span_totals: Dict[str, SpanTotals] = {}

#: the spans' host clock and the profiler's range (a test may substitute
#: fakes for either)
clock = time.perf_counter
_range = torch.profiler.record_function

_NULL = contextlib.nullcontext()
_open = threading.local()          # .stack: this thread's open spans
#: its ``_is_profiler_enabled`` is True while a torch profiler records:
#: a module attribute, cheaper to read than the C state (a span that no
#: profiler records costs only this read)
_profiler = torch.autograd.profiler


class _Span:
    """One span: times its body on the host clock into ``into`` (always,
    where given) and, while a profiler records, into :data:`span_totals`
    and the trace.  Its seconds are its body's; its parent's self time
    leaves out the span whole, its profiler range and bookkeeping
    included, so that no span's self time holds the tracing's cost."""

    __slots__ = ("name", "into", "traced", "child_s", "t0", "t_in", "rf")

    def __init__(self, name: str, into: Optional[dict]):
        self.name, self.into = name, into

    def __enter__(self):
        self.traced = _profiler._is_profiler_enabled
        if self.traced:
            self.t_in = clock()
            self.rf = _range(self.name)
            self.rf.__enter__()
            self.child_s = 0.0
            stack = getattr(_open, "stack", None)
            if stack is None:
                stack = _open.stack = []
            stack.append(self)
        self.t0 = clock()
        return self

    def __exit__(self, *exc):
        dt = clock() - self.t0
        if self.into is not None:
            self.into[self.name] = self.into.get(self.name, 0.0) + dt
        if self.traced:
            stack = _open.stack
            stack.pop()
            parent = stack[-1] if stack else None
            row = span_totals.setdefault(self.name, SpanTotals())
            row.count += 1
            row.seconds += dt
            row.self_seconds += dt - self.child_s
            row.parents[parent.name if parent is not None else ""] += 1
            self.rf.__exit__(*exc)
            if parent is not None:
                parent.child_s += clock() - self.t_in
        return False


def span(name: str, into: Optional[dict] = None):
    """A context manager around one stage of the port, named
    ``spmv.<...>``.  While a torch profiler records it is a
    ``record_function`` of ``name`` and adds to ``span_totals[name]``;
    given ``into`` (a dict) it also adds its host seconds to
    ``into[name]``, profiler or not.  Otherwise it does nothing."""
    if into is None and not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, into)


def spanned(name: str):
    """The decorator form of :func:`span`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name, None):
                return fn(*args, **kwargs)
        return inner
    return wrap


def device_us_by_kernel(fn, iters: int = 20) -> dict:
    """(device microseconds, launches) per call of ``fn``, by kernel
    name, from a torch profiler trace of ``iters`` calls after one
    untraced call (empty if the profiler saw no device activity).  A
    span's range on the device (``is_user_annotation``) is not device
    work and is left out.  The time is per recorded launch times the
    launches a call makes: a profiler trace that follows another in the
    process may leave the first launch unrecorded (19 of 20), which
    would otherwise read as a 5 % shorter kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue                   # host ops: their kernels count below
        if getattr(ev, "is_user_annotation", False):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0:
            per_call = round(ev.count / iters) or ev.count / iters
            out[ev.key] = (us / ev.count * per_call, per_call)
    return out
