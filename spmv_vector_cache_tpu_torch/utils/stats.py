"""String-keyed stat registry with CSV emission.

Pattern carried over from the reference's tiny metrics system: every SpMV
implementation exports ``statKeys()`` (ordered key list) and ``statInt(key)``
(``software/SpMV.h:28-29``), and the benchmark app prints one CSV header row
plus one row per run (``software/main.cpp:49-66``).  Here a
:class:`StatRegistry` is a plain ordered mapping that kernels and strategies
populate with their counters (bytes moved, achieved GB/s, tile switches,
padding overhead, ...) — the roofline observatory's data plane.
"""

from __future__ import annotations

import io
from collections import OrderedDict
from typing import Dict, Iterable, List, Mapping, Optional, Union

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
