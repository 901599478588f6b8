"""Reading a torch.profiler session of the traced window.

The traced window is a run of calls after the measured one, under
``torch.profiler`` with CPU and CUDA activity.  The profiler can lose the
first activities of a session (``chip_smoke.py``'s ``device_ms`` found so),
so the session opens with short spin kernels and one call that is not
read.  The window is the host span from the first traced call's start to
the last one's end; device activities are the CUDA events that are not
the device-side ranges of ``record_function``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch

Interval = Tuple[str, float, float]   # (name, start us, end us)


@dataclasses.dataclass
class Trace:
    window: Tuple[float, float]           # us
    device: List[Interval]                # device activities in the window
    host: List[Interval]                  # record_function ranges (host)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device activities' intervals, clipped to the
        window, in time order."""
        a, b = self.window
        spans = sorted((max(s, a), min(e, b)) for _, s, e in self.device
                       if e > a and s < b)
        out: List[List[float]] = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e6

    def device_seconds(self, match: Sequence[str]) -> Tuple[float, int]:
        """(seconds, activities) of the device activities whose name holds
        one of ``match``."""
        hits = [e - s for n, s, e in self.device
                if any(m in n for m in match)]
        return sum(hits) / 1e6, len(hits)

    def host_seconds(self, name: str) -> float:
        """Summed host seconds inside the ranges called ``name``."""
        return sum(e - s for n, s, e in self.host if n == name) / 1e6

    def top_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for n, s, e in self.device:
            key = short_name(n)
            by[key] = by.get(key, 0.0) + (e - s) / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The device's idle time in the window, summed by the innermost
        host range that holds each gap's middle ("outside" where none)."""
        a, b = self.window
        edges = [a] + [t for iv in self.busy() for t in iv] + [b]
        by: Dict[str, float] = {}
        ranges = sorted(self.host, key=lambda r: r[1])
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            mid = 0.5 * (s + e)
            name = "outside"
            for n, rs, re_ in ranges:
                if rs > mid:
                    break
                if re_ >= mid:
                    name = n
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda x: -x[1])[:k]]


def short_name(name: str) -> str:
    """A kernel's name without its template and argument lists."""
    n = name.split("(")[0].replace("void ", "").strip()
    return n.split("<")[0][:120] if n else name[:120]


def read(prof, window_name: str, call_name: str) -> Trace:
    """The Trace of a finished profiler session whose traced calls ran
    inside ``record_function(window_name)``, each in ``call_name``."""
    host, device = [], []
    for e in prof.events():
        t = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation:
                device.append(t)
        elif e.is_user_annotation:
            host.append(t)
    calls = [h for h in host if h[0] == call_name]
    if not calls:
        raise RuntimeError("the traced window holds no call")
    window = (min(c[1] for c in calls), max(c[2] for c in calls))
    device = [d for d in device if d[2] > window[0] and d[1] < window[1]]
    host = [h for h in host if h[0] != window_name]
    return Trace(window=window, device=device, host=host)
