"""Reduction of a ``torch.profiler`` trace of the window.

Device busy time is the union of the intervals in which any device
operation (kernel, copy, set) ran.  Each gap between them is put down to
what the host was doing when it opened: the innermost host operation open
at that instant (the open one that started last), or
``host:no_operation_open``.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
from typing import Dict, List, Tuple

_TOP = 10
_NAME = 120


@dataclasses.dataclass
class Trace:
    busy_s: float
    window_s: float
    device_ops: List[Tuple[str, float]]     # seconds by name, the largest first
    idle_gaps: List[Tuple[str, float]]      # idle seconds by host operation
    kernel_s: Dict[str, float]              # every device operation's seconds by name

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def seconds_of(self, fragment: str) -> float:
        return sum(s for name, s in self.kernel_s.items() if fragment in name)


def _span(ev):
    start = ev.start_ns()
    return start, start + ev.duration_ns()


def summarize(prof, window_s: float) -> Trace:
    from torch.autograd import DeviceType

    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        kind = ev.device_type()
        if kind == DeviceType.CUDA:
            device.append(_span(ev) + (ev.name(),))
        elif kind == DeviceType.CPU:
            host.append(_span(ev) + (ev.name(),))
    by_name = collections.Counter()
    for start, end, name in device:
        by_name[name] += (end - start) * 1e-9
    device.sort()
    merged = []
    for start, end, _ in device:
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    busy = sum(end - start for start, end in merged) * 1e-9
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    host.sort()
    idle = collections.Counter()
    heap: list = []
    k = 0
    for opened, closed in gaps:
        while k < len(host) and host[k][0] <= opened:
            heapq.heappush(heap, (-host[k][0], host[k][1], host[k][2]))
            k += 1
        while heap and heap[0][1] < opened:
            heapq.heappop(heap)
        name = heap[0][2] if heap else "host:no_operation_open"
        idle[name] += (closed - opened) * 1e-9
    return Trace(busy_s=busy, window_s=window_s,
                 device_ops=[(n[:_NAME], s) for n, s in by_name.most_common(_TOP)],
                 idle_gaps=[(n[:_NAME], s) for n, s in idle.most_common(_TOP)],
                 kernel_s=dict(by_name))
