"""The trace reduction: device busy time as a union of intervals, and each
idle gap put down to the innermost host operation open when it opened."""

import types

import pytest
from torch.autograd import DeviceType

from portbench import trace


class _Event:
    def __init__(self, kind, name, start, end):
        self.kind, self._name, self.start, self.end = kind, name, start, end

    def device_type(self):
        return self.kind

    def name(self):
        return self._name

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.end - self.start


def _prof(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))


def test_busy_union_and_gaps():
    ms = 1_000_000
    events = [
        _Event(DeviceType.CUDA, "k1", 0, 10 * ms),
        _Event(DeviceType.CUDA, "k2", 5 * ms, 12 * ms),      # overlaps k1
        _Event(DeviceType.CUDA, "k1", 20 * ms, 25 * ms),
        _Event(DeviceType.CUDA, "k3", 40 * ms, 41 * ms),
        _Event(DeviceType.CPU, "outer", 0, 50 * ms),
        _Event(DeviceType.CPU, "launch", 11 * ms, 13 * ms),   # open at 12 ms
        _Event(DeviceType.CPU, "sync", 24 * ms, 30 * ms),     # open at 25 ms
    ]
    t = trace.summarize(_prof(events), window_s=0.05)
    assert t.busy_s == pytest.approx(0.018)
    assert t.idle_share == pytest.approx(1 - 0.018 / 0.05)
    assert dict(t.idle_gaps) == pytest.approx({"launch": 0.008, "sync": 0.015})
    assert dict(t.device_ops) == pytest.approx({"k1": 0.015, "k2": 0.007, "k3": 0.001})
    assert t.seconds_of("k") == pytest.approx(0.023)
