"""The trace's reduction: busy time as the union of device operations over
the stretch, time by operation, idle gaps named by the host's span."""

import types

import pytest
from torch.autograd import DeviceType

from h100bench.trace import STRETCH, Spans, read_trace


def _ev(name, start, end, device=DeviceType.CPU):
    return types.SimpleNamespace(name=name, device_type=device, is_user_annotation=False,
                                 time_range=types.SimpleNamespace(start=start, end=end))


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_busy_is_the_union_and_gaps_are_named_by_span():
    cuda = DeviceType.CUDA
    prof = _Prof([
        _ev(STRETCH, 0, 100),
        _ev("generate", 0, 30), _ev("readback", 30, 100),
        _ev("gemm", 10, 40, cuda), _ev("copy", 20, 50, cuda),   # overlap: 10..50 busy
        _ev("gemm", 60, 90, cuda),                             # 50..60 idle in readback
    ])
    out = read_trace(prof, {"generate", "readback"})
    assert out["busy_s"] == pytest.approx(70e-6)
    assert out["window_s"] == pytest.approx(100e-6)
    assert out["ops"] == {"gemm": pytest.approx(60e-6), "copy": pytest.approx(30e-6)}
    assert out["idle"] == {"generate": pytest.approx(10e-6), "readback": pytest.approx(20e-6)}


def test_no_device_operation_reads_nothing():
    assert read_trace(_Prof([_ev(STRETCH, 0, 10), _ev("step", 0, 10)]), {"step"}) is None


def test_spans_time_each_call():
    spans = Spans()
    for _ in range(3):
        with spans("put"):
            pass
    assert len(spans.seconds["put"]) == 3 and min(spans.seconds["put"]) >= 0
