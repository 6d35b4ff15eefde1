"""Reading a profiled window: device-busy time is the union of device
work, and a ``record_function`` range's device-side copy is no work."""

from __future__ import annotations

import pytest

from benchmark import trace


class _Event:
    def __init__(self, name, device, start_us, dur_us, annotation=False):
        self._name, self._device = name, device
        self._start, self._dur = start_us * 1000, dur_us * 1000
        self._annotation = annotation

    def name(self):
        return self._name

    def device_type(self):
        return f"DeviceType.{self._device}"

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def is_user_annotation(self):
        return self._annotation


class _Profile:
    def __init__(self, events):
        results = type("Results", (), {"events": lambda _: events})()
        self.profiler = type("Profiler", (), {"kineto_results": results})()


KERNELS = [_Event("gemm", "CUDA", 100, 50), _Event("relu", "CUDA", 120, 60),
           _Event("memcpy", "CUDA", 300, 10)]
HOST = [_Event("align", "CPU", 0, 400), _Event("aten::mm", "CPU", 90, 20)]


def _read(extra=()):
    return trace.read(_Profile(HOST + KERNELS + list(extra)), 1e-3)


def test_busy_time_is_the_union_of_device_work():
    w = _read()
    assert w.busy_s == pytest.approx(90e-6)  # [100, 180) and [300, 310)
    assert w.kernel_s == pytest.approx({"gemm": 50e-6, "relu": 60e-6,
                                        "memcpy": 10e-6})
    assert w.spans == {"align": [pytest.approx(400e-6)]}
    assert sum(s for _, s in w.idle_gaps) == pytest.approx(120e-6)


@pytest.mark.parametrize("name", ["align", "icp_loop", "forward"])
def test_a_device_side_annotation_is_no_device_work(name):
    """Nested spans of any name (the benchmark's or the program's) leave
    busy time, kernel time and the idle gaps as they were."""
    plain = _read()
    annotated = _read([_Event(name, "CUDA", 0, 400, annotation=True),
                       _Event(name, "CPU", 80, 250, annotation=True)])
    assert annotated.busy_s == plain.busy_s
    assert annotated.kernel_s == plain.kernel_s
    assert [s for _, s in annotated.idle_gaps] == [
        s for _, s in plain.idle_gaps]


@pytest.mark.gpu
def test_nested_spans_on_the_card_leave_busy_time_unchanged(card):
    import torch
    from torch.profiler import record_function

    a = torch.randn(2048, 2048, device="cuda")

    def work(nested):
        out = a
        for i in range(4):
            if nested:
                with record_function(f"inner{i}"):
                    out = torch.relu(out @ a)
            else:
                out = torch.relu(out @ a)
        return out

    work(False)
    readings = {}
    for nested in (False, True):
        with trace.profiled("cuda") as held:
            with record_function("align"):
                work(nested)
        readings[nested] = held.window
    plain, nested = readings[False], readings[True]
    assert not any(n.startswith("inner") or n == "align"
                   for n in nested.kernel_s)
    assert set(nested.kernel_s) == set(plain.kernel_s)
    assert nested.busy_s == pytest.approx(plain.busy_s, rel=0.2)
    assert nested.busy_s < nested.window_s
