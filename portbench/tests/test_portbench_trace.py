"""The traced window's reduction, on a hand-made trace."""

import pytest

from portbench.tests.tiny import CHECKOUT
from portbench.trace import MARK, Event, reduce


def test_busy_idle_and_labels():
    ev = [
        Event(f"at::cuda::{MARK}(long)", "kernel", -10, 0, 7),
        Event(f"at::cuda::{MARK}(long)", "kernel", 1000, 1010, 7),
        Event("portbench.train_step", "user_annotation", 0, 800, 1),
        Event("aten::mm", "cpu_op", 100, 200, 1),
        Event("aten::item", "cpu_op", 500, 800, 1),
        Event("void (anonymous namespace)::fwd_tc_kernel<__nv_bfloat16, 64>"
              "(int)", "kernel", 150, 300, 7),
        Event("gemm", "kernel", 250, 450, 7),
        Event("Memcpy DtoH", "gpu_memcpy", 600, 700, 7),
        Event("outside", "kernel", 1200, 1300, 7),
    ]
    s = reduce(ev)
    assert s.window_s == pytest.approx(1e-6)
    assert s.busy_s == pytest.approx(400e-9)  # 150..450 and 600..700
    assert s.idle_share == pytest.approx(0.6)
    assert s.kernel_s == {"A1": pytest.approx(150e-9)}
    gaps = dict(s.idle_gaps)
    assert gaps == {
        "portbench.train_step": pytest.approx(150e-9),  # 0..150
        "portbench.train_step / aten::item": pytest.approx(150e-9),
        "no host operation": pytest.approx(300e-9)}  # 700..
    names = [n for n, _ in s.device_ops]
    assert names[0] == "gemm" and "outside" not in names
    assert names[1].startswith("(anonymous namespace)::fwd_tc_kernel")


def test_no_device_work_reads_nothing():
    assert reduce([Event(MARK, "kernel", 0, 1, 7),
                   Event(MARK, "kernel", 9, 10, 7),
                   Event("aten::mm", "cpu_op", 1, 2, 1)]) is None
    assert reduce([Event("k", "kernel", 0, 1, 7)]) is None


class _Raw:
    """A raw profiler event: a name, the device it ran on and its
    times."""

    def __init__(self, name, device, start, end):
        from torch.autograd import DeviceType

        self._n, self._s, self._e = name, start, end
        self._d = DeviceType.CUDA if device else DeviceType.CPU

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def start_thread_id(self):
        return 1


def test_kinds_are_worked_out_where_the_trace_lacks_them():
    from portbench.trace import from_kineto

    raw = [_Raw("portbench.step", False, 0, 100),
           _Raw("portbench.step", True, 0, 100), _Raw(MARK, True, 0, 1),
           _Raw(MARK, True, 99, 100),
           _Raw("cudaLaunchKernel", False, 1, 2),
           _Raw("cuLaunchKernel", False, 1, 2),
           _Raw("aten::mm", False, 1, 9), _Raw("gemm", True, 10, 20),
           _Raw("Memcpy HtoD (Pageable -> Device)", True, 30, 40),
           _Raw("Memset (Device)", True, 50, 55)]
    kinds = [e.kind for e in from_kineto(raw)]
    assert kinds == ["cpu_op", "gpu_user_annotation", "kernel", "kernel",
                     "cuda_runtime",
                     "cuda_runtime", "cpu_op", "kernel", "gpu_memcpy",
                     "gpu_memset"]
    s = reduce(from_kineto(raw))
    assert s.busy_s == pytest.approx(25e-9)  # the annotation is no work


def test_idle_share_is_read_against_the_window_s_steps():
    """The traced steps run slower than the window's under the profiler:
    the idle share takes the device's busy time over the window's own
    time for as many steps."""
    from portbench import harness
    from portbench.trace import Summary

    bench = harness.Bench(CHECKOUT)
    cell = bench.cell("train-base-4x4")
    trace = Summary(window_s=1.4, busy_s=0.4, device_ops=[], idle_gaps=[],
                    kernel_s={}, device_s=0.4)
    readings = harness.Readings(cell=cell, spans={}, trace=trace,
                                values={"traced_steps_window_s": 1.0})
    assert bench.reader("idle_pct.train")(readings) == pytest.approx(60.0)
    readings.values = {}
    assert bench.reader("idle_pct.train")(readings) is None


class _Session:
    """A finished profiler session: its events and whether it recorded
    the host."""

    def __init__(self, events, host):
        self._events, self.host = events, host

    def events(self):
        return self._events


def _traced(offset, work_ns):
    return [Event(MARK, "kernel", offset - 10, offset, 7),
            Event(MARK, "kernel", offset + 1000, offset + 1010, 7),
            Event("portbench.train_step", "user_annotation", offset,
                  offset + 1000, 1),
            Event("gemm", "kernel", offset + 100, offset + 100 + work_ns, 7)]


@pytest.mark.parametrize("lost", ["device", "host", "both"])
def test_a_session_that_lost_its_span_is_stood_in_for(lost):
    """The device session gives busy time and the host session the idle
    gaps' labels; where one lost its span (no closing marker), the
    other's reading stands."""
    import torch

    from portbench.families import progen
    from portbench.trace import UNLABELLED, Sessions

    device, host = _traced(0, 400), _traced(5000, 400)
    if lost in ("device", "both"):
        device = device[:1] + device[2:]
    if lost in ("host", "both"):
        host = host[:1] + host[2:]
    sessions = Sessions(torch.device("cpu"), 1, progen.KERNEL_NAMES)
    sessions.profs = [_Session(device, False), _Session(host, True)]
    s = sessions.summary()
    if lost == "both":
        assert s is None
        return
    assert s.busy_s == pytest.approx(400e-9)
    assert s.window_s == pytest.approx(1e-6)
    if lost == "host":
        assert s.idle_gaps == [[UNLABELLED, pytest.approx(600e-9)]]
    else:
        assert dict(s.idle_gaps) == {
            "portbench.train_step": pytest.approx(600e-9)}
