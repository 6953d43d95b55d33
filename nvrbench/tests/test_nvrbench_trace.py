"""The trace reader: the busy-interval union, the idle gaps and their
labels, on hand-made profiler events."""
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from nvrbench import trace


def ev(name, start, end, device=DeviceType.CUDA, annotation=False):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=annotation)


def test_busy_union_counts_overlaps_once():
    assert trace.busy_us([(0, 10), (5, 15), (20, 30)]) == 25
    assert trace.busy_us([(0, 10), (0, 10)]) == 10
    assert trace.busy_us([(3, 3)]) == 0
    assert trace.merge_intervals([(5, 8), (0, 2), (1, 3)]) == [(0, 3), (5, 8)]


def test_gaps_of_the_window():
    merged = trace.merge_intervals([(10, 20), (30, 40)])
    assert trace.gaps(merged, 0, 50) == [(0, 10), (20, 30), (40, 50)]
    assert trace.gaps(merged, 10, 40) == [(20, 30)]


def test_summarize_reads_window_kernels_and_gaps():
    cpu = DeviceType.CPU
    events = [
        ev(trace.WINDOW, 100, 200, cpu),
        ev("nvrbench.step", 100, 150, cpu),
        ev("nvrbench.wait_feed", 150, 200, cpu),
        ev("gemm", 100, 140),
        ev("copy", 130, 145),                   # overlaps the gemm: counts once
        ev("knn_blend_kernel", 160, 170),
        ev(trace.WINDOW, 100, 200, annotation=True),   # drawn on the device timeline
        ev("gemm", 300, 400),                   # outside the window
    ]
    s = trace.summarize(events)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(55e-6)
    assert s["kernel_s"]["gemm"] == pytest.approx(40e-6)
    assert trace.kernel_seconds(s, "knn_blend") == pytest.approx(10e-6)
    gaps = dict(s["idle_gaps"])
    # 145-160 begins in the step's span, 170-200 in the feed's wait
    assert gaps == pytest.approx({"nvrbench.step": 15e-6, "nvrbench.wait_feed": 30e-6})
    assert s["device_ops"][0][0] == "gemm"


def test_summarize_without_a_window_or_device_work():
    cpu = DeviceType.CPU
    assert trace.summarize([ev("gemm", 0, 1)]) is None
    assert trace.summarize([ev(trace.WINDOW, 0, 10, cpu)]) is None


def test_gaps_take_the_innermost_span_the_harness_or_the_program_opened():
    cpu = DeviceType.CPU
    events = [
        ev(trace.WINDOW, 0, 100, cpu),
        ev("nvrbench.step", 0, 60, cpu),
        ev("nvr.step", 5, 55, cpu),             # the program's, inside the harness's
        ev("nvr.step.fill", 10, 30, cpu),       # nested inside nvr.step
        ev("aten::copy_", 12, 14, cpu),         # neither's: labels nothing
        ev("nvrbench.frame", 60, 100, cpu),
        ev("gemm", 0, 10),
        ev("gemm", 20, 40),                     # 10-20 begins under nvr.step.fill
        ev("gemm", 50, 70),                     # 40-50 under nvr.step
        ev("gemm", 57, 58),
        ev("gemm", 80, 90),                     # 70-80 under nvrbench.frame only
    ]
    gaps = dict(trace.summarize(events)["idle_gaps"])
    assert gaps == pytest.approx({"nvr.step.fill": 10e-6, "nvr.step": 10e-6,
                                  "nvrbench.frame": 20e-6})
