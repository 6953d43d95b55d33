"""The port's spans and counters (``utils/telemetry.py``) on the CPU: the
gate (a span only while a profiler records on the thread), nesting and
self time, the Prefetcher's hand-over of its workers' spans, its counters,
the eager step's and the eager frame's spans, the benchmark's four
readers of the buffer, and ``tools/analyze_trace.py``'s span and gap
tables with the worker spans placed into an exported trace.
"""
import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from instant_nvr_tpu_torch.datasets import prefetch
from instant_nvr_tpu_torch.eval import runner
from instant_nvr_tpu_torch.renderer import inb_renderer as rend
from instant_nvr_tpu_torch.tools import analyze_trace
from instant_nvr_tpu_torch.train import compiled
from instant_nvr_tpu_torch.train import state as tstate
from instant_nvr_tpu_torch.train import step as tstep
from instant_nvr_tpu_torch.utils import telemetry
from instant_nvr_tpu_torch.utils.telemetry import Span
from nvrbench.run import load_reader
from test_torch_capture import _StubGraph, _stub_capture
from test_torch_model import _item
from test_torch_model import tiny as model_tiny
from test_torch_train import tiny as train_tiny


CPU = torch.device("cpu")


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def _empty_buffer():
    telemetry.clear()
    yield
    telemetry.clear()


def _by_name(name):
    return [s for s in telemetry.spans() if s.name == name]


# -- the gate, nesting, self time ----------------------------------------------------

def test_gate_is_the_profilers_thread_local_flag():
    # the gate torch keeps: a torch upgrade that moves it fails here
    on = torch.autograd._profiler_enabled
    assert not on()
    assert telemetry.span("x") is telemetry.NOOP and telemetry.span("y", 3) is telemetry.NOOP
    with telemetry.span("x", 1):
        pass
    telemetry.record("y", 1, 2, 0)
    assert telemetry.spans() == []
    seen = []
    with _profile() as prof:
        assert on()
        th = threading.Thread(target=lambda: seen.append(on()))
        th.start()
        th.join(timeout=10)
        with telemetry.span("x", 7) as sp:
            assert sp is not telemetry.NOOP
        telemetry.record("y", 10, 20, 0, thread="worker")
    assert seen == [False]          # the profiler records only its own thread
    (x,), (y,) = _by_name("x"), _by_name("y")
    assert x.unit == 7 and x.parent is None and x.end_ns >= x.start_ns
    assert x.thread == threading.current_thread().name
    assert y == Span("y", 10, 20, None, 0, "worker")
    assert "nvr.x" in {e.name for e in prof.events()}
    assert "nvr.y" not in {e.name for e in prof.events()}


def test_nesting_parent_and_self_time():
    with _profile():
        with telemetry.span("a", 1):
            time.sleep(0.002)
            with telemetry.span("b"):
                time.sleep(0.002)
            with telemetry.span("c"):
                with telemetry.span("d"):
                    time.sleep(0.001)
    (a,), (b,), (c,), (d,) = (_by_name(n) for n in "abcd")
    assert (a.parent, b.parent, c.parent, d.parent) == (None, "a", "a", "c")
    dur = lambda s: s.end_ns - s.start_ns
    assert telemetry.self_ns("a") == dur(a) - dur(b) - dur(c)
    assert telemetry.self_ns("c") == dur(c) - dur(d)
    assert telemetry.self_ns("d") == dur(d) >= 1_000_000
    # a hand-made buffer: overlapping children count once, another thread's none
    buf = [Span("p", 0, 100, None, 0, "m"), Span("q", 10, 40, "p", 0, "m"),
           Span("q", 30, 50, "p", 0, "m"), Span("q", 60, 70, "p", 0, "w")]
    assert telemetry.self_ns("p", buf) == 100 - 40


# -- the Prefetcher and the stager -------------------------------------------------

@pytest.mark.parametrize("workers", [1, 4])
def test_prefetcher_hands_over_build_and_stage_spans(workers):
    n = 12

    def slow(i):
        time.sleep(0.003)
        return {"i": i}
    pf = prefetch.Prefetcher(slow, range(100, 100 + n), depth=4,
                             device_put=lambda b: dict(b, put=1), workers=workers)
    with _profile():
        got = [b["i"] for b in pf]
    pf.close()
    assert got == list(range(100, 100 + n))
    main = threading.current_thread().name
    for name in ("item.build", "item.stage"):
        spans = _by_name(name)
        assert sorted(s.unit for s in spans) == list(range(n)), name
        assert all(s.thread != main and s.parent is None for s in spans), name
    builds = {s.unit: s for s in _by_name("item.build")}
    assert all(builds[u].end_ns - builds[u].start_ns >= 3_000_000 for u in builds)
    assert len({s.thread for s in builds.values()}) <= workers
    # each item was built before it was staged
    for s in _by_name("item.stage"):
        assert s.start_ns >= builds[s.unit].end_ns
    waits = _by_name("prefetch.wait")
    assert [s.unit for s in waits] == list(range(n + 1))     # and the end's sentinel
    assert all(s.thread == main for s in waits)


@pytest.mark.parametrize("workers", [1, 3])
def test_prefetcher_counters(workers):
    n = 8

    def slow(i):
        time.sleep(0.004)
        return {"i": i}
    pf = prefetch.Prefetcher(slow, range(n), depth=2, workers=workers)
    assert len(list(pf)) == n
    pf.close()
    assert pf.built == n
    assert 0.004 * n <= pf.build_s < 10.0
    # a consumer that takes items as they come waits for the builds
    assert 0.0 < pf.wait_s < 10.0
    assert telemetry.spans() == []                # counters without a profiler


def test_device_stager_counts_the_bytes_it_copies():
    stager = prefetch.DeviceStager(torch.device("cpu"),
                                   lambda it, put: {k: put(v) for k, v in it.items()})
    stager({"a": np.zeros((3, 5), np.float32), "b": np.zeros(7, np.int64)})
    assert stager.bytes == 3 * 5 * 4 + 7 * 8


# -- the eager step and frame ----------------------------------------------------------

def test_eager_step_spans():
    c = train_tiny("float32")
    state = tstate.create_train_state(c.cfg, c.model())
    step = tstep.make_train_step(c.mspec, c.rspec, c.lw)
    gen = torch.Generator().manual_seed(3)
    step(state, c.batch, generator=gen)           # untraced
    assert telemetry.spans() == []
    with _profile():
        step(state, c.batch, generator=gen)
    (s,) = _by_name("step")
    assert s.unit == 1 and s.parent is None
    kids = [x for x in telemetry.spans() if x.parent == "step"]
    assert [x.name for x in kids] == ["step.forward", "step.backward", "step.optimizer"]
    assert all(s.start_ns <= x.start_ns and x.end_ns <= s.end_ns for x in kids)
    assert state.step == 2


def test_eager_frame_spans_and_raises():
    c = model_tiny("float32")
    item = dict(_item(256), frame_index=np.int32(3), cam_ind=np.int32(1))
    chunk = 128
    # budgets far under the item's demand: the first render raises them
    low = c.mspec._replace(cull_frac=0.01, part_frac=0.01)
    renderer = runner.AutoBudgetRenderer(low, rend.RenderSpec(n_samples=8), chunk)
    with _profile():
        out = renderer(c.model, item)
    assert out["rgb_map"].shape == (256, 3)
    assert renderer.raises >= 1
    (frame,) = _by_name("frame")
    assert frame.unit == (3, 1) and frame.parent is None
    renders = 1 + renderer.raises
    chunks = runner.padded_chunks(256, chunk)
    assert len(_by_name("frame.raise")) == renderer.raises
    for name in ("frame.pad", "frame.copy_in", "frame.readback"):
        assert len(_by_name(name)) == renders, name
    assert sorted(s.unit for s in _by_name("frame.chunk")) == sorted(
        list(range(chunks)) * renders)
    assert renderer.chunks_rendered == chunks * renders
    # a frame whose budgets hold: no raise, no raise span
    telemetry.clear()
    with _profile():
        renderer(c.model, item)
    assert renderer.raises == renders - 1 and not _by_name("frame.raise")
    assert [s.parent for s in _by_name("frame.pad")] == ["frame"]


def test_captured_program_spans_around_its_graph(monkeypatch):
    """A captured program's call: ``<name>.copy_in``, then the warm-up, the
    capture and replay, or the replay; none inside the captured function
    (a stub graph, the side stream left out)."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph", _stub_capture)
    monkeypatch.setattr(compiled, "side_stream", lambda device: None)
    monkeypatch.setattr(compiled, "on_side_stream", lambda fn, stream, device: fn())
    prog = runner.CapturedFrame.__new__(runner.CapturedFrame)
    compiled.CapturedProgram.__init__(prog)
    inside = []

    def fn(st):
        inside.append(len(telemetry.spans()))
        return {"y": st["x"]["a"] * 2}
    with _profile():
        for _ in range(3):
            prog.run(("k",), {"x": {"a": torch.ones(3)}}, CPU, fn)
    names = [s.name for s in telemetry.spans()]
    assert names == ["frame.copy_in", "frame.warmup", "frame.copy_in", "frame.capture",
                     "frame.replay", "frame.copy_in", "frame.replay"]
    assert prog.captures == 1 and prog.replays == 2
    # the warm-up and the capture ran fn with only the spans before it closed
    assert inside == [1, 3]
    assert compiled.Graph({"x": {"a": torch.ones(3)}}).nbytes == 12


# -- the benchmark's readers ----------------------------------------------------------

def _buffer(spans):
    telemetry.clear()
    telemetry._buffer.extend(spans)


MS = 1_000_000
HAND_MADE = [
    Span("step", 0, 3 * MS, None, 60, "m"), Span("step.fill", MS, 2 * MS, "step", None, "m"),
    Span("step", 10 * MS, 11 * MS, None, 61, "m"),
    Span("prefetch.wait", 5 * MS, 9 * MS, None, 0, "m"),
    Span("prefetch.wait", 20 * MS, 22 * MS, None, 1, "m"),
    Span("item.build", 0, 40 * MS, None, 0, "w1"), Span("item.build", 0, 20 * MS, None, 1, "w2"),
    Span("item.stage", 0, 5 * MS, None, 0, "s"),
    Span("frame.pad", 0, 6 * MS, "frame", None, "m"),
    Span("frame.copy_in", 6 * MS, 10 * MS, "frame", None, "m"),
    Span("frame.readback", 30 * MS, 99 * MS, "frame", None, "m"),
]


@pytest.mark.parametrize("metric,kind,want", [
    ("step_host_ms.fit", "fit", 2.0),            # (3 + 1) ms over 2 steps
    ("feed_wait_ms.fit", "fit", 3.0),            # (4 + 2) ms over 2 steps
    ("item_build_ms.fit", "fit", 30.0),          # the mean of 40 and 20 ms
    ("frame_host_ms.render", "render", 5.0),     # (6 + 4) ms over 2 frames
])
def test_readers_on_a_hand_made_buffer(metric, kind, want):
    reader = load_reader(metric)
    r = SimpleNamespace(kind=kind, trace_units=2)
    _buffer(HAND_MADE)
    assert reader.read(r) == pytest.approx(want)
    other = SimpleNamespace(kind="render" if kind == "fit" else "fit", trace_units=2)
    assert reader.read(other) is None
    _buffer([])
    assert reader.read(r) is None
    _buffer([Span("unrelated", 0, MS, None, 0, "m")])
    assert reader.read(r) is None


# -- analyze_trace: the span and gap tables, the worker spans ---------------------------

def _host(name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": "user_annotation", "name": name, "pid": 7, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _kernel(ts, dur):
    return {"ph": "X", "cat": "kernel", "name": "void k<1>(int)", "pid": 0, "tid": 9,
            "ts": ts, "dur": dur}


def test_analyze_trace_span_and_gap_tables(tmp_path, capsys):
    events = [
        _host("nvr.step", 0, 100), _host("nvr.step.fill", 10, 30),
        _host("nvr.step.replay", 50, 10),
        _host("nvr.prefetch.wait", 100, 60),
        _host("nvr.step", 160, 40), _host("nvr.step.replay", 170, 20),
        _host("nvr.item.build", -50, 300, tid=1_000_000, worker=True),
        # the same span drawn on the device timeline is no host span
        {"ph": "X", "cat": "gpu_user_annotation", "name": "nvr.step", "pid": 0,
         "tid": 9, "ts": 20, "dur": 180},
        _kernel(20, 5), _kernel(28, 2), _kernel(52, 100), _kernel(154, 2),
        _kernel(165, 30), _kernel(230, 50),
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "pid": 7, "tid": 1,
         "ts": 280, "dur": 20},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    res = analyze_trace.summarize(str(path))
    spans = res["spans"]
    assert res["units"] == 2
    assert spans["nvr.step"] == {"count": 2, "total_ms": 0.14,
                                 "self_ms": pytest.approx(0.08)}
    assert spans["nvr.step.fill"]["self_ms"] == pytest.approx(0.03)
    assert spans["nvr.item.build"]["count"] == 1
    gaps = res["gaps"]
    # the trace spans [0, 300) us; idle [0,20) under step, [25,28) short,
    # [30,52) under fill, [152,154) short, [156,165) under the wait,
    # [195,230) under the second step, [280,300) under none
    assert gaps["labels"] == pytest.approx({"nvr.step": 0.020 + 0.035,
                                            "nvr.step.fill": 0.022,
                                            "nvr.prefetch.wait": 0.009, "other": 0.020})
    assert gaps["first"] == ("nvr.step", pytest.approx(0.020))
    assert gaps["short_n"] == 2 and gaps["short_ms"] == pytest.approx(0.005)
    assert gaps["idle_ms"] == pytest.approx(0.020 + 0.003 + 0.022 + 0.002 + 0.009
                                            + 0.035 + 0.020)
    out = capsys.readouterr().out
    assert "host ms by nvr. span" in out and "first gap" in out


def test_worker_spans_are_placed_on_the_traces_clock(tmp_path):
    off_us = 5_000.0
    main = [Span("step", 1_000_000, 1_500_000, None, 0, "m"),
            Span("step.fill", 1_100_000, 1_200_000, "step", None, "m"),
            Span("step", 3_000_000, 3_400_000, None, 1, "m")]
    work = [Span("item.build", 200_000, 900_000, None, 0, "w1"),
            Span("item.stage", 950_000, 990_000, None, 0, "st")]
    events = [_host("nvr." + s.name, s.start_ns / 1e3 + off_us + (0.3 if i else 0.0),
                    (s.end_ns - s.start_ns) / 1e3) for i, s in enumerate(main)]
    events.append(_kernel(off_us + 1_100, 50))
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert telemetry.trace_offset_ns(events, main) == pytest.approx(1e3 * off_us + 300)
    assert telemetry.add_to_chrome_trace(str(path), main + work) == 2
    data = json.loads(path.read_text())["traceEvents"]
    placed = {e["name"]: e for e in data if e.get("args", {}).get("worker")}
    assert placed["nvr.item.build"]["ts"] == pytest.approx(200 + off_us + 0.3)
    assert placed["nvr.item.build"]["dur"] == pytest.approx(700)
    assert placed["nvr.item.stage"]["tid"] != placed["nvr.item.build"]["tid"]
    assert {e["args"]["name"] for e in data if e.get("ph") == "M"} == {
        "nvr worker w1", "nvr worker st"}
    # placed spans are host spans of the tables; they label no gap and do
    # not stretch the trace's span (the build began before the profiler)
    res = analyze_trace.summarize(str(path))
    assert res["spans"]["nvr.item.build"]["count"] == 1
    assert "nvr.item.build" not in res["gaps"]["labels"]
    assert res["span_ms"] == pytest.approx(2.4, abs=1e-3)   # the steps' 1.0 to 3.4 ms
    # a trace that holds none of the buffer's spans places nothing
    path.write_text(json.dumps({"traceEvents": [_kernel(0, 5)]}))
    assert telemetry.add_to_chrome_trace(str(path), main + work) == 0
