"""The port's spans (``utils.profiling.span``) and the benchmark's readers
of them (``benchmark/spans.py``, ``benchmark/metrics/{handover_ms,
replay_ms,entry_self_ms}.py``), on the CPU; one card test at the end.

A span records a ``record_function`` event only while a ``torch.profiler``
records, and is one shared no-op otherwise and under ``torch.export``. The
entries (``pqmf.entry.*``), a host block's handover (``pqmf.handover``)
and a graph's replay (``pqmf.graph.copy_in`` / ``launch`` / ``clone_out``;
``pqmf.graph.capture`` when it captures) land in the profiler's trace
beside the device's operations. The replay spans are held on the CPU
through ``tests/test_torch_graphs.py``'s stand-in capture and on the card
by the ``cuda`` test:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py
"""

import io
import json

import numpy as np
import pytest
import torch

from benchmark import harness, spans, tracing
from pqmf_tpu_torch import PQMF, PQMFPitchShiftWrapper, PQMFWrapper, graphs
from pqmf_tpu_torch import export as ex
from pqmf_tpu_torch.utils import profiling
from test_torch_graphs import StandIn

PROGRAM_SPANS = ("pqmf.entry.", "pqmf.handover", "pqmf.graph.")
NEW_METRICS = ("handover_ms.streams", "handover_ms.live", "handover_ms.bank",
               "replay_ms.streams", "replay_ms.live", "replay_ms.bank",
               "entry_self_ms.streams", "entry_self_ms.files",
               "entry_self_ms.live", "entry_self_ms.bank")


def _audio(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(
        np.float32)


def _spans(log_dir) -> list:
    """(name, start, end) of the program's spans in ``trace.json``, in
    start order."""
    with open(log_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in events if e.get("ph") == "X"
           and e.get("cat") == "user_annotation"
           and e["name"].startswith(PROGRAM_SPANS)]
    return sorted(out, key=lambda s: s[1])


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


# ---------------------------------------------------------------------------
# the spans
# ---------------------------------------------------------------------------


def test_process_records_its_entry_and_one_handover(tmp_path):
    w = PQMFWrapper(70, 4, 512, device="cpu")
    x = _audio((1, 512), 0)
    with profiling.trace(str(tmp_path / "host")):
        w.process(x)
    found = _spans(tmp_path / "host")
    assert [s[0] for s in found] == ["pqmf.entry.process", "pqmf.handover"]
    assert _inside(found[1], found[0])
    with profiling.trace(str(tmp_path / "device")):
        w.process(torch.from_numpy(x))
    assert [s[0] for s in _spans(tmp_path / "device")] == [
        "pqmf.entry.process"]


def test_roundtrip_and_streams_record_their_entries(tmp_path):
    pq = PQMF(70, 4, device="cpu")
    w = PQMFPitchShiftWrapper(70, 4, 512, shifts_in_semitones=[1, -1, 3, -3],
                              device="cpu")
    with profiling.trace(str(tmp_path)):
        pq.roundtrip(torch.from_numpy(_audio((1, 1, 1024), 1)))
        w.pitchshift_streams(w.init_streams(2), _audio((2, 512), 2))
        w.pitchshift_fn(w.init_state(), _audio((1, 512), 3))
    names = [s[0] for s in _spans(tmp_path)]
    assert names == ["pqmf.entry.roundtrip",
                     "pqmf.entry.pitchshift_streams", "pqmf.handover",
                     "pqmf.entry.pitchshift_fn", "pqmf.handover"]


def test_span_is_one_shared_noop_without_a_profiler(monkeypatch):
    def made(name):
        raise AssertionError(f"a RecordFunction was made for {name!r}")

    monkeypatch.setattr(torch.profiler, "record_function", made)
    assert not torch._C._autograd._profiler_enabled()
    assert profiling.span("a") is profiling.span("b")
    with profiling.span("a"):
        pass


def test_span_records_only_while_a_profiler_records(monkeypatch):
    with torch.profiler.profile():
        on = profiling.span("a")
        assert isinstance(on, torch.profiler.record_function)
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
        assert profiling.span("a") is profiling.span("b")


def test_export_under_a_profiler_holds_no_span():
    """``PQMFWrapper.process`` is the plain wrapper's exported method: a
    profiler running during the export leaves the program as it is
    without one."""
    w = PQMFWrapper(70, 4, 512, device="cpu")

    def targets(blob):
        ep = torch.export.load(io.BytesIO(blob))
        return [str(n.target) for n in ep.graph.nodes]

    plain = targets(ex.export_stablehlo(w, 512))
    with torch.profiler.profile():
        traced = targets(ex.export_stablehlo(w, 512))
    assert traced == plain
    assert not any("profiler" in t or "record_function" in t for t in plain)


def _replay_spans(w, x, log_dir):
    """Warm ``w.pitchshift_fn`` up on ``x`` (the eager call and the
    capture), then trace one more call; the program's spans of that
    call."""
    state = w.init_state()
    for _ in range(2):
        state, _ = w.pitchshift_fn(state, x)
    with profiling.trace(str(log_dir)):
        w.pitchshift_fn(state, x)
    return _spans(log_dir)


def _assert_one_replay(found):
    names = [s[0] for s in found]
    assert names == ["pqmf.entry.pitchshift_fn", "pqmf.handover",
                     "pqmf.graph.copy_in", "pqmf.graph.launch",
                     "pqmf.graph.clone_out"]
    assert all(_inside(s, found[0]) for s in found[1:])
    copy_in, launch, clone_out = found[2:]
    assert copy_in[2] <= launch[1] and launch[2] <= clone_out[1]


def test_a_replay_records_its_three_spans_and_no_capture(monkeypatch,
                                                         tmp_path):
    """The replay's three spans come in order around it: the stand-in's
    replay (the launch) runs once a replayed call, and it binds the call's
    four tensor leaves (tail and x in, tail and y out)."""
    cap = StandIn()
    monkeypatch.setattr(graphs, "_graphed", lambda device: True)
    monkeypatch.setattr(graphs, "_capture", cap)
    monkeypatch.setitem(graphs.IO, "bound", 0)
    monkeypatch.setitem(graphs.IO, "dispatched", 0)
    w = PQMFPitchShiftWrapper(70, 4, 512, shifts_in_semitones=[1, -1, 3, -3],
                              device="cpu")
    _assert_one_replay(_replay_spans(w, _audio((1, 512), 4), tmp_path))
    assert cap.events == ["capture", "replay", "replay"]
    assert graphs.IO == {"bound": 8, "dispatched": 0}


def test_a_process_replay_records_its_three_spans(monkeypatch, tmp_path):
    """``PQMFWrapper.process`` replays its graph inside its entry span,
    after the host block's handover."""
    monkeypatch.setattr(graphs, "_graphed", lambda device: True)
    monkeypatch.setattr(graphs, "_capture", StandIn())
    w = PQMFWrapper(70, 4, 512, device="cpu")
    x = _audio((1, 512), 7)
    for _ in range(2):
        w.process(x)
    with profiling.trace(str(tmp_path)):
        w.process(x)
    found = _spans(tmp_path)
    assert [s[0] for s in found] == [
        "pqmf.entry.process", "pqmf.handover", "pqmf.graph.copy_in",
        "pqmf.graph.launch", "pqmf.graph.clone_out"]
    assert all(_inside(s, found[0]) for s in found[1:])


def test_a_capture_records_its_span(monkeypatch, tmp_path):
    monkeypatch.setattr(graphs, "_graphed", lambda device: True)
    monkeypatch.setattr(graphs, "_capture", StandIn())
    w = PQMFPitchShiftWrapper(70, 4, 512, shifts_in_semitones=[1, -1, 3, -3],
                              device="cpu")
    with profiling.trace(str(tmp_path)):
        w.pitchshift_fn(w.init_state(), _audio((1, 512), 5))
    names = [s[0] for s in _spans(tmp_path)]
    assert names == ["pqmf.entry.pitchshift_fn", "pqmf.handover",
                     "pqmf.graph.capture"]


# ---------------------------------------------------------------------------
# the readers, on a synthetic trace
# ---------------------------------------------------------------------------


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def fake_trace(tmp_path, with_spans=True):
    """A slice [0, 100] us of 2 calls. Call 1's entry starts before the
    slice; inside it a handover and a replay's three spans. Call 2's entry
    holds a launch. Kernels leave the device idle in [5, 15], [19, 20],
    [24, 28], [40, 90] and [95, 100]; a span after the slice is not
    counted."""
    ann = "user_annotation"
    ev = [_x(ann, "bench.slice", 0.0, 100.0),
          _x("cuda_runtime", "cudaGraphLaunch", 19.0, 6.0)]
    ev += [_x("kernel", "void elementwise_kernel<128>", a, b - a)
           for a, b in ((0, 5), (15, 19), (20, 24), (28, 40), (90, 95))]
    if with_spans:
        ev += [_x(ann, "pqmf.entry.pitchshift_fn", -10.0, 40.0),
               _x(ann, "pqmf.handover", 5.0, 10.0),
               _x(ann, "pqmf.graph.copy_in", 16.0, 2.0),
               _x(ann, "pqmf.graph.launch", 18.0, 7.0),
               _x(ann, "pqmf.graph.clone_out", 25.0, 3.0),
               _x(ann, "pqmf.entry.pitchshift_fn", 40.0, 50.0),
               _x(ann, "pqmf.graph.launch", 50.0, 10.0),
               _x(ann, "pqmf.handover", 110.0, 5.0)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return tracing.read_trace(path, 2)


def read_layer(name, t):
    return harness.reader("metrics", name).read(t)


@pytest.mark.parametrize("cell", ["streams", "live", "bank"])
def test_handover_ms_clips_to_the_slice(tmp_path, cell):
    # [5, 15]; the handover at [110, 115] lies past the slice
    assert read_layer(f"handover_ms.{cell}", fake_trace(tmp_path)) == \
        pytest.approx(0.005)


@pytest.mark.parametrize("cell", ["streams", "live", "bank"])
def test_replay_ms_is_the_union_of_the_three_spans(tmp_path, cell):
    # [16, 28] and [50, 60] over 2 calls
    assert read_layer(f"replay_ms.{cell}", fake_trace(tmp_path)) == \
        pytest.approx(0.011)


@pytest.mark.parametrize("cell", ["streams", "files", "live", "bank"])
def test_entry_self_ms_leaves_out_the_spans_inside(tmp_path, cell):
    # entries [0, 30] (clipped) and [40, 90]: 80 us, less 10 + 12 + 10
    assert read_layer(f"entry_self_ms.{cell}", fake_trace(tmp_path)) == \
        pytest.approx(0.024)


def test_the_three_readers_add_up_to_the_entries(tmp_path):
    t = fake_trace(tmp_path)
    entries = spans.seconds(spans.union(
        t, lambda n: n.startswith("pqmf.entry."))) / t.calls * 1e3
    total = sum(read_layer(n, t) for n in (
        "handover_ms.live", "replay_ms.live", "entry_self_ms.live"))
    assert total == pytest.approx(entries) and entries == pytest.approx(0.04)


def test_self_time_over_nested_and_overlapping_children(tmp_path):
    ann = "user_annotation"
    ev = [_x(ann, "bench.slice", 0.0, 100.0),
          _x(ann, "pqmf.entry.process", 10.0, 60.0),
          _x(ann, "pqmf.handover", 12.0, 10.0),
          _x(ann, "pqmf.graph.launch", 18.0, 10.0),
          _x(ann, "pqmf.graph.clone_out", 65.0, 20.0)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    t = tracing.read_trace(path, 1)
    # [10, 70] less [12, 28] and [65, 70]
    assert spans.self_seconds(t, lambda n: n.startswith("pqmf.entry.")) == \
        pytest.approx(39e-6)


def test_idle_gaps_name_the_program_spans(tmp_path):
    """Each idle interval goes to the innermost host event at its middle:
    a program span where the program held the host."""
    gaps = dict(fake_trace(tmp_path).breakdown()["idle_gaps"])
    assert gaps == pytest.approx({
        "host: pqmf.handover": 10e-6, "host: cudaGraphLaunch": 1e-6,
        "host: pqmf.graph.clone_out": 4e-6,
        "host: pqmf.entry.pitchshift_fn": 50e-6,
        "host: between program calls": 5e-6})


@pytest.mark.parametrize("name", NEW_METRICS)
def test_readers_find_nothing_without_spans(tmp_path, name):
    """A trace of a program without the spans, and an empty slice."""
    assert read_layer(name, fake_trace(tmp_path, with_spans=False)) is None
    path = tmp_path / "empty.json"
    path.write_text(json.dumps({"traceEvents": [
        _x("user_annotation", "bench.slice", 0.0, 100.0)]}))
    assert read_layer(name, tracing.read_trace(path, 3)) is None


# ---------------------------------------------------------------------------
# the manifest's entries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NEW_METRICS)
def test_new_metric_has_a_reader_a_layer_and_its_cells(name):
    entry = {m["name"]: m for m in harness.manifest()["per_layer"]}[name]
    assert (entry["unit"], entry["better"], entry["source"]) == (
        "ms", "lower", "device_trace")
    assert callable(harness.reader("metrics", name).read)
    perf = (harness.REPO / "PERF.md").read_text()
    assert f"`{entry['layer']}`" in perf
    assert len(entry["workloads"]) == 1
    for cell in entry["workloads"]:
        reported = [m["name"] for m in harness.load_cell(cell)["end_to_end"]]
        assert entry["moves"] in reported, (name, cell)
        assert name in [m["name"] for m in
                        harness.load_cell(cell)["per_layer"]]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a graph replays only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_replay_on_the_card_records_its_spans(dev, tmp_path):
    w = PQMFPitchShiftWrapper(100, 16, 8192, device=dev)
    found = _replay_spans(w, _audio((1, 8192), 6), tmp_path)
    _assert_one_replay(found)
    assert "pqmf.graph.capture" not in [s[0] for s in found]
