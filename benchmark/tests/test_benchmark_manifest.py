"""``BENCHMARK.json`` against the benchmark's contract, and the arithmetic
of its metrics, on the CPU: names and units, what each metric moves, the
files each entry names, the roofline's count, the window's statistics
over all calls, the trace reader, and the traffic's seeds."""

from __future__ import annotations

import json
import math
import re
import statistics

import pytest
import torch

from benchmark import audio, harness, roofline, tracing

BENCH = harness.manifest()
ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert len(BENCH["command"]) <= 32
    assert (harness.REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200
                    assert "\n" not in entry[key] and "\t" not in entry[key]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    assert len(set(names)) == len(names)


def test_entries_have_exactly_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for cell in CELLS:
        spec = harness.load_cell(cell)
        names = [m["name"] for m in spec["end_to_end"]]
        assert "setup_s" in names and len(names) >= 2, cell
        assert spec["per_layer"], cell


def test_per_layer_moves_a_metric_its_cells_report():
    for m in BENCH["per_layer"]:
        cells = m.get("workloads", CELLS)
        for cell in cells:
            reported = [e["name"] for e in harness.load_cell(cell)
                        ["end_to_end"]]
            assert m["moves"] in reported, (m["name"], cell)


def test_every_named_file_exists():
    for c in BENCH["configs"]:
        path = harness.REPO / c["file"]
        assert path.is_file() and c["file"].startswith("benchmark/")
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["check"]["numbers"]
    for w in BENCH["workloads"]:
        assert (ROOT / "traffic" / f"{w['traffic']}.json").is_file()
        spec = harness.load_cell(w["name"])
        assert callable(spec["system"].build)
        assert callable(spec["system"].check)
        loop = spec["traffic"].get("loop", "closed")
        assert (ROOT / "traffic" / f"{loop}.py").is_file()
    for folder, group in (("end_to_end", "end_to_end"),
                          ("metrics", "per_layer")):
        for m in BENCH[group]:
            assert callable(harness.reader(folder, m["name"]).read)


def test_readers_fall_back_to_their_family():
    """A metric of a family (``idle_share.streams``) without a file of its
    own is read by the family's file; one with its own file by that."""
    assert harness.reader("metrics", "idle_share.streams").__file__.endswith(
        "metrics/idle_share.py")
    assert harness.reader("metrics", "pqmf_roofline.files").__file__.endswith(
        "metrics/pqmf_roofline.files.py")
    assert harness.reader("end_to_end", "audio_rtf.new").__file__.endswith(
        "end_to_end/audio_rtf.py")


def test_loop_is_found_by_name(tmp_path, monkeypatch):
    """A traffic file's ``loop`` names ``traffic/<loop>.py``: a new loop is
    a new file."""
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "twice.py").write_text(
        "import time\n"
        "def measure(prog, pool, g, seconds, traffic, kept):\n"
        "    t0 = time.perf_counter()\n"
        "    for i in (g, g + 1):\n"
        "        kept.offer((i, prog.call(pool[i % len(pool)])))\n"
        "    return [0.5, 0.25], t0\n")
    monkeypatch.setattr(harness, "ROOT", tmp_path)

    class Double:
        def call(self, x):
            return (2 * x,)

    lat, window_s, kept = harness.measure(
        Double(), [1, 2, 3], 4, 1.0, {"loop": "twice", "sample": 8}, 0,
        torch.device("cpu"))
    assert lat == [0.5, 0.25] and window_s >= 0
    assert kept == [(4, (4,)), (5, (6,))]


def test_layers_match_perf_md():
    perf = (harness.REPO / "PERF.md").read_text()
    for m in BENCH["per_layer"]:
        assert f"`{m['layer']}`" in perf, m["layer"]


def test_run_seconds_fit_a_full_check():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_roofline_hand_count_files():
    """pqmf16.files: 8 clips of 60 s at 44.1 kHz, 16 bands, 512 taps (32 a
    phase): analysis and synthesis 8 * 2,646,000 * 16 * 32 FMAs each."""
    fma = 8 * 2_646_000 * 16 * 32
    flop, nbytes = roofline.polyphase_roundtrip_work(8, 2_646_000, 16, 512)
    assert flop == 2 * 2 * fma == 43_352_064_000
    assert nbytes == 4 * (2 * 8 * 2_646_000 + 2 * 16 * 16 * 32)
    seconds, bound = roofline.polyphase_roundtrip(
        harness.load_cell("pqmf16.files")["config"], 8, 2_646_000)
    assert bound == "operations"
    assert seconds == pytest.approx(43_352_064_000 / 67e12)


def window(latencies, rows=128, block=8192):
    return harness.Window(calls=len(latencies), latencies=latencies,
                          window_s=sum(latencies), setup_s=12.5, rows=rows,
                          block=block, sample_rate=44100.0)


def read_e2e(name, w):
    return harness.reader("end_to_end", name).read(w)


def test_end_to_end_over_every_call():
    lat = [0.001 * (1 + i % 7) for i in range(1000)] + [0.5]
    w = window(lat)
    for name in ("audio_rtf.streams", "audio_rtf.files"):
        assert read_e2e(name, w) == pytest.approx(
            len(lat) * 128 * 8192 / 44100 / sum(lat))
    s = sorted(lat)
    assert read_e2e("block_p50_ms", w) == pytest.approx(
        statistics.median(s) * 1e3)
    pos = (len(s) - 1) * 0.95
    lo = math.floor(pos)
    p95 = s[lo] + (s[lo + 1] - s[lo]) * (pos - lo)
    assert read_e2e("block_p95_ms", w) == pytest.approx(p95 * 1e3)
    assert read_e2e("setup_s", w) == 12.5


def test_percentile_matches_numpy():
    import numpy as np

    v = list(np.random.default_rng(0).random(257))
    for q in (0, 50, 90, 95, 100):
        assert harness.percentile(v, q) == pytest.approx(
            np.percentile(v, q))


def fake_trace(tmp_path):
    """A slice of 2 calls: a PQMF kernel, a middle kernel, two copies and
    an idle gap under a host op."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.slice",
         "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 0.0,
         "dur": 10.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> "
         "Device)", "ts": 5.0, "dur": 5.0},
        {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::"
         "analysis_kernel<4>(float const*)", "ts": 10.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "void at::native::"
         "elementwise_kernel<128>", "ts": 15.0, "dur": 20.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "ts": 35.0, "dur": 30.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> "
         "Pageable)", "ts": 60.0, "dur": 10.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> "
         "Device)", "ts": 70.0, "dur": 10.0},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return tracing.read_trace(path, 2)


def read_layer(name, t):
    return harness.reader("metrics", name).read(t)


def test_trace_reader_and_metrics(tmp_path):
    t = fake_trace(tmp_path)
    t.context = {"window": window([200e-6] * 10)}
    # busy: [5, 35] and [60, 80] of [0, 100]
    assert t.busy_s == pytest.approx(50e-6)
    assert t.window_s == pytest.approx(100e-6)
    # 25 us busy a call against 200 us a call in the untraced window
    for name in ("idle_share.streams", "idle_share.files", "idle_share.live"):
        assert read_layer(name, t) == pytest.approx(87.5)
    # the middle: every kernel but the PQMF ones, a call
    assert read_layer("middle_ms.streams", t) == pytest.approx(0.010)
    assert read_layer("kernels_per_block.live", t) == 1.0
    # host-card copies only: 5 + 10 us over 2 calls
    assert read_layer("copy_ms.live", t) == pytest.approx(0.0075)
    gaps = dict(t.breakdown()["idle_gaps"])
    assert gaps["host: cudaStreamSynchronize"] == pytest.approx(25e-6)
    ops = dict(t.breakdown()["device_ops"])
    assert ops["Memcpy DtoD (Device -> Device)"] == pytest.approx(10e-6)


def test_roofline_reader(tmp_path):
    t = fake_trace(tmp_path)
    spec = harness.load_cell("pqmf16.files")
    t.context = {"config": spec["config"], "rows": 8, "block": 2_646_000}
    bound, _ = roofline.polyphase_roundtrip(spec["config"], 8, 2_646_000)
    assert read_layer("pqmf_roofline.files", t) == pytest.approx(
        100 * bound / 25e-6)


def test_readers_find_nothing_in_an_empty_slice(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "bench.slice",
         "ts": 0.0, "dur": 100.0}]}))
    t = tracing.read_trace(path, 3)
    t.context = {"config": harness.load_cell("pqmf16.files")["config"],
                 "rows": 8, "block": 2_646_000, "window": window([1e-3])}
    for m in BENCH["per_layer"]:
        assert read_layer(m["name"], t) is None, m["name"]


def test_audio_repeats_for_a_seed_and_differs_across():
    a = audio.rows(3, 4096, 2**31 + 5, 44100, "cpu")
    b = audio.rows(3, 4096, 2**31 + 5, 44100, "cpu")
    c = audio.rows(3, 4096, 2**31 + 6, 44100, "cpu")
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)
    rms = a.pow(2).mean(-1).sqrt()
    assert torch.allclose(rms, torch.full_like(rms, 0.1), rtol=1e-3)


def test_pool_is_consecutive_blocks_of_each_row():
    p = audio.pool(2, 1024, 3, 9, 44100, "cpu", "host")
    whole = audio.rows(2, 3 * 1024, 9, 44100, "cpu")
    assert torch.equal(torch.cat(p, dim=1), whole)
    assert all(t.is_contiguous() and t.device.type == "cpu" for t in p)


def test_reservoir_is_uniform_and_seeded():
    counts = [0] * 10
    for seed in range(2000):
        r = harness.Reservoir(2, seed)
        for i in range(10):
            r.offer(i)
        for i in r.items:
            counts[i] += 1
    assert min(counts) > 300 and max(counts) < 500
    a, b = harness.Reservoir(3, 7), harness.Reservoir(3, 7)
    for i in range(100):
        a.offer(i)
        b.offer(i)
    assert a.items == b.items
