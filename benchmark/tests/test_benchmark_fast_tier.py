"""The fast-serving cell ``pvoc16_fast.streams`` against the benchmark's
contract, on the CPU: its entries load and their files resolve, its
configuration is ``pvoc16``'s at ``precision="default"`` with the tier
written down, its reference loads nothing of the port nor of JAX, the two
roofline readers count the work from the shapes, and a small run is
correct while the control and the port one tier up are not."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import harness, roofline_tier, tracing

CELL = "pvoc16_fast.streams"
BENCH = harness.manifest()
# 16 streams of a pool of 3: a run's 48 distinct blocks give rel_err_p95 a
# percentile's meaning (the cell keeps ~900)
SMALL = {"rows": 16, "pool": 3, "warmup": 3}
NEW_METRICS = ("idle_share.fast", "middle_ms.fast", "tc_roofline.fast",
               "middle_roofline.fast")


def config(name):
    entry = {c["name"]: c for c in BENCH["configs"]}[name]
    return json.loads((harness.REPO / entry["file"]).read_text())


def test_cell_loads_with_its_metrics():
    spec = harness.load_cell(CELL)
    assert spec["cell"]["chips"] == 1 and spec["cell"]["traffic"] == "streams"
    assert spec["system"].__file__.endswith(
        "systems/pitch_shifter_fast.streams.py")
    assert callable(spec["system"].build) and callable(spec["system"].check)
    assert [m["name"] for m in spec["end_to_end"]] == ["audio_rtf.streams",
                                                       "setup_s"]
    assert [m["name"] for m in spec["per_layer"]] == list(NEW_METRICS)
    for name, family in zip(NEW_METRICS, ("idle_share", "middle_ms",
                                          "tc_roofline", "middle_roofline")):
        assert harness.reader("metrics", name).__file__.endswith(
            f"metrics/{family}.py")


def test_config_is_pvoc16_at_the_tier():
    fast, base = config("pvoc16_fast"), config("pvoc16")
    changed = {"name", "system", "source", "what", "precision", "tier",
               "guarantees", "check"}
    assert set(fast) == set(base) | {"tier"}
    assert {k: v for k, v in fast.items() if k not in changed} == {
        k: v for k, v in base.items() if k not in changed}
    assert fast["precision"] == "default" and fast["reduced"] == []
    assert set(fast["tier"]) == {"rounding", "analysis", "stft", "istft",
                                 "synthesis", "float32"}
    assert set(fast["check"]["numbers"]) == set(base["check"]["numbers"])


def test_reference_loads_nothing_of_the_port():
    code = (
        "import sys, json\nsys.path.insert(0, '.')\n"
        "from benchmark import audio\n"
        "from benchmark.reference import bank, pitch_shift_bf16 as pb\n"
        "x = audio.rows(1, 2048, 1, 44100, 'cpu')\n"
        "pb.step(x, x, bank.design(100, 16), list(range(16)), "
        "pb.geometry(2048, 16), 'control')\n"
        "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.REPO,
                         capture_output=True, text=True, check=True,
                         timeout=300)
    mods = {m.split(".")[0] for m in json.loads(out.stdout.splitlines()[-1])}
    assert not mods & (set(harness.FORBIDDEN) | {"pqmf_tpu_torch"})


def test_roofline_hand_counts():
    """128 streams of 8192 at 16 bands, a bank of 512 taps: K1t + K2t
    2 x 128 x 8192 x 512 multiply-adds; the products over 5 frames a band
    and the 120 output frames of shifts 0-15 (PERF.md section 3's 13.47
    GFLOP), 514 = 2F columns."""
    cfg = config("pvoc16_fast")
    assert roofline_tier.conv_pair_work(128, 8192, 16, 512) == (
        2 * 2 * 128 * 8192 * 512, 4 * (4 * 128 * 8192 + 2 * 16 * 512))
    frames, fo = roofline_tier.stretch_frames(cfg, 8192)
    assert frames == 5 and sum(fo) == 120 and fo[0] == 5 and fo[-1] == 11
    flop, nbytes = roofline_tier.dft_products_work(128, 16, frames, fo, 512)
    assert flop == 2 * (128 * 16 * 5 + 128 * 120) * 512 * 514 \
        == 13_474_201_600
    assert nbytes == 4 * ((10240 + 15360) * (512 + 514) + 2 * 512 * 514)
    for bound in (roofline_tier.conv_pair(cfg, 128, 8192),
                  roofline_tier.dft_products(cfg, 128, 8192)):
        assert bound[1] == "bytes"
    assert roofline_tier.dft_products(cfg, 128, 8192)[0] == pytest.approx(
        nbytes / 3.35e12)


def trace(tmp_path, kernels):
    """A slice of 2 calls with the kernels [(name, us)] back to back."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.slice",
           "ts": 0.0, "dur": 1000.0}]
    ts = 0.0
    for name, us in kernels:
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                   "dur": us})
        ts += us
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    t = tracing.read_trace(path, 2)
    t.context = {"config": config("pvoc16_fast"), "rows": 128,
                 "block": 8192}
    return t


def read(name, t):
    return harness.reader("metrics", name).read(t)


def test_roofline_readers(tmp_path):
    cfg = config("pvoc16_fast")
    t = trace(tmp_path, [
        ("void (anonymous namespace)::conv_tc_kernel<1, 2, 1, 0, 1>()", 40.0),
        ("void (anonymous namespace)::roundtrip_tc_kernel<1, 2>()", 7.0),
        ("void (anonymous namespace)::pv_spectral_kernel<false>()", 60.0),
        ("cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>",
         140.0)])
    conv_s = roofline_tier.conv_pair(cfg, 128, 8192)[0]
    # 40 us of conv_tc_kernel over 2 calls; the round trip is not K1t/K2t
    assert read("tc_roofline.fast", t) == pytest.approx(
        100 * conv_s / 20e-6)
    middle_s = roofline_tier.dft_products(cfg, 128, 8192)[0]
    assert read("middle_roofline.fast", t) == pytest.approx(
        100 * middle_s / 100e-6)
    assert read("middle_ms.fast", t) == pytest.approx(0.1)


def test_readers_find_nothing_without_their_kernels(tmp_path):
    """A ``highest`` step runs K1/K2: no tier share, a middle share still;
    an empty slice has neither."""
    t = trace(tmp_path, [
        ("void (anonymous namespace)::analysis_kernel<8>()", 5.0),
        ("void (anonymous namespace)::pv_frame_kernel()", 5.0)])
    assert read("tc_roofline.fast", t) is None
    assert read("middle_roofline.fast", t) is not None
    t = trace(tmp_path, [])
    for name in NEW_METRICS:
        assert read(name, t) is None, name


def small_run(monkeypatch=None, precision=None):
    if precision is not None:
        load = harness.load_cell

        def load_at(name):
            spec = load(name)
            spec["config"] = {**spec["config"], "precision": precision}
            return spec

        monkeypatch.setattr(harness, "load_cell", load_at)
    return harness.run(CELL, 2**33 + 17, 1.0, False, "cpu",
                       traffic_update=SMALL)


def test_small_run_is_correct():
    r = small_run()
    assert r["correct"] and r["failed"] == 0, r["check"]
    assert r["attempted"] == r["window"]["calls"] * SMALL["rows"]
    assert set(r["metrics"]) == {"audio_rtf.streams", "setup_s"}


@pytest.mark.parametrize("precision", ["highest", "bf16x3"])
def test_the_port_at_another_tier_is_not_correct(precision, monkeypatch):
    r = small_run(monkeypatch, precision)
    assert not r["correct"] and r["failed"] > 0, r["check"]


def test_control_fails_stream_rel_err_max_by_ten_times():
    """The control fails every number, and ``stream_rel_err_max``, the one
    its readings and the program's lie furthest apart in, by more than ten
    times its limit."""
    spec = harness.load_cell(CELL)
    cfg, system = spec["config"], spec["system"]
    traffic = {**spec["traffic"], **SMALL}
    device = harness.device_of("cpu")
    prog = system.build(cfg, traffic, device)
    pool = harness.make_pool(prog, cfg, traffic, 2**31 + 3, device)
    g = harness.warm_up(prog, pool, traffic, device)
    _, _, kept = harness.measure(prog, pool, g, 0.2, traffic, 2**31 + 3,
                                 device)
    control = harness.judge(system, cfg, pool, kept, device, tf32=True)[0]
    for name, c in control.items():
        assert c["value"] > c["limit"], (name, control)
    c = control["stream_rel_err_max"]
    assert c["value"] > 10 * c["limit"], control
