"""The 64-band fine-tuned bank's cell ``pqmf64.files`` against the
benchmark's contract, on the CPU: its entries load and their files
resolve, its configuration is ``pqmf16``'s with the committed bank named
and nothing cut, its reference loads nothing of the port nor of JAX, the
cluster kernel's roofline counts the work from the bank's own shapes, and
a small run is correct while the faults, the designed bank in the
program's place and the control are not."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import harness, roofline, tracing
from benchmark.reference import tuned_bank

CELL = "pqmf64.files"
BENCH = harness.manifest()
SMALL = {"rows": 2, "seconds_of_audio": 1, "warmup": 3}
NEW_METRICS = ("idle_share.files64", "entry_self_ms.files64",
               "cluster_roofline.files64")
T60 = 2_645_952  # 60 s at 44.1 kHz cut to a multiple of 64


def config(name):
    entry = {c["name"]: c for c in BENCH["configs"]}[name]
    return json.loads((harness.REPO / entry["file"]).read_text())


def test_cell_loads_with_its_metrics():
    spec = harness.load_cell(CELL)
    assert spec["cell"]["chips"] == 1 and spec["cell"]["traffic"] == "files"
    assert spec["traffic"] == harness.load_cell("pqmf16.files")["traffic"]
    assert spec["system"].__file__.endswith(
        "systems/filterbank_tuned.files.py")
    assert callable(spec["system"].build) and callable(spec["system"].check)
    assert [m["name"] for m in spec["end_to_end"]] == ["audio_rtf.files",
                                                       "setup_s"]
    assert [m["name"] for m in spec["per_layer"]] == list(NEW_METRICS)
    for name, family in zip(NEW_METRICS, ("idle_share", "entry_self_ms",
                                          "cluster_roofline")):
        assert harness.reader("metrics", name).__file__.endswith(
            f"metrics/{family}.py")


def test_config_is_pqmf16_with_the_committed_bank():
    new, base = config("pqmf64"), config("pqmf16")
    assert new["system"] == "filterbank_tuned" and new["reduced"] == []
    assert (new["n_band"], new["attenuation"], new["polyphase"],
            new["sample_rate"], new["precision"]) == (64, 100, True, 44100,
                                                      "highest")
    assert new["weights"] == "hk64_atten100_finetuned"
    assert tuned_bank.path(new["weights"]).is_file()
    assert new["guarantees"] == base["guarantees"]
    assert set(new["assumed"]) == {"deployment", "weights", "n_band"}
    assert new["check"]["numbers"].keys() == base["check"]["numbers"].keys()
    assert len(new["source"]) <= 200


def test_reference_loads_nothing_of_the_port():
    code = (
        "import sys, json\nsys.path.insert(0, '.')\n"
        "from benchmark import audio\n"
        "from benchmark.reference import bank, tuned_bank\n"
        "from benchmark.metrics import cluster_roofline\n"
        "x = audio.rows(1, 64 * 64, 1, 44100, 'cpu')\n"
        "bank.polyphase_roundtrip(x, tuned_bank.load("
        "'hk64_atten100_finetuned'), tf32=True)\n"
        "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.REPO,
                         capture_output=True, text=True, check=True,
                         timeout=300)
    mods = {m.split(".")[0] for m in json.loads(out.stdout.splitlines()[-1])}
    assert not mods & (set(harness.FORBIDDEN) | {"pqmf_tpu_torch"})


def test_roofline_hand_count_64_bands():
    """8 clips of 2,645,952 samples, 64 bands, 2048 taps (32 a phase):
    analysis and synthesis 8 x 2,645,952 x 64 x 32 FMAs each."""
    fma = 8 * T60 * 64 * 32
    assert fma == 43_351_277_568
    flop, nbytes = roofline.polyphase_roundtrip_work(8, T60, 64, 2048)
    assert flop == 2 * 2 * fma == 173_405_110_272
    assert nbytes == 4 * (2 * 8 * T60 + 2 * 64 * 64 * 32)
    seconds, bound = roofline.bound_seconds(flop, nbytes)
    assert bound == "operations"
    assert seconds == pytest.approx(2.588e-3, rel=1e-3)
    assert tuned_bank.load(config("pqmf64")["weights"]).shape == (64, 2048)


def trace(tmp_path, kernels, calls=2):
    """A slice of ``calls`` calls with the kernels [(name, us)] back to
    back."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.slice",
           "ts": 0.0, "dur": 100000.0}]
    ts = 0.0
    for name, us in kernels:
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                   "dur": us})
        ts += us
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    t = tracing.read_trace(path, calls)
    t.context = {"config": config("pqmf64"), "rows": 8, "block": T60}
    return t


def read(name, t):
    return harness.reader("metrics", name).read(t)


def test_cluster_roofline_reads_the_cluster_kernel(tmp_path):
    name = ("void (anonymous namespace)::roundtrip_cluster_kernel<64, 2, 8>"
            "(float const*, float const*, float const*, float*)")
    t = trace(tmp_path, [(name, 7400.0), (name, 7600.0),
                         ("void (anonymous namespace)::roundtrip_kernel<16>()",
                          1000.0)])
    bound_s = roofline.bound_seconds(
        *roofline.polyphase_roundtrip_work(8, T60, 64, 2048))[0]
    # 15 ms of the cluster kernel over 2 calls; M = 16's kernel is not read
    assert read("cluster_roofline.files64", t) == pytest.approx(
        100 * bound_s / 7.5e-3)
    assert 30 < read("cluster_roofline.files64", t) < 40


def test_readers_find_nothing_without_their_kernels(tmp_path):
    t = trace(tmp_path, [
        ("void (anonymous namespace)::roundtrip_kernel<16>()", 1000.0)])
    assert read("cluster_roofline.files64", t) is None
    t = trace(tmp_path, [])
    for name in NEW_METRICS:
        assert read(name, t) is None, name


def small_run(seed=2**31 + 99):
    return harness.run(CELL, seed, 0.3, False, "cpu", traffic_update=SMALL)


def test_small_run_is_correct():
    r = small_run()
    assert r["correct"] and r["failed"] == 0, r["check"]
    assert r["attempted"] == r["window"]["calls"] * SMALL["rows"]
    assert set(r["metrics"]) == {"audio_rtf.files", "setup_s"}


def designed_bank(monkeypatch):
    """The program keeps the designed bank: the install is skipped."""
    from benchmark.systems import filterbank_tuned

    monkeypatch.setattr(filterbank_tuned, "install", lambda pq, cfg: None)


def altered_answer(monkeypatch):
    from pqmf_tpu_torch import PQMF

    roundtrip = PQMF.roundtrip

    def bumped(self, x):
        y = roundtrip(self, x).clone()
        y[..., 0] += 1e-3
        return y

    monkeypatch.setattr(PQMF, "roundtrip", bumped)


def half_batch(monkeypatch):
    import torch

    from pqmf_tpu_torch import PQMF

    roundtrip = PQMF.roundtrip

    def half(self, x):
        y = roundtrip(self, x[:x.shape[0] // 2])
        return torch.cat([y, y[:x.shape[0] - y.shape[0]]])

    monkeypatch.setattr(PQMF, "roundtrip", half)


@pytest.mark.parametrize("fault", [designed_bank, altered_answer,
                                   half_batch],
                         ids=lambda f: f.__name__)
def test_fault_is_caught(fault, monkeypatch):
    fault(monkeypatch)
    r = small_run()
    assert not r["correct"] and r["failed"] > 0, r["check"]


@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**33 + 3])
def test_control_fails_and_program_passes(seed):
    """The reference at TF32 in the program's place fails the limit by
    more than three times; the program on the same answers passes."""
    spec = harness.load_cell(CELL)
    cfg, system = spec["config"], spec["system"]
    traffic = {**spec["traffic"], **SMALL}
    device = harness.device_of("cpu")
    prog = system.build(cfg, traffic, device)
    pool = harness.make_pool(prog, cfg, traffic, seed, device)
    g = harness.warm_up(prog, pool, traffic, device)
    _, _, kept = harness.measure(prog, pool, g, 0.2, traffic, seed, device)
    program = harness.judge(system, cfg, pool, kept, device)[0]
    control = harness.judge(system, cfg, pool, kept, device, tf32=True)[0]
    assert all(c["value"] <= c["limit"] for c in program.values()), program
    assert all(c["value"] > 3 * c["limit"] for c in control.values()), \
        control
