"""The flagship at its fast-serving tier (``precision="default"``) against
the tier's plain reference (``benchmark/reference/pitch_shift_bf16.py``),
held to the limits of the benchmark cell ``pvoc16_fast.streams``, on the
CPU at small sizes on seeded audio: two blocks of three streams, so the
second block's crossfade reads the tail the first left, at the cell's
buffer of 8192 and at 2048. The program's pass is judged over sixteen
streams: ``rel_err_p95`` is a percentile, and over six blocks it would be
the worst block, which the phase rule's discontinuity can throw (PERF.md
section 6).

- the port at ``default`` passes the tier's check;
- the reference with its roundings off is the float32 reference;
- the port at ``highest`` and the control (the tier's reference with every
  product's result rounded to bf16 too) both fail it;
- ``cached_conv.KERNELS`` and ``ops.stft.ROUNDED`` read K1t/K2t and the
  DFT operands' roundings on a ``default`` step, K1/K2 and none at
  ``highest``, and a graph's replay adds what its capture counted.

``test_fast_step_on_card`` (marked ``cuda``, skips without a CUDA device)
profiles graphed steps on the card: the tier kernels and the middle's
three kernels run, K1/K2 and no plain stage do not, and the counters
agree with the trace. This file imports no JAX; on the card:
    python -m pytest --noconftest -m cuda tests/test_torch_fast_tier.py
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from benchmark import audio, harness, tracing
from benchmark.reference import bank, pitch_shift
from benchmark.reference import pitch_shift_bf16 as pb
from pqmf_tpu_torch import graphs
from pqmf_tpu_torch.kernels import cached_conv as cc
from pqmf_tpu_torch.ops import stft as S
from pqmf_tpu_torch.pipelines import PQMFPitchShiftWrapper

SR = 44100
STREAMS, BLOCKS = 3, 2
GEOMETRIES = [8192, 2048]
CONFIG = json.loads((Path(__file__).resolve().parents[1] / "benchmark"
                     / "configs" / "pvoc16_fast.json").read_text())
SHIFTS = CONFIG["shifts_in_semitones"]
# the float32 gap of two summation orders (test_benchmark_reference's TOL)
TOL = 1e-5


def rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def blocks(m_buffer_size: int, seed: int, streams: int = STREAMS) -> list:
    x = audio.rows(streams, BLOCKS * m_buffer_size, seed, SR, "cpu")
    return [x[:, i * m_buffer_size:(i + 1) * m_buffer_size]
            for i in range(BLOCKS)]


def port_outputs(m_buffer_size: int, precision: str, xs: list) -> list:
    w = PQMFPitchShiftWrapper(CONFIG["attenuation"], CONFIG["n_band"],
                              m_buffer_size, SR, SHIFTS, precision=precision,
                              phase_rule=CONFIG["phase_rule"], device="cpu")
    state, ys = w.init_streams(xs[0].shape[0]), []
    for x in xs:
        state, y = w.pitchshift_streams(state, x)
        ys.append(y)
    return ys


def reference_outputs(m_buffer_size: int, xs: list, rounding: str) -> list:
    hk = bank.design(CONFIG["attenuation"], CONFIG["n_band"])
    geo = pitch_shift.geometry(m_buffer_size, CONFIG["n_band"])
    return [pb.step(x, xs[i - 1] if i else None, hk, SHIFTS, geo, rounding)
            for i, x in enumerate(xs)]


def readings(ys: list, refs: list) -> dict:
    """The cell's numbers over these blocks (``pitch_shifter_fast.check``):
    the 95th percentile of every stream block's rel_err, and the worst
    stream's least block."""
    errs = [[rel(y[s], r[s]) for y, r in zip(ys, refs)]
            for s in range(refs[0].shape[0])]
    numbers = CONFIG["check"]["numbers"]
    return {
        "rel_err_p95": harness.percentile(
            [e for es in errs for e in es],
            numbers["rel_err_p95"]["percentile"]),
        "stream_rel_err_max": max(min(es) for es in errs)}


def limits() -> dict:
    return {n: c["limit"] for n, c in CONFIG["check"]["numbers"].items()}


@pytest.mark.parametrize("m_buffer_size", GEOMETRIES)
def test_port_passes_the_tier_check(m_buffer_size):
    xs = blocks(m_buffer_size, 2**31 + 21, streams=16)
    got = readings(port_outputs(m_buffer_size, "default", xs),
                   reference_outputs(m_buffer_size, xs, "tier"))
    for name, limit in limits().items():
        assert got[name] <= limit, (name, got)


@pytest.mark.parametrize("m_buffer_size", GEOMETRIES)
def test_rounding_off_is_the_f32_reference(m_buffer_size):
    xs = blocks(m_buffer_size, 2**31 + 22)
    hk = bank.design(CONFIG["attenuation"], CONFIG["n_band"])
    geo = pitch_shift.geometry(m_buffer_size, CONFIG["n_band"])
    for i, x in enumerate(xs):
        prev = xs[i - 1] if i else None
        assert rel(pb.step(x, prev, hk, SHIFTS, geo, "none"),
                   pitch_shift.step(x, prev, hk, SHIFTS, geo)) < TOL, i


@pytest.mark.parametrize("m_buffer_size", GEOMETRIES)
@pytest.mark.parametrize("other", ["highest", "control"])
def test_other_precisions_fail_the_tier_check(other, m_buffer_size):
    """The port one tier up, and a program one step below the tier, each
    fail every number of the check by more than three times its limit."""
    xs = blocks(m_buffer_size, 2**31 + 23)
    refs = reference_outputs(m_buffer_size, xs, "tier")
    ys = (port_outputs(m_buffer_size, "highest", xs) if other == "highest"
          else reference_outputs(m_buffer_size, xs, "control"))
    got = readings(ys, refs)
    for name, limit in limits().items():
        assert got[name] > 3 * limit, (name, got)


def test_rounding_is_nearest_even():
    v = torch.tensor([1.0, 1.0 + 2 ** -9, 1.0 + 3 * 2 ** -9,
                      1.0 + 2 ** -8 + 2 ** -23, -(1.0 + 3 * 2 ** -9)])
    assert pb.to_bf16(v).tolist() == [1.0, 1.0, 1.0 + 2 ** -7,
                                      1.0 + 2 ** -7, -(1.0 + 2 ** -7)]
    with pytest.raises(ValueError, match="rounding"):
        pb.step(v[None], None, bank.design(100, 16), SHIFTS,
                pitch_shift.geometry(8192, 16), "bf16")


# the step's counts: K1t + K2t, and the two products' operands (frames and
# basis, rows and inverse basis), by tier
COUNTS = {"default": ({"K1t": 1, "K2t": 1}, 4),
          "bf16x3": ({"K1t": 1, "K2t": 1}, 0),
          "highest": ({"K1": 1, "K2": 1}, 0)}


@pytest.mark.parametrize("precision", list(COUNTS))
def test_counters_read_the_tier(precision):
    x = blocks(2048, 2**31 + 24)[0]
    cc.reset_launches()
    S.reset_rounded()
    port_outputs(2048, precision, [x])
    kernels, operands = COUNTS[precision]
    assert cc.KERNELS == {**dict.fromkeys(cc.KERNELS, 0), **kernels}
    assert S.ROUNDED == {"operands": operands}
    assert sum(cc.LAUNCHES.values()) == 0  # no kernel launch on the CPU


def test_a_replay_adds_what_its_capture_counted(monkeypatch):
    """A graph's capture adds nothing to the tier counters and each replay
    adds what the captured step counted, as for the launch counters."""
    def capture(fn, args, device):
        return (lambda leaves, outs: None), fn(*args), {}

    monkeypatch.setattr(graphs, "_graphed", lambda device: True)
    monkeypatch.setattr(graphs, "_capture", capture)
    w = PQMFPitchShiftWrapper(100, 16, 2048, SR, SHIFTS, precision="default",
                              device="cpu")
    x = blocks(2048, 2**31 + 25)[0]
    cc.reset_launches()
    S.reset_rounded()
    state = w.init_streams(STREAMS)
    for step in (1, 2, 3):  # eager and captured, then two replays
        state, _ = w.pitchshift_streams(state, x)
        assert (cc.KERNELS["K1t"], cc.KERNELS["K2t"]) == (step, step)
        assert S.ROUNDED["operands"] == 4 * step
    prog = next(iter(w._graphs.values()))
    assert prog.launches == [dict.fromkeys(c, 0) for c in graphs._COUNTERS]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_fast_step_on_card(precision, tmp_path):
    """Graphed 128-stream steps of the cell on the card: at ``default``
    K1t/K2t (``conv_tc_kernel``) and at ``highest`` K1/K2, each once a
    step, the middle's three kernels once each, two products, and no
    plain stage (its dozens of elementwise kernels); the counters agree
    with the trace."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile, record_function

    w = PQMFPitchShiftWrapper(100, 16, 8192, SR, SHIFTS, precision=precision,
                              device="cuda")
    x = audio.rows(128, 8192, 2**31 + 26, SR, "cpu").numpy()
    state = w.init_streams(128)
    state, _ = w.pitchshift_streams(state, x)  # eager, then the capture
    steps = 4
    cc.reset_launches()
    S.reset_rounded()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("bench.slice"):
            for _ in range(steps):
                state, y = w.pitchshift_streams(state, x)
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    t = tracing.read_trace(tmp_path / "trace.json", steps)
    names = [name for name, cat, _ in t.ops if cat == "kernel"]

    def n(part):
        return sum(part in k for k in names)

    tc = precision == "default"
    assert n("conv_tc_kernel") == (2 * steps if tc else 0), names
    assert n("analysis_kernel") == n("synthesis_kernel") == (
        0 if tc else steps), names
    for stage in ("pv_frame_kernel", "pv_spectral_kernel",
                  "pv_resynth_kernel"):
        assert n(stage) == steps, (stage, names)
    # a step: K1t/K2t or K1/K2, the three stages, the products (and the
    # roundings' casts at default); a plain stage would add dozens
    assert len(names) <= (24 if tc else 16) * steps, names
    want = ({"K1t": steps, "K2t": steps} if tc
            else {"K1": steps, "K2": steps})
    assert cc.KERNELS == {**dict.fromkeys(cc.KERNELS, 0), **want}
    assert S.ROUNDED["operands"] == (4 * steps if tc else 0)
    assert torch.isfinite(y).all()
