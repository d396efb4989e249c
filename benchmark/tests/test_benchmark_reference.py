"""The plain reference held against ``pqmf_tpu_torch`` on the CPU, at small
sizes and on seeded audio: the bank's design, the cached analysis and
synthesis, the offline polyphase round trip, and the flagship's pitch
shift with its tail carried from block to block. Only this test imports
both sides; the reference itself imports nothing of the port."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import audio
from benchmark.reference import bank, pitch_shift

SR = 44100
TOL = 1e-5  # the f32 gap of two summation orders, well under the control's


def rel(a, b) -> float:
    return float((a.reshape(-1) - b.reshape(-1)).norm() / b.norm())


@pytest.mark.parametrize("M", [2, 4, 8, 16, 32])
def test_design_matches_port(M):
    from pqmf_tpu_torch.ops.filterbank import build_filterbank

    ours = bank.design(100, M)
    port = build_filterbank(100, M)["hk"]
    assert ours.shape == port.shape
    np.testing.assert_allclose(ours, port, rtol=0, atol=1e-7)


def test_design_is_rave_geometry():
    hk = bank.design(100, 16)
    assert hk.shape == (16, 512) and hk.dtype == np.float32
    assert bank.design(100, 16) is not bank.design(100, 16)  # copies


@pytest.mark.parametrize("T", [512, 8192])
def test_cached_forms_match_port(T):
    from pqmf_tpu_torch.streaming import StreamingPQMF

    x = audio.rows(3, T, 11, SR, "cpu")
    pq = StreamingPQMF(100, 16, device="cpu")
    hk = bank.design(100, 16)
    sub = bank.analysis(x, hk)
    assert rel(pq.forward(x[:, None]), sub) < TOL
    assert rel(pq.inverse(sub)[:, 0], bank.synthesis(sub, hk)) < TOL


def test_polyphase_roundtrip_matches_port():
    from pqmf_tpu_torch import PQMF

    x = audio.rows(2, 16 * 4096, 12, SR, "cpu")
    y = PQMF(100, 16, device="cpu").roundtrip(x[:, None])[:, 0]
    r = bank.polyphase_roundtrip(x, bank.design(100, 16))
    assert y.shape == r.shape
    assert rel(y, r) < TOL


@pytest.mark.parametrize("m_buffer_size", [2048, 4096, 8192, 16384])
def test_geometry_matches_wrapper(m_buffer_size):
    from pqmf_tpu_torch.pipelines import derive_stft_geometry

    win, hop, n_fft, overlap = derive_stft_geometry(m_buffer_size, 16)
    assert pitch_shift.geometry(m_buffer_size, 16) == {
        "win": win, "hop": hop, "n_fft": n_fft, "crossfade": overlap}


def test_pitch_shift_streams_match_port():
    """Three streams over four blocks, the tail carried by the program and
    rebuilt by the reference from each stream's previous block."""
    from pqmf_tpu_torch.pipelines import PQMFPitchShiftWrapper

    w = PQMFPitchShiftWrapper(100, 16, 8192, device="cpu")
    hk = bank.design(100, 16)
    geo = pitch_shift.geometry(8192, 16)
    x = audio.rows(3, 4 * 8192, 13, SR, "cpu")
    blocks = [x[:, i * 8192:(i + 1) * 8192] for i in range(4)]
    state = w.init_streams(3)
    for i, b in enumerate(blocks):
        state, y = w.pitchshift_streams(state, b)
        r = pitch_shift.step(b, blocks[i - 1] if i else None, hk, w.shifts,
                             geo)
        for s in range(3):
            assert rel(y[s], r[s]) < TOL, (i, s)


def test_pitch_shift_live_matches_port():
    from pqmf_tpu_torch.pipelines import PQMFPitchShiftWrapper

    w = PQMFPitchShiftWrapper(100, 16, 8192, device="cpu")
    hk = bank.design(100, 16)
    geo = pitch_shift.geometry(8192, 16)
    x = audio.rows(1, 3 * 8192, 14, SR, "cpu")
    blocks = [x[:, i * 8192:(i + 1) * 8192] for i in range(3)]
    state = w.init_state()
    for i, b in enumerate(blocks):
        state, y = w.pitchshift_fn(state, b)
        r = pitch_shift.step(b, blocks[i - 1] if i else None, hk, w.shifts,
                             geo)
        assert rel(y, r) < TOL, i


def test_carried_tail_matters():
    """The reference's first-block output differs from a later block's on
    the same input: the tail is part of the answer. Only by ~2e-3 here:
    the band's first and last samples fall in the stretch's zero padding,
    so the blend mixes small values; still 100 times the program's gap."""
    hk = bank.design(100, 16)
    geo = pitch_shift.geometry(8192, 16)
    x = audio.rows(1, 2 * 8192, 15, SR, "cpu")
    a, b = x[:, :8192], x[:, 8192:]
    shifts = list(range(16))
    assert rel(pitch_shift.step(b, None, hk, shifts, geo),
               pitch_shift.step(b, a, hk, shifts, geo)) > 1e-4


def test_tf32_rounding():
    v = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      1.0 + 2 ** -10 + 2 ** -23])
    assert bank.to_tf32(v).tolist() == [1.0, 1.0, 1.0 + 2 ** -9,
                                        1.0 + 2 ** -10]


def test_control_is_far():
    hk = bank.design(100, 16)
    x = audio.rows(2, 8192, 16, SR, "cpu")
    r = bank.polyphase_roundtrip(x, hk)
    c = bank.polyphase_roundtrip(x, hk, tf32=True)
    assert rel(c, r) > 1e-4
