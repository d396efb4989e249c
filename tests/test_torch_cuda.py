"""pqmf_tpu_torch on the card: each CUDA kernel against its plain PyTorch
version, and the streaming path and flagship slice against the port on the
CPU. Every test is marked ``cuda`` and skips without a CUDA device.

This file imports no JAX (the card's machine has none), so it runs there
without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: K1/K2 atol=2e-5 / rtol=1e-4 (pqmf_tpu's kernel-vs-lax bar);
K3 against the plain composition atol=1e-5 (it sums the analysis taps
phase by phase, another order); K4/K5 against the polyphase formula 2e-5 / 1e-4
and K6 2e-5 / 1e-4 (another tap order again); the slice, the
torchaudio variant, the block harness's pitch stream and the standalone
shifters >= 90 dB. The tier kernels K1t/K2t/K3t (``precision="bf16x3"``
and ``"default"``) keep those bars against the plain versions at the same
tier, but for the ``default`` K3t: its f32 sub-bands are rounded to bf16
again, and where they differ from the plain version's by an f32 ulp one
such rounding can flip by a bf16 ulp, so its bound is one bf16 ulp of the
largest sub-band times the largest column sum of |w_syn| times M, with
all but ``chip_smoke.k3t_default_off(M)`` of the outputs inside the K3
bar (a flip reaches Ks*M outputs and happens on about 2^-15 of the mids,
so the share is lumpy on small calls and grows with M; each M's cap is
the largest share measured there with a margin, chip_smoke.py says which).
"""

import functools
import os
import sys

# The CPU reference of the card-against-CPU tests takes one code path on
# every host, as chip_smoke.py pins it: MKL's reproducible mode and ATen's
# AVX2 kernels, set before torch loads. On the card this module is the
# first to import torch (pytest --noconftest); where another module has
# imported it already, nothing is changed.
if "torch" not in sys.modules:
    os.environ.update({"MKL_CBWR": "COMPATIBLE",
                       "ATEN_CPU_CAPABILITY": "avx2"})

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from pqmf_tpu_torch import (PQMF, PQMFPitchShiftWrapper,  # noqa: E402
                            PQMFPitchShiftWrapperTA, PQMFWrapper,
                            StreamingPQMF, TorchaudioPitchShift, stream_ola)
from pqmf_tpu_torch.kernels import _build  # noqa: E402
from pqmf_tpu_torch.kernels import cached_conv as cc  # noqa: E402
from pqmf_tpu_torch.kernels import polyphase as pk  # noqa: E402
from pqmf_tpu_torch.ops import filterbank as fb  # noqa: E402
from pqmf_tpu_torch.utils.metrics import snr_db  # noqa: E402

pytestmark = pytest.mark.cuda

SHIFTS16 = [0, 4, -5, -12, 3, -7, 2, -3, 5, -9, 1, -1, -4, -6, -2, -24]
TOL = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bank(M, dev):
    pq = StreamingPQMF(100, M, device="cpu")
    return pq.hkf.to(dev), pq.hki.to(dev)


@pytest.mark.parametrize("M", [8, 16, 32])
@pytest.mark.parametrize("B,T_sub", [(1, 512), (16, 512), (3, 37)])
def test_kernels_match_plain(dev, M, B, T_sub):
    hkf, hki = _bank(M, dev)
    Ka, Ks = hkf.shape[-1], hki.shape[-1]
    g = torch.Generator().manual_seed(M * 100 + B)
    x = torch.randn(B, 1, M * T_sub + Ka - 1, generator=g).to(dev)
    for fuse in (True, False):
        torch.testing.assert_close(
            cc.strided_analysis_conv(x, hkf, M, fuse),
            cc.analysis_conv_plain(x, hkf, M, fuse), **TOL)
    sub = F.pad(cc.strided_analysis_conv(x, hkf, M), (Ks // 2, Ks // 2))
    for fuse, off in [(True, -(Ks // 2)), (True, -15), (True, 3),
                      (False, 0)]:
        torch.testing.assert_close(
            cc.dense_synthesis_conv(sub, hki, fuse, off),
            cc.synthesis_conv_plain(sub, hki, fuse, off), **TOL)
    if cc.fused_roundtrip_supported(M, Ka, Ks):
        for pad in [(Ks // 2, Ks // 2), (3, 0)]:
            torch.testing.assert_close(
                cc.fused_roundtrip_conv(x, hkf, hki, M, pad),
                cc.roundtrip_conv_plain(x, hkf, hki, M, pad),
                atol=1e-5, rtol=0)
    torch.cuda.synchronize()


def test_smem_gate_mirrors_the_source(dev):
    """The gates and the launch plans of kernels/cached_conv.py are the
    CUDA source's, on this card's SM count."""
    import ctypes

    lib = _build.load()
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = (ctypes.c_longlong * 8)()
    for M, Ka, Ks in [(8, 257, 17), (16, 513, 33), (32, 1025, 33),
                      (64, 2049, 33), (2, 65, 33), (16, 512, 32)]:
        for i, which in enumerate(("analysis", "synthesis", "roundtrip"), 1):
            assert lib.pqmf_smem_bytes(i, M, M, Ka, Ks) == \
                cc.smem_bytes(which, M, M, Ka, Ks), (which, M)
            mc = cc.max_clusters(M, Ka, Ks) if i == 3 and M >= 32 else 0
            for B, T_out in [(1, 37), (1, 512), (16, 512), (215, 256),
                             (3, 479), (1, 165376)]:
                assert lib.pqmf_launch_plan(i, B, M, M, Ka, Ks, T_out,
                                            n_sms, mc, plan) == 0
                assert tuple(plan) == cc.launch_plan(
                    which, B, M, M, Ka, Ks, T_out, n_sms=n_sms,
                    max_clusters=mc if mc else None), (which, M, B, T_out)
        # K1 over even band shards
        for Mb in {max(2, M // 2), min(6, M)}:
            assert lib.pqmf_smem_bytes(1, M, Mb, Ka, Ks) == \
                cc.smem_bytes("analysis", M, Mb, Ka, Ks), (M, Mb)
            for B, T_out in [(1, 512), (16, 512), (1, 165376)]:
                assert lib.pqmf_launch_plan(1, B, M, Mb, Ka, Ks, T_out,
                                            n_sms, 0, plan) == 0
                assert tuple(plan) == cc.launch_plan(
                    "analysis", B, M, Mb, Ka, Ks, T_out, n_sms=n_sms), \
                    (M, Mb, B, T_out)


def _tile(which, B, Ka, Ks, T_out):
    return cc.launch_plan(which, B, 16, 16, Ka, Ks, T_out)[4]


@pytest.mark.parametrize("B", [1, 16, 215])
@pytest.mark.parametrize("edge", [-1, 0, 1])
def test_k2_tile_boundaries(dev, B, edge):
    """K2 against its plain version at T_out one short of, at and one past
    a multiple of its tile, with an odd negative x_offset."""
    _, hki = _bank(16, dev)
    Ks = hki.shape[-1]
    tile = _tile("synthesis", B, 0, Ks, 512)
    for T_out in (tile + edge, 3 * tile + edge):
        if T_out < 1:
            continue
        g = torch.Generator().manual_seed(B * 10 + edge + 1)
        x = torch.randn(B, 16, T_out + Ks - 1, generator=g).to(dev)
        for off in (-15, -1, 0):
            torch.testing.assert_close(
                cc.dense_synthesis_conv(x, hki, True, off),
                cc.synthesis_conv_plain(x, hki, True, off), **TOL)
    torch.cuda.synchronize()


@pytest.mark.parametrize("B", [1, 3, 16])
@pytest.mark.parametrize("edge", [-1, 0, 1])
@pytest.mark.parametrize("K,pad", [(513, (256, 256)), (512, (256, 240)),
                                   (513, (0, 0)), (513, (7, 3))])
def test_k1_tile_boundaries(dev, B, edge, K, pad):
    """K1 against its plain version at T_out one short of, at and one past
    a multiple of its tile, for a small call (split phase sum) and a large
    one (persistent blocks), with the streaming bank (K = 513) and the
    offline polyphase bank (K = 512) and in-kernel pads."""
    if K == 513:
        w = _bank(16, dev)[0]
    else:
        hp = torch.tensor(fb.build_filterbank(100, 16)["hk_poly"])
        w = pk.analysis_weights(hp).to(dev)
    for t_probe in (512, 40000):
        tile = _tile("analysis", B, K, 0, t_probe)
        T_out = (t_probe // tile) * tile + edge
        g = torch.Generator().manual_seed(B * 10 + edge + 1 + t_probe)
        T = (T_out - 1) * 16 + K - pad[0] - pad[1] + 5
        x = torch.randn(B, 1, T, generator=g).to(dev)
        for fuse in (True, False):
            got = cc.strided_analysis_conv(x, w, 16, fuse, pad=pad)
            assert got.shape == (B, 16, T_out)
            torch.testing.assert_close(
                got, cc.analysis_conv_plain(x, w, 16, fuse, pad), **TOL)
    torch.cuda.synchronize()


@pytest.mark.parametrize("M,Mb,B,T_out", [(16, 16, 1, 512), (16, 16, 16, 512),
                                          (16, 16, 2, 40001), (16, 6, 3, 77),
                                          (64, 64, 1, 300), (8, 8, 1, 256)])
def test_k1_writes_every_output(dev, M, Mb, B, T_out):
    """K1 stores every output of its plan: the output's memory holds NaN
    before the call (the caching allocator hands the freed block back), and
    the result is finite and equals the plain version."""
    w = torch.randn(Mb, 1, 32 * M + 1, generator=torch.Generator().manual_seed(
        M + Mb)).to(dev) / (32 * M) ** 0.5
    K = w.shape[-1]
    x = torch.randn(B, 1, (T_out - 1) * M + K - 2 * M, device=dev)
    for _ in range(3):
        junk = torch.full((B, Mb, T_out), float("nan"), device=dev)
        del junk
        got = cc.strided_analysis_conv(x, w, M, True, pad=(M, M))
        assert torch.isfinite(got).all()
    torch.testing.assert_close(
        got, cc.analysis_conv_plain(x, w, M, True, (M, M)), **TOL)


@pytest.mark.parametrize("B", [1, 3, 215])
@pytest.mark.parametrize("edge", [-1, 0, 1])
@pytest.mark.parametrize("pad", [(16, 16), (3, 0), (0, 40), (16, 17)])
def test_k3_tile_boundaries(dev, B, edge, pad):
    """K3 against the plain composition at T_out one short of, at and one
    past its tile, with symmetric and lopsided synthesis pads."""
    hkf, hki = _bank(16, dev)
    Ka, Ks = hkf.shape[-1], hki.shape[-1]
    T_out = _tile("roundtrip", B, Ka, Ks, 1000) + edge
    T_ana = T_out - pad[0] - pad[1] + Ks - 1
    g = torch.Generator().manual_seed(B * 100 + edge + 7)
    x = torch.randn(B, 1, 16 * (T_ana - 1) + Ka + 5, generator=g).to(dev)
    got = cc.fused_roundtrip_conv(x, hkf, hki, 16, pad)
    assert got.shape == (B, T_out, 16)
    torch.testing.assert_close(got, cc.roundtrip_conv_plain(x, hkf, hki, 16,
                                                            pad),
                               atol=1e-5, rtol=0)
    torch.cuda.synchronize()


def test_streaming_routes_through_kernels(dev):
    gpu = StreamingPQMF(100, 16, device="cuda")
    cpu = StreamingPQMF(100, 16, device="cpu")
    x = np.random.default_rng(0).standard_normal((2, 1, 4096)).astype(
        np.float32)
    cc.reset_launches()
    got = gpu.roundtrip(x)
    back = gpu.inverse(gpu.forward(x))
    st, blocks = gpu.init_state(2), []
    for blk in np.split(x, 4, axis=-1):
        st, y = gpu.process_block(st, blk)
        blocks.append(y)
    torch.cuda.synchronize()
    assert cc.LAUNCHES == {"analysis": 5, "synthesis": 5, "roundtrip": 1}
    torch.testing.assert_close(got.cpu(), cpu.roundtrip(x), atol=1e-5,
                               rtol=0)
    torch.testing.assert_close(back.cpu(), cpu.inverse(cpu.forward(x)),
                               **TOL)
    cst, cblocks = cpu.init_state(2), []
    for blk in np.split(x, 4, axis=-1):
        cst, y = cpu.process_block(cst, blk)
        cblocks.append(y)
    torch.testing.assert_close(torch.cat(blocks, -1).cpu(),
                               torch.cat(cblocks, -1), **TOL)


def test_slice_matches_cpu(dev):
    gpu = PQMFPitchShiftWrapper(100, 16, 2048, 44100, SHIFTS16,
                                device="cuda")
    cpu = PQMFPitchShiftWrapper(100, 16, 2048, 44100, SHIFTS16, device="cpu")
    x = np.random.default_rng(1).standard_normal((1, 2 * 2048)).astype(
        np.float32) * 0.3
    gs, cs = gpu.init_state(), cpu.init_state()
    cc.reset_launches()
    for blk in np.split(x, 2, axis=-1):
        gs, gy = gpu.pitchshift_fn(gs, blk)
        cs, cy = cpu.pitchshift_fn(cs, blk)
        assert snr_db(cy.numpy(), gy.cpu().numpy()) >= 90
    assert snr_db(cs["prev_tail"].numpy(), gs["prev_tail"].cpu().numpy()) \
        >= 90
    assert cc.LAUNCHES == {"analysis": 2, "synthesis": 2, "roundtrip": 0}


def test_cuda_tensor_never_takes_the_plain_path(dev):
    """A CUDA tensor the kernel does not take raises; it is not handed to
    the plain version."""
    hkf, _ = _bank(16, dev)
    x = torch.zeros(1, 1, 9000, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        cc.strided_analysis_conv(x.as_strided((1, 1, 4000), (9000, 9000, 2)),
                                 hkf, 16)
    with pytest.raises(ValueError, match="is on"):
        cc.strided_analysis_conv(x, hkf.cpu(), 16)


@pytest.mark.parametrize("M", [4, 16, 32, 64])
@pytest.mark.parametrize("B,T_sub", [(1, 512), (16, 512), (3, 37)])
def test_polyphase_kernels_match_plain(dev, M, B, T_sub):
    """K4/K5/K6 on the card against their plain versions (the polyphase
    formula) — even kernel lengths, x_offset -(L//2-1), syn_pad (L//2,
    L//2), and at M=32/64 K1's band and K2's phase chunks with a short last
    chunk."""
    p = fb.build_filterbank(100, M)
    hp = torch.tensor(p["hk_poly"], device=dev)
    hi = torch.tensor(p["hk_ipoly"], device=dev)
    g = torch.Generator().manual_seed(M * 1000 + B)
    x = torch.randn(B, 1, M * T_sub, generator=g).to(dev)
    s = torch.randn(B, M, T_sub, generator=g).to(dev)
    torch.testing.assert_close(pk.polyphase_analysis(x, hp),
                               pk.polyphase_analysis_plain(x, hp), **TOL)
    torch.testing.assert_close(pk.polyphase_synthesis(s, hi),
                               pk.polyphase_synthesis_plain(s, hi), **TOL)
    L = hp.shape[-1]
    if pk.roundtrip_supported(M, L * M, L):
        torch.testing.assert_close(pk.polyphase_roundtrip(x, hp, hi),
                                   pk.polyphase_roundtrip_plain(x, hp, hi),
                                   **TOL)
    else:
        with pytest.raises(ValueError, match="shared memory"):
            pk.polyphase_roundtrip(x, hp, hi)
    torch.cuda.synchronize()


@pytest.mark.parametrize("M,rt", [(16, {"roundtrip": 1}),
                                  (32, {"roundtrip": 1}),
                                  (64, {"roundtrip": 1})])
def test_pqmf_routes_and_launch_counts(dev, M, rt):
    gpu, cpu = PQMF(100, M, device="cuda"), PQMF(100, M, device="cpu")
    x = np.random.default_rng(M).standard_normal((2, 1, M * 300)).astype(
        np.float32)
    zero = {"analysis": 0, "synthesis": 0, "roundtrip": 0}
    for name, arg, want in [("forward", x, {"analysis": 1}),
                            ("inverse", cpu.forward(x).numpy(),
                             {"synthesis": 1}),
                            ("roundtrip", x, rt)]:
        cc.reset_launches()
        pk.reset_launches()
        got = getattr(gpu, name)(arg)
        torch.cuda.synchronize()
        assert cc.LAUNCHES == {**zero, **want}, name
        assert pk.LAUNCHES == {**zero, **want}, name
        torch.testing.assert_close(got.cpu(), getattr(cpu, name)(arg),
                                   **TOL)


def test_offline_path_runs_no_plain_version(dev, monkeypatch):
    """Every plain version the offline path could reach raises: the CUDA
    path of PQMF (K6, and K4 + K5 at M=32), its classic path aside, and
    PQMFWrapper never call one."""
    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the CUDA path")

    for name in ("polyphase_analysis_plain", "polyphase_synthesis_plain",
                 "polyphase_roundtrip_plain"):
        monkeypatch.setattr(pk, name, refuse)
    for name in ("analysis_conv_plain", "synthesis_conv_plain",
                 "roundtrip_conv_plain"):
        monkeypatch.setattr(cc, name, refuse)
    for name in ("polyphase_forward", "polyphase_inverse", "_conv1d"):
        monkeypatch.setattr(fb, name, refuse)
    x = np.random.default_rng(5).standard_normal((1, 1, 8192)).astype(
        np.float32)
    for M in (16, 32):
        pq = PQMF(100, M, device="cuda")
        pq.inverse(pq.forward(x))
        pq.roundtrip(x)
    PQMFWrapper(100, 16, 8192, device="cuda").process(x)
    torch.cuda.synchronize()


def test_pqmf_refuses_a_bank_the_kernels_do_not_take(dev):
    pq = PQMF(100, 16, device="cuda")
    hk = np.random.default_rng(6).standard_normal((16, 16 * 4096)).astype(
        np.float32)
    with pytest.raises(ValueError, match="do not take"):
        pq.set_weights(fb.params_from_hk(hk))
    assert pq.params["hk"].shape == (16, 512)  # the old bank stays


def _refuse_plain(monkeypatch):
    """Make every plain conv version raise: a run after this shows the
    CUDA path never took one."""
    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the CUDA path")

    for name in ("analysis_conv_plain", "synthesis_conv_plain",
                 "roundtrip_conv_plain"):
        monkeypatch.setattr(cc, name, refuse)
    monkeypatch.setattr(fb, "_conv1d", refuse)


TA_SHIFTS8 = [0, -3, 5, 12, -7, 2, 1, -1]


@pytest.mark.parametrize("M,buf,shifts,B", [
    (16, 8192, [3.2, -48.5, 12.3, 0, 7, -24, 1, 2, 3, 4, 5, 6, -6, -12, 9,
                -30], 1),
    (16, 8192, None, 16),
    (8, 2048, TA_SHIFTS8, 2)])  # Tb = 256: K1/K2 at the M=8 bank
def test_ta_pitchshifter_on_kernels(dev, monkeypatch, M, buf, shifts, B):
    """One K1 and one K2 per pitchshifter call, one K1 per forward, one K2
    per inverse, no plain conv; >= 90 dB against the CPU port."""
    gpu = PQMFPitchShiftWrapperTA(100, M, buf, shifts_in_semitones=shifts,
                                  device="cuda")
    cpu = PQMFPitchShiftWrapperTA(100, M, buf, shifts_in_semitones=shifts,
                                  device="cpu")
    x = np.random.default_rng(M + B).standard_normal((B, 1, buf)).astype(
        np.float32) * 0.3
    want = cpu.pitchshifter(x).numpy()
    _refuse_plain(monkeypatch)
    cc.reset_launches()
    got = gpu.pitchshifter(x)
    sub = gpu.forward(x)
    back = gpu.inverse(sub)
    torch.cuda.synchronize()
    assert cc.LAUNCHES == {"analysis": 2, "synthesis": 2, "roundtrip": 0}
    assert got.shape == (B, 1, buf) and back.shape == (B, 1, buf)
    assert snr_db(want, got.cpu().numpy()) >= 90


@pytest.mark.parametrize("C", [1, 2])
def test_stream_ola_on_kernels(dev, monkeypatch, C):
    """One K1 + one K2 per block for the pitch stream, one K3 for all the
    round trips; no plain conv; pitch >= 90 dB and recon within 2e-5 of the
    CPU port."""
    gpu = PQMFPitchShiftWrapper(100, 16, 8192, 44100, SHIFTS16,
                                device="cuda")
    cpu = PQMFPitchShiftWrapper(100, 16, 8192, 44100, SHIFTS16, device="cpu")
    x = np.random.default_rng(C).standard_normal((C, 20000)).astype(
        np.float32) * 0.3
    c_pitch, c_recon = stream_ola(cpu, x, 4096, 2048)
    _refuse_plain(monkeypatch)
    cc.reset_launches()
    g_pitch, g_recon = stream_ola(gpu, x, 4096, 2048)
    torch.cuda.synchronize()
    n_blocks = -(-(20000 - 4096) // 2048) + 1
    assert cc.LAUNCHES == {"analysis": n_blocks, "synthesis": n_blocks,
                           "roundtrip": 1}
    assert g_pitch.device.type == "cuda" and g_pitch.shape == (C, 20000)
    assert snr_db(c_pitch.numpy(), g_pitch.cpu().numpy()) >= 90
    torch.testing.assert_close(g_recon.cpu(), c_recon, atol=2e-5, rtol=1e-4)


def test_standalone_shifter_on_card(dev):
    """The torchaudio shifter runs on the input's device, >= 90 dB against
    the CPU port (its running phase is float64 on both)."""
    x = np.random.default_rng(3).standard_normal((2, 5000)).astype(
        np.float32) * 0.3
    sh = TorchaudioPitchShift(2756, 7)
    got = sh(torch.from_numpy(x).to(dev))
    assert got.device.type == "cuda"
    assert snr_db(sh(x).numpy(), got.cpu().numpy()) >= 90


# ---------------------------------------------------------------------------
# the precision tiers: K1t, K2t, K3t (csrc/cached_conv_tc.cu)
# ---------------------------------------------------------------------------

TIERS = ("bf16x3", "default")
K3_TOL = dict(atol=1e-5, rtol=0.0)


@functools.lru_cache(maxsize=None)
def _k3t_default_off(M):
    """chip_smoke.py's cap on the share of default-tier K3t outputs past
    K3_TOL (one definition for the script and these tests)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.k3t_default_off(M)


def assert_k3t_close(got, ref, sub, w_syn, tier):
    """K3t against its plain version: K1t's and K2t's bar at bf16x3 (the
    f32 mid is split again, and where it differs from the plain version's
    by an f32 ulp the lo half's rounding moves by one of its ulps, 2^-17 of
    the mid, on about 2^-6 of the mids); at default the bound of a flipped
    bf16 rounding of the mid (module docstring)."""
    if tier == "bf16x3":
        torch.testing.assert_close(got, ref, **TOL)
        return
    M = w_syn.shape[0]
    ulp = 2.0 ** (torch.floor(torch.log2(sub.abs().max())).item() - 7)
    bound = ulp * w_syn.abs().sum(dim=(1, 2)).max().item() * M
    err = (got - ref).abs()
    assert err.max().item() <= bound + K3_TOL["atol"], (err.max(), bound)
    # all but chip_smoke.k3t_default_off(M) of the outputs within K3_TOL
    off = (err > K3_TOL["atol"]).float().mean().item()
    print(f"K3T_OFF M={M} shape={tuple(got.shape)} off={off:.6f}")
    assert off <= _k3t_default_off(M), (M, off)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("M", [2, 8, 16, 32, 64])
@pytest.mark.parametrize("B,T_sub", [(1, 512), (16, 512), (3, 37)])
def test_tier_kernels_match_plain(dev, tier, M, B, T_sub):
    hkf, hki = _bank(M, dev)
    Ka, Ks = hkf.shape[-1], hki.shape[-1]
    g = torch.Generator().manual_seed(M * 100 + B + len(tier))
    x = torch.randn(B, 1, M * T_sub + Ka - 1, generator=g).to(dev)
    for fuse in (True, False):
        torch.testing.assert_close(
            cc.strided_analysis_conv(x, hkf, M, fuse, mxu_precision=tier),
            cc.analysis_conv_plain(x, hkf, M, fuse, precision=tier), **TOL)
    sub = F.pad(cc.strided_analysis_conv(x, hkf, M), (Ks // 2, Ks // 2))
    for fuse, off in [(True, -(Ks // 2)), (True, -15), (True, 3),
                      (False, 0)]:
        torch.testing.assert_close(
            cc.dense_synthesis_conv(sub, hki, fuse, off, mxu_precision=tier),
            cc.synthesis_conv_plain(sub, hki, fuse, off, precision=tier),
            **TOL)
    if cc.fused_roundtrip_supported(M, Ka, Ks, tier):
        for pad in [(Ks // 2, Ks // 2), (3, 0)]:
            assert_k3t_close(
                cc.fused_roundtrip_conv(x, hkf, hki, M, pad, tier),
                cc.roundtrip_conv_plain(x, hkf, hki, M, pad, tier),
                sub, hki, tier)
    torch.cuda.synchronize()


def test_tier_plans_mirror_the_source(dev):
    import ctypes

    lib = _build.load()
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = (ctypes.c_longlong * 8)()
    for M, Ka, Ks in [(8, 257, 17), (16, 513, 33), (32, 1025, 33),
                      (64, 2049, 33), (2, 65, 33), (16, 512, 32),
                      (16, 9001, 600)]:
        for i, which in enumerate(("analysis", "synthesis", "roundtrip"), 1):
            for Mb, tier in [(Mb, tier) for Mb in (
                    {M, max(2, M // 2)} if i == 1 else {M})
                    for tier in ("bf16x3", "default")]:
                passes = {"bf16x3": 3, "default": 1}[tier]
                assert lib.pqmf_tc_smem_bytes(i, M, Mb, Ka, Ks, passes) == \
                    cc.smem_bytes(which, M, Mb, Ka, Ks, tier), (which, M)
                mc = cc.max_clusters(M, Ka, Ks, tier) \
                    if i == 3 and M >= 32 else 0
                for B, T_out in [(1, 37), (1, 512), (16, 512), (215, 256),
                                 (1, 165376)]:
                    assert lib.pqmf_tc_launch_plan(i, B, M, Mb, Ka, Ks,
                                                   T_out, n_sms, passes, mc,
                                                   plan) == 0
                    assert tuple(plan) == cc.launch_plan(
                        which, B, M, Mb, Ka, Ks, T_out, n_sms=n_sms,
                        precision=tier, max_clusters=mc if mc else None), \
                        (which, M, Mb, B, T_out, tier)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("B", [1, 3, 16])
@pytest.mark.parametrize("edge", [-1, 0, 1])
def test_tier_tile_boundaries(dev, tier, B, edge):
    """K1t and K2t at T_out one short of, at and one past a multiple of
    their 64-step tile (odd and even K, in-kernel pads, odd negative
    x_offset); K3t at a multiple of its tile near 1000 steps with lopsided
    synthesis pads."""
    hkf, hki = _bank(16, dev)
    Ka, Ks = hkf.shape[-1], hki.shape[-1]
    hp = torch.tensor(fb.build_filterbank(100, 16)["hk_poly"])
    w2 = pk.analysis_weights(hp).to(dev)
    g = torch.Generator().manual_seed(B * 10 + edge + 1)
    for w, pad in [(hkf, (256, 256)), (w2, (256, 240)), (hkf, (7, 3))]:
        K = w.shape[-1]
        for T_out in (64 + edge, 5 * 64 + edge):
            x = torch.randn(B, 1, (T_out - 1) * 16 + K - sum(pad) + 5,
                            generator=g).to(dev)
            got = cc.strided_analysis_conv(x, w, 16, True, pad, tier)
            assert got.shape == (B, 16, T_out)
            torch.testing.assert_close(
                got, cc.analysis_conv_plain(x, w, 16, True, pad, tier), **TOL)
    for T_out in (64 + edge, 3 * 64 + edge):
        x = torch.randn(B, 16, T_out + Ks - 1, generator=g).to(dev)
        for off in (-15, -16, 0):
            torch.testing.assert_close(
                cc.dense_synthesis_conv(x, hki, True, off, tier),
                cc.synthesis_conv_plain(x, hki, True, off, tier), **TOL)
    Tt = cc.launch_plan("roundtrip", B, 16, 16, Ka, Ks, 1000,
                        precision=tier)[4]
    for pad in [(16, 16), (3, 0), (0, 40)]:
        T_out = (1000 // Tt) * Tt + edge
        T_ana = T_out - pad[0] - pad[1] + Ks - 1
        x = torch.randn(B, 1, 16 * (T_ana - 1) + Ka + 5, generator=g).to(dev)
        got = cc.fused_roundtrip_conv(x, hkf, hki, 16, pad, tier)
        assert got.shape == (B, T_out, 16)
        assert_k3t_close(got, cc.roundtrip_conv_plain(x, hkf, hki, 16, pad,
                                                      tier),
                         cc.strided_analysis_conv(x, hkf, 16), hki, tier)
    torch.cuda.synchronize()


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("M,Mb,K,Ks", [(16, 16, 513, 33), (16, 6, 513, 33),
                                       (64, 64, 2049, 33), (2, 2, 65, 33),
                                       (16, 16, 9001, 600)])
def test_tier_kernels_write_every_output(dev, tier, M, Mb, K, Ks):
    """K1t/K2t/K3t store every output of their plan: the output memory
    holds NaN before each call, and the result is finite and equals the
    plain version. The last case stages its banks in chunks of the
    reduction (K1t/K2t) and a band shard (Mb=6) leaves a short chunk."""
    g = torch.Generator().manual_seed(M + Mb + K)
    # outputs of about unit size, as the designed banks give (the bars are
    # absolute): the gain M is undone in the synthesis bank
    wa = (torch.randn(Mb, 1, K, generator=g) / K ** 0.5).to(dev)
    ws = (torch.randn(M, Mb, Ks, generator=g) / (M * (Mb * Ks) ** 0.5)).to(
        dev)
    x = torch.randn(2, 1, 300 * M + K, generator=g).to(dev)
    s = torch.randn(2, Mb, 300 + Ks, generator=g).to(dev)
    for _ in range(3):
        junk = torch.full((2, 1 << 20), float("nan"), device=dev)
        del junk
        a = cc.strided_analysis_conv(x, wa, M, True, (M, M), tier)
        y = cc.dense_synthesis_conv(s, ws, True, -3, tier)
        assert torch.isfinite(a).all() and torch.isfinite(y).all()
    torch.testing.assert_close(
        a, cc.analysis_conv_plain(x, wa, M, True, (M, M), tier), **TOL)
    torch.testing.assert_close(
        y, cc.synthesis_conv_plain(s, ws, True, -3, tier), **TOL)
    if Mb == M and cc.fused_roundtrip_supported(M, K, Ks, tier):
        # a longer signal: the default tier's share of outputs that a
        # flipped mid reaches is a statistic of many mids
        x = torch.randn(2, 1, 1200 * M + K, generator=g).to(dev)
        for _ in range(3):
            junk = torch.full((2, 1 << 20), float("nan"), device=dev)
            del junk
            r = cc.fused_roundtrip_conv(x, wa, ws, M, (Ks // 2, Ks // 2),
                                        tier)
            assert torch.isfinite(r).all()
        assert_k3t_close(r, cc.roundtrip_conv_plain(
            x, wa, ws, M, (Ks // 2, Ks // 2), tier),
            cc.strided_analysis_conv(x, wa, M), ws, tier)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("M", [4, 16, 32, 64])
def test_tier_polyphase_kernels_match_plain(dev, tier, M):
    p = fb.build_filterbank(100, M)
    hp = torch.tensor(p["hk_poly"], device=dev)
    hi = torch.tensor(p["hk_ipoly"], device=dev)
    g = torch.Generator().manual_seed(M * 7)
    x = torch.randn(2, 1, M * 300, generator=g).to(dev)
    s = torch.randn(2, M, 300, generator=g).to(dev)
    torch.testing.assert_close(
        pk.polyphase_analysis(x, hp, mxu_precision=tier),
        pk.polyphase_analysis_plain(x, hp, tier), **TOL)
    torch.testing.assert_close(
        pk.polyphase_synthesis(s, hi, mxu_precision=tier),
        pk.polyphase_synthesis_plain(s, hi, tier), **TOL)
    L = hp.shape[-1]
    if pk.roundtrip_supported(M, L * M, L, tier):
        got = pk.polyphase_roundtrip(x, hp, hi, mxu_precision=tier)
        ref = pk.polyphase_roundtrip_plain(x, hp, hi, tier)
        if tier == "bf16x3":
            torch.testing.assert_close(got, ref, **TOL)
        else:
            assert_k3t_close(got, ref, pk.polyphase_analysis(x, hp), hi,
                             tier)
    torch.cuda.synchronize()


@pytest.mark.parametrize("tier", ["highest", *TIERS])
@pytest.mark.parametrize("M", [4, 16, 32])
def test_k4_without_mask_matches_plain(dev, tier, M):
    """K4 (K4t at a tier) with ``fuse_mask=False`` launches K1 (K1t) once
    without the sign mask: equal to the plain version without it, and not
    to the masked output."""
    p = fb.build_filterbank(100, M)
    hp = torch.tensor(p["hk_poly"], device=dev)
    g = torch.Generator().manual_seed(M * 11)
    x = torch.randn(2, 1, M * 300, generator=g).to(dev)
    cc.reset_launches()
    pk.reset_launches()
    got = pk.polyphase_analysis(x, hp, fuse_mask=False, mxu_precision=tier)
    torch.cuda.synchronize()
    assert cc.LAUNCHES["analysis"] == 1 and pk.LAUNCHES["analysis"] == 1
    torch.testing.assert_close(
        got, pk.polyphase_analysis_plain(x, hp, tier, fuse_mask=False),
        **TOL)
    assert not torch.equal(got, pk.polyphase_analysis(
        x, hp, mxu_precision=tier))


@pytest.mark.parametrize("tier", TIERS)
def test_tier_flagship_and_ta_on_kernels(dev, monkeypatch, tier):
    """The flagship and the TA wrapper at a tier: one K1t + one K2t per
    step, one K3t per round trip, no plain conv; >= 90 dB against the CPU
    port at the same tier."""
    gpu = PQMFPitchShiftWrapper(100, 16, 2048, 44100, SHIFTS16,
                                precision=tier, device="cuda")
    cpu = PQMFPitchShiftWrapper(100, 16, 2048, 44100, SHIFTS16,
                                precision=tier, device="cpu")
    ta = {d: PQMFPitchShiftWrapperTA(100, 8, 2048, precision=tier,
                                     shifts_in_semitones=TA_SHIFTS8,
                                     device=d) for d in ("cuda", "cpu")}
    x = np.random.default_rng(9).standard_normal((1, 2 * 2048)).astype(
        np.float32) * 0.3
    xt = x[None, :, :2048]
    c_y = [cpu.pitchshift_fn(cpu.init_state(), x[:, :2048])[1],
           cpu.forward_fn(x[:, :2048]), ta["cpu"].pitchshifter(xt)]
    _refuse_plain(monkeypatch)
    cc.reset_launches()
    g_y = [gpu.pitchshift_fn(gpu.init_state(), x[:, :2048])[1],
           gpu.forward_fn(x[:, :2048]), ta["cuda"].pitchshifter(xt)]
    torch.cuda.synchronize()
    assert cc.LAUNCHES == {"analysis": 2, "synthesis": 2, "roundtrip": 1}
    for c, g in zip(c_y, g_y):
        assert snr_db(c.numpy(), g.cpu().numpy()) >= 90


@pytest.mark.parametrize("tier", TIERS)
def test_tier_kernels_at_odd_strides(dev, tier):
    """K1t at stride M=1 and K2t over Mb=1 band load their A pairs 16 bits
    at a time (the other instance of the kernels)."""
    g = torch.Generator().manual_seed(3)
    w1 = torch.randn(2, 1, 31, generator=g).to(dev)
    x1 = torch.randn(2, 1, 500, generator=g).to(dev)
    torch.testing.assert_close(
        cc.strided_analysis_conv(x1, w1, 1, True, (5, 2), tier),
        cc.analysis_conv_plain(x1, w1, 1, True, (5, 2), tier), **TOL)
    ws = torch.randn(4, 1, 33, generator=g).to(dev)
    s = torch.randn(2, 1, 300, generator=g).to(dev)
    torch.testing.assert_close(
        cc.dense_synthesis_conv(s, ws, False, 0, tier),
        cc.synthesis_conv_plain(s, ws, False, 0, tier), **TOL)


# ---------------------------------------------------------------------------
# K1t/K2t redesigned: arranged banks, call-sized plans, K2's in-kernel pad
# ---------------------------------------------------------------------------


def test_cpu_reference_is_pinned(dev):
    """The card-against-CPU tests of this module hold the card against a CPU
    reference that takes one code path on every host."""
    assert os.environ.get("MKL_CBWR") == "COMPATIBLE"
    assert torch.backends.cpu.get_cpu_capability() == "AVX2"


def _nan_fill():
    junk = torch.full((1 << 22,), float("nan"), device="cuda")
    del junk


def _tier_bank(M, dev, g):
    """The designed banks at M >= 2; at M = 1 random ones of unit-size
    outputs (stride 1 and one input band: the kernels' 16-bit A loads)."""
    if M > 1:
        return _bank(M, dev)
    wa = (torch.randn(2, 1, 31, generator=g) / 31 ** 0.5).to(dev)
    ws = (torch.randn(4, 1, 33, generator=g) / (4 * 33 ** 0.5)).to(dev)
    return wa, ws


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("M", [1, 2, 4, 8, 16, 32, 64])
def test_tier_k1t_k2t_at_their_tiles(dev, tier, B, M):
    """K1t and K2t against their plain versions at T_out one short of, at
    and one past a multiple of the tile their plan takes, for a call of one
    host block (split reduction, one tile a block) and a whole file
    (persistent blocks), output memory NaN-filled before each call."""
    g = torch.Generator().manual_seed(M * 31 + B)
    wa, ws = _tier_bank(M, dev, g)
    Mb, Ka = wa.shape[0], wa.shape[-1]
    Ms, Ks = ws.shape[0], ws.shape[-1]
    S = max(M, 1)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for t_probe in (512, -(-n_sms * 256 // B) + 64):
        for which in ("analysis", "synthesis"):
            if which == "analysis":
                plan = cc.launch_plan(which, B, S, Mb, Ka, 0, t_probe,
                                      n_sms=n_sms, precision=tier)
            else:
                plan = cc.launch_plan(which, B, Ms, ws.shape[1], 0, Ks,
                                      t_probe, n_sms=n_sms, precision=tier)
            tile = plan[4]
            for edge in (-1, 0, 1):
                T_out = (t_probe // tile) * tile + edge
                if which == "analysis":
                    pad = (Ka // 2, Ka // 2)
                    x = torch.randn(B, 1, (T_out - 1) * S + 1, generator=g
                                    ).to(dev)
                    _nan_fill()
                    got = cc.strided_analysis_conv(x, wa, S, Mb % 2 == 0,
                                                   pad, tier)
                    ref = cc.analysis_conv_plain(x, wa, S, Mb % 2 == 0, pad,
                                                 tier)
                else:
                    pad = (Ks // 2, Ks // 2)
                    x = torch.randn(B, ws.shape[1], T_out, generator=g
                                    ).to(dev) / max(M, 1) ** 0.5
                    _nan_fill()
                    fuse = ws.shape[1] % 2 == 0
                    got = cc.dense_synthesis_conv(x, ws, fuse, 3, tier, pad)
                    ref = cc.synthesis_conv_plain(x, ws, fuse, 3, tier, pad)
                torch.cuda.synchronize()
                assert torch.isfinite(got).all(), (which, T_out)
                torch.testing.assert_close(got, ref, **TOL,
                                           msg=lambda m: f"{which} {T_out}")


@pytest.mark.parametrize("tier", TIERS)
def test_tier_kept_bank_is_bit_equal_to_one_arranged_per_call(dev, tier):
    hkf, hki = _bank(16, dev)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 1, 8192, generator=g).to(dev)
    s = torch.randn(2, 16, 512, generator=g).to(dev)
    ba = cc.arrange_tc_bank(hkf, "analysis", tier)
    bs = cc.arrange_tc_bank(hki, "synthesis", tier)
    for _ in range(2):
        _nan_fill()
        assert torch.equal(
            cc.strided_analysis_conv(x, hkf, 16, True, (256, 256), tier, ba),
            cc.strided_analysis_conv(x, hkf, 16, True, (256, 256), tier))
        _nan_fill()
        assert torch.equal(
            cc.dense_synthesis_conv(s, hki, True, 0, tier, (16, 16), bs),
            cc.dense_synthesis_conv(s, hki, True, 0, tier, (16, 16)))
    with pytest.raises(ValueError, match="arranged bank is for"):
        cc.dense_synthesis_conv(s, hki, True, 0, tier, (16, 16), ba)


@pytest.mark.parametrize("tier", TIERS)
def test_tier_output_follows_set_weights(dev, tier):
    """After set_weights the card reads the new arranged banks: its output
    equals the CPU port's with the new bank, and differs from the old."""
    from pqmf_tpu_torch.parallel.training import load_pretrained_bank

    ft = load_pretrained_bank("hk16_atten100_finetuned")
    x = np.random.default_rng(11).standard_normal((1, 1, 8192)).astype(
        np.float32) * 0.3
    for make in (lambda d: StreamingPQMF(100, 16, precision=tier, device=d),
                 lambda d: PQMF(100, 16, precision=tier, device=d)):
        gpu, cpu = make("cuda"), make("cpu")
        before = gpu.inverse(gpu.forward(x)).cpu()
        gpu.set_weights(ft)
        cpu.set_weights(ft)
        sub = gpu.forward(x)
        torch.testing.assert_close(sub.cpu(), cpu.forward(x), **TOL)
        after = gpu.inverse(sub).cpu()
        torch.testing.assert_close(after, cpu.inverse(sub.cpu()), **TOL)
        assert (after - before).abs().max().item() > 1e-3


@pytest.mark.parametrize("tier", ["highest", *TIERS])
@pytest.mark.parametrize("B,T", [(1, 512), (16, 512), (1, 165375)])
def test_k2_applies_its_pad_in_kernel(dev, tier, B, T):
    """K2 and K2t with the pad in the kernel's window copy (16-byte copies
    where the pad and the rows are multiples of 4, single floats where not)
    against their plain versions, output memory NaN-filled first."""
    _, hki = _bank(16, dev)
    g = torch.Generator().manual_seed(B + T)
    x = torch.randn(B, 16, T, generator=g).to(dev)
    for pad, off in [((16, 16), 0), ((15, 16), 0), ((32, 0), 3),
                     ((0, 7), -1)]:
        _nan_fill()
        got = cc.dense_synthesis_conv(x, hki, True, off, tier, pad)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        torch.testing.assert_close(
            got, cc.synthesis_conv_plain(x, hki, True, off, tier, pad), **TOL)


# ---------------------------------------------------------------------------
# K3t redesigned: kept arranged banks, call-sized plans, the analysis pad of
# K3/K3t in the kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("M", [2, 4, 8, 16])
def test_k3t_at_its_plans_tiles(dev, tier, B, M):
    """K3t against its plain version at T_out one short of, at and one past
    a multiple of the tile its plan takes, for a host block (tiles of 16-64
    steps, split reductions) and a whole file (persistent tiles), with the
    centered analysis pad in the kernel and the kept banks; output memory
    NaN-filled; kept and per-call banks give the same bits."""
    hkf, hki = _bank(M, dev)
    Ka, Ks = hkf.shape[-1], hki.shape[-1]
    pad, spad = (Ka // 2, Ka // 2), (Ks // 2, Ks // 2)
    kept = (cc.arrange_tc_bank(hkf, "analysis", tier),
            cc.arrange_tc_bank(hki, "synthesis", tier))
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator().manual_seed(M * 7 + B)
    for t_probe in (512, -(-n_sms * 256 // B) + 64):
        tile = cc.launch_plan("roundtrip", B, M, M, Ka, Ks, t_probe,
                              n_sms=n_sms, precision=tier)[4]
        for edge in (-1, 0, 1):
            T_out = (t_probe // tile) * tile + edge
            x = torch.randn(B, 1, M * T_out, generator=g).to(dev)
            _nan_fill()
            got = cc.fused_roundtrip_conv(x, hkf, hki, M, spad, tier, pad,
                                          kept)
            torch.cuda.synchronize()
            assert got.shape == (B, T_out, M) and torch.isfinite(got).all()
            assert_k3t_close(got, cc.roundtrip_conv_plain(
                x, hkf, hki, M, spad, tier, pad),
                cc.strided_analysis_conv(x, hkf, M, pad=pad), hki, tier)
            _nan_fill()
            assert torch.equal(got, cc.fused_roundtrip_conv(
                x, hkf, hki, M, spad, tier, pad))


@pytest.mark.parametrize("tier", ["highest", *TIERS])
@pytest.mark.parametrize("B,T", [(1, 8192), (16, 8192), (3, 16 * 777 + 5),
                                 (1, 60 * 44100)])
def test_roundtrip_applies_its_pad_in_kernel(dev, tier, B, T):
    """K3 and K3t with the analysis pad in their window copy (16-byte copies
    where the pad and the rows are multiples of 4, single floats where not)
    give the bits of F.pad and the call."""
    hkf, hki = _bank(16, dev)
    g = torch.Generator().manual_seed(B + T)
    x = torch.randn(B, 1, T, generator=g).to(dev)
    for pad, spad in [((256, 256), (16, 16)), ((13, 0), (15, 16)),
                      ((0, 7), (3, 0))]:
        _nan_fill()
        got = cc.fused_roundtrip_conv(x, hkf, hki, 16, spad, tier, pad)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert torch.equal(got, cc.fused_roundtrip_conv(
            F.pad(x, pad), hkf, hki, 16, spad, tier))


@pytest.mark.parametrize("tier", TIERS)
def test_entry_point_roundtrips_run_one_k3t(dev, tier):
    """StreamingPQMF.roundtrip and PQMF.roundtrip on the card: one K3t each
    (their kept banks and the analysis pad in the kernel), equal to the CPU
    port (the default tier's mid may flip: its bound)."""
    x = np.random.default_rng(12).standard_normal((2, 1, 16 * 700)).astype(
        np.float32) * 0.3
    for make in (lambda d: StreamingPQMF(100, 16, precision=tier, device=d),
                 lambda d: PQMF(100, 16, precision=tier, device=d)):
        gpu, cpu = make("cuda"), make("cpu")
        cc.reset_launches()
        got = gpu.roundtrip(x)
        torch.cuda.synchronize()
        assert cc.LAUNCHES == {"analysis": 0, "synthesis": 0, "roundtrip": 1}
        ref = cpu.roundtrip(x)
        sub = cpu.forward(x).reshape(2, 16, -1)
        w_syn = getattr(cpu, "hki", None)
        if w_syn is None:
            w_syn = cpu.params["hk_ipoly"]
        assert_k3t_close(got.cpu(), ref, sub, w_syn, tier)


# -- K3 and K3t at M = 32 and 64 (a thread-block cluster a tile) -----------


def _k3_bands_close(got, ref, x, hkf, hki, M, spad, tier, pad):
    torch.cuda.synchronize()
    assert got.shape == ref.shape and torch.isfinite(got).all()
    if tier == "highest":
        torch.testing.assert_close(got, ref, **TOL)
    else:
        assert_k3t_close(got, ref, cc.strided_analysis_conv(x, hkf, M,
                                                            pad=pad),
                         hki, tier)


@pytest.mark.parametrize("tier", ["highest", *TIERS])
@pytest.mark.parametrize("B", [1, 2, 3, 16])
@pytest.mark.parametrize("M", [32, 64])
def test_k3_bands_match_plain(dev, tier, B, M):
    """K3 and K3t at M = 32 and 64 (a thread-block cluster of M/8 blocks a
    tile) against their plain versions: a host block [B, 1, 8192 + Ka - 1]
    with the syn_pads chip_smoke.py uses, the 60 s signal with the
    centered pads in the kernel, and T_out one short of, at and one past a
    multiple of the tile the plan takes for a host block and for a whole
    file (B = 1, 2, 3, 16 take the cluster plans' 16-, 32- and 64-step
    tiles); output memory NaN-filled before each call. K3 within the K1/K2
    bar (its sums run in one thread, K1's and K2's order), K3t as
    ``assert_k3t_close``; the kept banks give the bits of banks arranged
    for the call."""
    hkf, hki = _bank(M, dev)
    Ka, Ks = hkf.shape[-1], hki.shape[-1]
    assert cc.fused_roundtrip_supported(M, Ka, Ks, tier)
    kept = None if tier == "highest" else (
        cc.arrange_tc_bank(hkf, "analysis", tier),
        cc.arrange_tc_bank(hki, "synthesis", tier))
    g = torch.Generator().manual_seed(M * 31 + B + len(tier))
    pad = (Ka // 2, Ka // 2)

    def check(x, spad, apad=(0, 0)):
        _nan_fill()
        got = cc.fused_roundtrip_conv(x, hkf, hki, M, spad, tier, apad, kept)
        _k3_bands_close(got, cc.roundtrip_conv_plain(x, hkf, hki, M, spad,
                                                     tier, apad),
                        x, hkf, hki, M, spad, tier, apad)
        return got

    x = torch.randn(B, 1, 8192 + Ka - 1, generator=g).to(dev)
    for spad in [(Ks // 2, Ks // 2), (3, 0), (0, 40)]:
        check(x, spad)
    check(torch.randn(B, 1, 60 * 44100, generator=g).to(dev),
          (Ks // 2, Ks // 2), pad)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for t_probe in (8192 // M, -(-n_sms * 256 // B) + 64):
        tile = cc.launch_plan("roundtrip", B, M, M, Ka, Ks, t_probe,
                              n_sms=n_sms, precision=tier)[4]
        for edge in (-1, 0, 1):
            T_out = (t_probe // tile) * tile + edge
            x = torch.randn(B, 1, M * T_out, generator=g).to(dev)
            got = check(x, (Ks // 2, Ks // 2), pad)
            if kept is not None:
                _nan_fill()
                assert torch.equal(got, cc.fused_roundtrip_conv(
                    x, hkf, hki, M, (Ks // 2, Ks // 2), tier, pad))


@pytest.mark.parametrize("tier", ["highest", *TIERS])
@pytest.mark.parametrize("M", [32, 64])
def test_k3_bands_entry_points_run_one_k3(dev, monkeypatch, tier, M):
    """``StreamingPQMF.roundtrip`` and ``PQMF.roundtrip`` with the committed
    fine-tuned bank of M = 32 and 64 on the card: exactly one K3 (K3t)
    launch each and no K1/K2, every plain version refused; equal to the
    CPU port."""
    from pqmf_tpu_torch.parallel.training import load_pretrained_bank

    bank = load_pretrained_bank(f"hk{M}_atten100_finetuned")
    x = np.random.default_rng(M).standard_normal((2, 1, M * 400)).astype(
        np.float32) * 0.3
    for make in (lambda d: StreamingPQMF(100, M, precision=tier, device=d),
                 lambda d: PQMF(100, M, precision=tier, device=d)):
        gpu, cpu = make("cuda"), make("cpu")
        gpu.set_weights(bank)
        cpu.set_weights(bank)
        ref = cpu.roundtrip(x)
        sub = cpu.forward(x).reshape(2, M, -1)
        w_syn = getattr(cpu, "hki", None)
        if w_syn is None:
            w_syn = cpu.params["hk_ipoly"]
        with monkeypatch.context() as mp:
            def refuse(*a, **k):
                raise AssertionError("a plain version ran on the card")

            for mod, names in ((cc, ("analysis_conv_plain",
                                     "synthesis_conv_plain",
                                     "roundtrip_conv_plain")),
                               (pk, ("polyphase_analysis_plain",
                                     "polyphase_synthesis_plain",
                                     "polyphase_roundtrip_plain")),
                               (fb, ("polyphase_forward",
                                     "polyphase_inverse", "_conv1d"))):
                for name in names:
                    mp.setattr(mod, name, refuse)
            cc.reset_launches()
            got = gpu.roundtrip(x)
            torch.cuda.synchronize()
            assert cc.LAUNCHES == {"analysis": 0, "synthesis": 0,
                                   "roundtrip": 1}
        if tier == "highest":
            torch.testing.assert_close(got.cpu(), ref, **TOL)
        else:
            assert_k3t_close(got.cpu(), ref, sub, w_syn, tier)


# -- fine-tuning (parallel/training.py) on the card ---------------------------


def _recipe_batch():
    hk = StreamingPQMF(100, 16, device="cpu").params["hk"]
    x = np.random.default_rng(0).standard_normal((4, 1, 8192)).astype(
        np.float32)
    return hk, torch.from_numpy(x)


@pytest.mark.parametrize("tier", ["highest", "bf16x3"])
def test_finetune_grad_matches_cpu(dev, tier):
    """One value_and_grad of the fine-tune loss at the recipe's full width
    (M=16, 512 taps, [4, 1, 8192]) on the card and on the pinned CPU port:
    the loss within 1e-4 relative, the gradient within 1e-3 of max|g| (the
    loss is the MSE of a residual about 1e-3 of the signal, so the two f32
    summation orders show amplified)."""
    from pqmf_tpu_torch.parallel import training as tt

    hk, x = _recipe_batch()
    loss_fn = tt.make_finetune_loss(16, 512)
    lc, gc = tt.loss_and_grad(loss_fn, hk, x, tier)
    lg, gg = tt.loss_and_grad(loss_fn, hk.to(dev), x.to(dev), tier)
    assert abs(lg.item() - lc.item()) <= 1e-4 * lc.item()
    err = (gg.cpu() - gc).abs().max() / gc.abs().max()
    assert err <= 1e-3, err.item()


def test_recipe_steps_match_cpu(dev):
    """20 steps of the committed recipe (cosine over 20 steps) on the card
    and on the CPU port, float32: the loss curve within 5e-3 relative a
    step. The first loss agrees to ~1e-5; after it Adam turns each
    gradient entry whose sign lies inside f32 rounding into a step of
    about one lr, which moves later losses by a few 1e-3 (an NVIDIA H100
    read 1.6e-3 at worst; JAX against the port on a CPU 2.1e-3)."""
    from pqmf_tpu_torch.parallel import training as tt

    kw = dict(steps=20, batch=4, length=8192, lr=2e-5, lr_schedule="cosine")
    _, lc = tt.finetune_filterbank(100, 16, device="cpu", **kw)
    _, lg = tt.finetune_filterbank(100, 16, device="cuda", **kw)
    rel = np.abs(lg - lc) / lc
    assert rel[0] <= 1e-4 and rel.max() <= 5e-3, rel


def test_recipe_steps_match_cpu_float64(dev):
    """The same 20 steps in float64 (make_train_step is dtype-generic):
    without f32 rounding to amplify, the card's path (cuDNN's forward and
    backward convs, the DFT matmuls, Adam) equals the CPU port's to 1e-10
    in every loss and in hk."""
    from pqmf_tpu_torch.parallel import training as tt

    hk = StreamingPQMF(100, 16, device="cpu").params["hk"].double()
    xs = np.random.default_rng(0).standard_normal((20, 4, 1, 8192))
    runs = []
    for d in ("cpu", "cuda"):
        init, step = tt.make_train_step(
            tt.adam(tt.cosine_decay_schedule(2e-5, 20)),
            loss_fn=tt.make_finetune_loss(16, 512), device=d)
        state = init(hk)
        losses = [step(state, x)[1].item() for x in xs]
        runs.append((np.array(losses), state.hk.detach().cpu().numpy()))
    (lc, hc), (lg, hg) = runs
    np.testing.assert_allclose(lg, lc, rtol=1e-10)
    np.testing.assert_allclose(hg, hc, rtol=0, atol=1e-10)


def test_train_step_leaves_tf32_flags_as_found(dev):
    """The step runs forward and backward in full f32 and restores cuDNN's
    and cuBLAS's TF32 settings, whatever they were."""
    from pqmf_tpu_torch.parallel import training as tt

    hk, x = _recipe_batch()
    init, step = tt.make_train_step(loss_fn=tt.make_finetune_loss(16, 512),
                                    device="cuda")
    state = init(hk)
    try:
        for flag in (True, False):
            torch.backends.cudnn.allow_tf32 = flag
            step(state, x.to(dev))
            torch.cuda.synchronize()
            assert torch.backends.cudnn.allow_tf32 is flag
            assert torch.get_float32_matmul_precision() == "highest"
        torch.set_float32_matmul_precision("high")
        step(state, x.to(dev))
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")


# -- the ahead-of-time artifact on the card -----------------------------------

TA_SHIFTS16 = [3.2, -48.5, 12.3, 0, 7, -24, 1, 2, 3, 4, 5, 6, -6, -12, 9,
               -30]


def _aot_wrapper(kind, tier):
    if kind == "flagship":
        return PQMFPitchShiftWrapper(100, 16, 8192, 44100, SHIFTS16,
                                     precision=tier, device="cuda")
    if kind == "ta":
        return PQMFPitchShiftWrapperTA(100, 16, 8192, 44100, TA_SHIFTS16,
                                       precision=tier, device="cuda")
    return PQMFWrapper(100, 16, 8192, precision=tier, device="cuda")


@pytest.mark.parametrize("tier", ["highest", *TIERS])
@pytest.mark.parametrize("kind", ["flagship", "ta", "plain"])
def test_aot_program_bit_equal_to_live(dev, tmp_path, kind, tier):
    """The reloaded torch.export program on the card equals the live
    wrapper bit for bit over two blocks (the flagship's tail carried),
    launching one K1 and one K2 a block and no plain version."""
    from pqmf_tpu_torch.export import load_stablehlo, save_artifact

    w = _aot_wrapper(kind, tier)
    program = load_stablehlo(save_artifact(w, str(tmp_path / "a"),
                                           with_stablehlo=True))
    g = torch.Generator().manual_seed(3)
    xs = [torch.randn(1, 1, 8192, generator=g).to(dev) * 0.3
          for _ in range(2)]
    tail_p = tail_l = w.init_state()["prev_tail"] if kind == "flagship" \
        else None
    got, want = [], []
    cc.reset_launches()
    for x in xs:
        if kind == "flagship":
            tail_p, y = program(tail_p, x[0])
            got.append(y)
        elif kind == "ta":
            got.append(program(x))
        else:
            got.extend(program(x))
    torch.cuda.synchronize()
    assert dict(cc.LAUNCHES) == {"analysis": 2, "synthesis": 2,
                                 "roundtrip": 0}
    # the first block ran the module eagerly, the second replayed its graph:
    # both equal the module run without a graph
    eager, tail_e = [], tail_l
    for x in xs:
        if kind == "flagship":
            tail_e, y = program.eager(tail_e, x[0])
            eager.append(y)
        elif kind == "ta":
            eager.append(program.eager(x))
        else:
            eager.extend(program.eager(x))
    _bit_equal(got, eager, f"AOT {kind} graph vs eager [{tier}]")
    for x in xs:
        if kind == "flagship":
            state, y = w.pitchshift_fn({"prev_tail": tail_l}, x[0])
            tail_l = state["prev_tail"]
            want.append(y)
        elif kind == "ta":
            want.append(w.pitchshifter(x))
        else:
            want.extend(w.process(x))
    if kind == "flagship":
        got.append(tail_p)
        want.append(tail_l)
    for a, b in zip(got, want):
        assert a.is_cuda and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("tier", ["highest", *TIERS])
def test_operators_launch_and_count(dev, tier):
    """The kernel operators called directly on CUDA tensors launch the
    kernel of their tier (one count each) and equal the public
    functions."""
    hkf, hki = _bank(16, dev)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(1, 1, 8192, generator=g).to(dev)
    sub = torch.randn(1, 16, 512, generator=g).to(dev)
    banks = ((None, None) if tier == "highest" else
             (cc.arrange_tc_bank(hkf, "analysis", tier).words,
              cc.arrange_tc_bank(hki, "synthesis", tier).words))
    cc.reset_launches()
    a = cc.OPS.analysis_conv.default(x, hkf, banks[0], 16, True, 256, 256,
                                     tier)
    s = cc.OPS.synthesis_conv.default(sub, hki, banks[1], True, 0, 16, 16,
                                      tier)
    r = cc.OPS.roundtrip_conv.default(x, hkf, hki, *banks, 16, 256, 256, 16,
                                      16, tier)
    torch.cuda.synchronize()
    assert dict(cc.LAUNCHES) == {"analysis": 1, "synthesis": 1,
                                 "roundtrip": 1}
    assert torch.equal(a, cc.strided_analysis_conv(
        x, hkf, 16, pad=(256, 256), mxu_precision=tier))
    assert torch.equal(s, cc.dense_synthesis_conv(
        sub, hki, pad=(16, 16), mxu_precision=tier))
    assert torch.equal(r, cc.fused_roundtrip_conv(
        x, hkf, hki, 16, (16, 16), tier, pad=(256, 256)))


@pytest.mark.parametrize("kind", ["flagship", "ta", "plain"])
def test_aot_program_checks_its_arguments(dev, tmp_path, kind):
    """On the card the reloaded program refuses a float64 block (the
    kernels would read its bytes as f32) and copies a strided one (one
    channel of interleaved stereo) contiguous before K1 reads it: the
    output equals the live wrapper's bit for bit."""
    from pqmf_tpu_torch.export import load_stablehlo, save_artifact

    w = _aot_wrapper(kind, "highest")
    program = load_stablehlo(save_artifact(w, str(tmp_path / "a"),
                                           with_stablehlo=True))
    g = torch.Generator().manual_seed(6)
    stereo = (torch.randn(8192, 2, generator=g) * 0.3).to(dev)
    x = stereo[:, 0][None]
    assert not x.is_contiguous()
    head = (w.init_state()["prev_tail"],) if kind == "flagship" else ()
    as_arg = (lambda t: t) if kind == "flagship" else (lambda t: t[None])
    cc.reset_launches()
    with pytest.raises(ValueError, match="float64"):
        program(*head, as_arg(x.double()))
    assert dict(cc.LAUNCHES) == {"analysis": 0, "synthesis": 0,
                                 "roundtrip": 0}
    got = program(*head, as_arg(x))
    if kind == "flagship":
        want = w.pitchshift_fn({"prev_tail": head[0]}, x.contiguous())
    elif kind == "ta":
        want = w.pitchshifter(as_arg(x.contiguous()))
    else:
        want = w.process(as_arg(x.contiguous()))
    for a, b in zip(*(o if isinstance(o, tuple) else (o,)
                      for o in (got, want))):
        b = b["prev_tail"] if isinstance(b, dict) else b
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["x float64", "x strided", "w on the cpu",
                                  "bank shape", "no bank"])
def test_operators_refuse_bad_operands_on_the_card(dev, case):
    """The CUDA impls check the operands they take pointers of: a float64,
    strided or misplaced operand, or a tier bank of the wrong shape or
    none, raises before any launch."""
    hkf, _ = _bank(16, dev)
    x = torch.zeros((1, 1, 8192), device=dev)
    words = cc.arrange_tc_bank(hkf, "analysis", "bf16x3").words
    args = {"x float64": (x.double(), hkf, words),
            "x strided": (torch.zeros((1, 8192, 2), device=dev)[..., 0]
                          [:, None], hkf, words),
            "w on the cpu": (x, hkf.cpu(), words),
            "bank shape": (x, hkf, words[:1]),
            "no bank": (x, hkf, None)}[case]
    cc.reset_launches()
    with pytest.raises(ValueError):
        cc.OPS.analysis_conv.default(*args, 16, True, 256, 256, "bf16x3")
    assert cc.LAUNCHES["analysis"] == 0


def test_gpu_checks_pass(dev):
    """``tools/gpu_checks.py`` (the checks chip_smoke.py does not make)
    ends in ALL PASS and exits 0 on the card. Its lines are printed (``-rP``
    shows them): this test is the script's one run in a card call."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "tools/gpu_checks.py"], cwd=root,
                         capture_output=True, text=True, timeout=900)
    print(res.stdout)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert res.stdout.rstrip().endswith("ALL PASS")


# ---------------------------------------------------------------------------
# CUDA graphs (pqmf_tpu_torch/graphs.py): every graphed entry against the
# eager body it captures. The graph replays the same launches on the same
# inputs, so the bar is bit equality; a difference fails with its size.
# ---------------------------------------------------------------------------


def _bit_equal(got, want, what):
    for g, e in zip(got, want):
        assert torch.equal(g, e), \
            f"{what}: graph - eager = {(g - e).abs().max().item()}"


def _flagship16(tier, dev):
    return PQMFPitchShiftWrapper(100, 16, 8192, 44100, SHIFTS16,
                                 precision=tier, device="cuda")


def _blocks(dev, n, seed, B=None):
    shape = (n, 1, 8192) if B is None else (n, B, 1, 8192)
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 0.3
    return list(torch.from_numpy(x).to(dev))


@pytest.mark.parametrize("tier", ["highest", *TIERS])
@pytest.mark.parametrize("B", [1, 16])
def test_graph_pitchshift_fn_equals_eager(dev, tier, B):
    """8 blocks, the tail carried: the graphs' outputs and tails equal the
    eager body's bit for bit, none changes after a later call, and each
    step launches one K1 + one K2 (the capture none)."""
    w = _flagship16(tier, dev)
    xs = _blocks(dev, 8, B, B=B if B > 1 else None)  # [1, T] / [B, 1, T]
    se, eager = w.init_state(), []
    for x in xs:
        se, y = w._pitchshift_fn_eager(se, x)
        eager.append(y)
    cc.reset_launches()
    sg, graph = w.init_state(), []
    for x in xs:
        sg, y = w.pitchshift_fn(sg, x)
        graph.append(y)
    torch.cuda.synchronize()
    assert cc.LAUNCHES == {"analysis": 8, "synthesis": 8, "roundtrip": 0}
    kept = [y.clone() for y in graph]
    _bit_equal(graph + [sg["prev_tail"]], eager + [se["prev_tail"]],
               f"pitchshift_fn B={B} [{tier}]")
    w.pitchshift_fn(sg, xs[0])
    _bit_equal(graph, kept, "outputs after a later call")
    (prog,) = w._graphs.values()
    assert prog.launches[0] == {"analysis": 1, "synthesis": 1,
                                "roundtrip": 0}


@pytest.mark.parametrize("tier", ["highest", *TIERS])
def test_graph_pitchshift_streams_equals_eager(dev, tier):
    w = _flagship16(tier, dev)
    xs = [x[:, 0] for x in _blocks(dev, 8, 20, B=16)]  # [16, T] each
    se, eager = w.init_streams(16), []
    for x in xs:
        se, y = w._pitchshift_streams_eager(se, x)
        eager.append(y)
    cc.reset_launches()
    sg, graph = w.init_streams(16), []
    for x in xs:
        sg, y = w.pitchshift_streams(sg, x)
        graph.append(y)
    torch.cuda.synchronize()
    assert cc.LAUNCHES == {"analysis": 8, "synthesis": 8, "roundtrip": 0}
    _bit_equal(graph + [sg["prev_tail"]], eager + [se["prev_tail"]],
               f"pitchshift_streams(16) [{tier}]")


@pytest.mark.parametrize("tier", ["highest", *TIERS])
@pytest.mark.parametrize("B", [1, 16])
def test_graph_ta_pitchshifter_equals_eager(dev, tier, B):
    ta = PQMFPitchShiftWrapperTA(100, 16, 8192, precision=tier,
                                 device="cuda")
    xs = _blocks(dev, 8, 30 + B, B=B)  # [B, 1, T] each
    eager = [ta._pitchshifter_eager(x) for x in xs]
    cc.reset_launches()
    graph = [ta.pitchshifter(x) for x in xs]
    torch.cuda.synchronize()
    assert cc.LAUNCHES == {"analysis": 8, "synthesis": 8, "roundtrip": 0}
    _bit_equal(graph, eager, f"TA pitchshifter B={B} [{tier}]")


@pytest.mark.parametrize("tier", ["highest", *TIERS])
@pytest.mark.parametrize("C", [1, 2])
def test_graph_stream_ola_equals_eager(dev, tier, C):
    """8 blocks of 4096, overlap 2048: the one graph of the whole harness
    equals its eager run bit for bit, and a replay launches 8 K1 + 8 K2 +
    one K3."""
    w = _flagship16(tier, dev)
    T = 4096 + 7 * 2048
    x = torch.from_numpy(np.random.default_rng(40 + C).standard_normal(
        (C, T)).astype(np.float32) * 0.3).to(dev)
    first = stream_ola(w, x, 4096, 2048)
    (run,) = w._stream_ola_fns.values()
    cc.reset_launches()
    replay = stream_ola(w, x, 4096, 2048)
    torch.cuda.synchronize()
    assert cc.LAUNCHES == {"analysis": 8, "synthesis": 8, "roundtrip": 1}
    eager = run.fn(x)
    _bit_equal(list(replay) + list(first), list(eager) * 2,
               f"stream_ola C={C} [{tier}]")


@pytest.mark.parametrize("tier", ["highest", *TIERS])
def test_graphs_follow_set_weights(dev, tier):
    """After set_weights to the committed fine-tuned M = 16 bank the old
    graphs are evicted, and the new ones equal the eager body on the new
    bank (and differ from the old bank's output)."""
    from pqmf_tpu_torch.parallel.training import load_pretrained_bank

    w = _flagship16(tier, dev)
    xs = _blocks(dev, 3, 50)  # [1, T] each
    s = w.init_state()
    old = [w.pitchshift_fn(s, x)[1] for x in xs]
    old_ola = [stream_ola(w, xs[0], 4096) for _ in range(2)]
    w.pqmf.set_weights(load_pretrained_bank("hk16_atten100_finetuned"))
    new = [w.pitchshift_fn(s, x)[1] for x in xs]
    assert [k[-1] for k in w._graphs] == [1]
    _bit_equal(new, [w._pitchshift_fn_eager(s, x)[1] for x in xs],
               f"pitchshift_fn after set_weights [{tier}]")
    assert (new[2] - old[2]).abs().max().item() > 1e-4
    new_ola = [stream_ola(w, xs[0], 4096) for _ in range(2)]
    assert [k[4] for k in w._stream_ola_fns] == [1]
    (run,) = w._stream_ola_fns.values()
    _bit_equal(list(new_ola[1]), list(run.fn(xs[0])),
               f"stream_ola after set_weights [{tier}]")
    assert (new_ola[1][0] - old_ola[1][0]).abs().max().item() > 1e-4


def test_dropped_wrapper_returns_its_graph_pools(dev):
    """The graphs and their pools live on the wrapper: once it is dropped,
    the card's allocated memory is back within 1 MB of where it was, and
    so is its reserved memory once the cache is emptied (the cached
    windows and bases of the geometry filled beforehand)."""
    import gc

    from pqmf_tpu_torch import graphs

    def drive(w):
        x = _blocks(dev, 1, 60)[0]
        for _ in range(2):
            w.pitchshift_fn(w.init_state(), x)
            w.pitchshift_streams(w.init_streams(4), x.expand(4, -1))
            stream_ola(w, x, 4096)
        torch.cuda.synchronize()

    def memory():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return (torch.cuda.memory_allocated(dev),
                torch.cuda.memory_reserved(dev))

    graphs._capture_stream(torch.device(dev))
    drive(_flagship16("highest", dev))
    base = memory()
    w = _flagship16("highest", dev)
    drive(w)
    assert len(w._graphs) == 2 and len(w._stream_ola_fns) == 1
    pools = sum(p.stats["pool_bytes"] for p in (*w._graphs.values(),
                                                *w._stream_ola_fns.values()))
    alive = memory()
    assert alive[1] - base[1] >= pools > 1 << 20, (alive, base, pools)
    del w
    now = memory()
    assert now[0] - base[0] < 1 << 20 and now[1] - base[1] < 1 << 20, \
        (now, base)


@pytest.mark.parametrize("tier", ["highest", *TIERS])
@pytest.mark.parametrize("owner", ["StreamingPQMF.process_block",
                                   "flagship.pitchshift_fn"])
def test_graph_scan_blocks_equals_the_loop(dev, tier, owner):
    """``scan_blocks`` over 8 pre-framed 8192 blocks is one graph a stream:
    its replay equals the loop of eager steps bit for bit (state too), and
    launches 8 K1 + 8 K2."""
    from pqmf_tpu_torch.streaming import scan_blocks

    if owner.startswith("StreamingPQMF"):
        sp = StreamingPQMF(100, 16, precision=tier, device="cuda")
        step, eager, s0 = sp.process_block, sp.process_block, sp.init_state()
        x = torch.stack(_blocks(dev, 8, 70))[:, :, None]  # [8, 1, 1, T]
        graphs_of = sp._graphs
    else:
        w = _flagship16(tier, dev)
        step, eager, s0 = (w.pitchshift_fn, w._pitchshift_fn_eager,
                           w.init_state())
        x = torch.stack(_blocks(dev, 8, 71))              # [8, 1, T]
        graphs_of = w._graphs
    state, loop = s0, []
    for b in x:
        state, y = eager(state, b)
        loop.append(y)
    first = scan_blocks(step, s0, x)
    cc.reset_launches()
    replay = scan_blocks(step, s0, x)
    torch.cuda.synchronize()
    assert cc.LAUNCHES == {"analysis": 8, "synthesis": 8, "roundtrip": 0}
    for ts, ys in (first, replay):
        _bit_equal([ys, *pytree_leaves(ts)],
                   [torch.stack(loop), *pytree_leaves(state)],
                   f"scan_blocks over {owner} [{tier}]")
    scans = [p for k, p in graphs_of.items() if k[0] == "scan_blocks"]
    assert len(scans) == 1 and scans[0].launches[0] == {
        "analysis": 8, "synthesis": 8, "roundtrip": 0}


def pytree_leaves(tree):
    return torch.utils._pytree.tree_leaves(tree)


def _train(tier, remat, hk=None, steps=8):
    from pqmf_tpu_torch.parallel import training as tt

    init, step = tt.make_train_step(
        tt.adam(tt.cosine_decay_schedule(2e-5, steps)), precision=tier,
        remat=remat, loss_fn=tt.make_finetune_loss(16, 512), device="cuda")
    if hk is None:
        hk = StreamingPQMF(100, 16, device="cpu").params["hk"]
    xs = list(torch.from_numpy(np.random.default_rng(9).standard_normal(
        (steps, 4, 1, 8192)).astype(np.float32)).cuda())
    return tt, init, step, hk, xs


def _same_state(a, b, what):
    ma, mb = a.optimizer.state[a.hk], b.optimizer.state[b.hk]
    _bit_equal([a.hk, ma["exp_avg"], ma["exp_avg_sq"], ma["step"]],
               [b.hk, mb["exp_avg"], mb["exp_avg_sq"], mb["step"]], what)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("tier", ["highest", "bf16x3"])
def test_graph_train_step_equals_the_eager_step(dev, tier, remat):
    """Eight steps of the committed recipe's loss and shapes (cosine lr):
    the graphed step (one capture, then one replay a step) equals the eager
    capturable step bit for bit in every loss, in hk and in Adam's moments
    and count; no K1/K2/K3 runs."""
    _, init, step, hk, xs = _train(tier, remat)
    sg, se = init(hk), init(hk)
    assert sg.optimizer.param_groups[0]["capturable"]
    cc.reset_launches()
    for x in xs:
        _, lg = step(sg, x)
        _, le = step.eager(se, x)
        _bit_equal([lg], [le], f"train step loss [{tier}, remat={remat}]")
    torch.cuda.synchronize()
    assert all(v == 0 for v in cc.LAUNCHES.values())
    _same_state(sg, se, f"train state [{tier}, remat={remat}]")
    (prog,) = sg._graphs.values()
    assert prog.stats["capture_ms"] > 0 and se._graphs == {}


def test_graph_train_step_after_load_train_state(dev, tmp_path):
    """A checkpoint loaded into a new state captures its own graph: its
    graphed steps equal eager steps from the same checkpoint bit for bit,
    and the saving state's graph goes on unchanged."""
    tt, init, step, hk, xs = _train("highest", False)
    a = init(hk)
    for x in xs[:3]:
        step(a, x)
    path = tt.save_train_state(a, str(tmp_path / "a.npz"))
    c, e = tt.load_train_state(a, path), tt.load_train_state(a, path)
    assert c._graphs == {} and c.count == 3
    for x in xs[3:]:
        _, lc = step(c, x)
        _, le = step.eager(e, x)
        _bit_equal([lc], [le], "loaded state's graphed step")
        step(a, x)
    _same_state(c, e, "loaded state after graphed steps")
    _same_state(a, c, "the saving state's own graph")


_FAILED_CAPTURE = r"""
import torch
from pqmf_tpu_torch import graphs
x = torch.ones(4, device="cuda")
prog = graphs.Program(lambda t: t * t.sum().item(), x.device)
try:
    prog(x)  # the eager run, then the capture, which cannot sync
except RuntimeError as e:
    print("raised:", str(e).splitlines()[0])
else:
    raise SystemExit("a failed capture did not raise")
assert prog._replay is None
ok = graphs.Program(lambda t: t * 2.0, x.device)
for _ in range(3):
    assert torch.equal(ok(x), x * 2.0)
print("OK")
"""


def test_a_failed_capture_raises_on_the_card(dev):
    """A body that syncs with the host cannot be captured: the capture
    raises (no eager fallback), and later graphs in the process still
    capture and replay. In a process of its own, so a broken capture cannot
    reach the other tests."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", _FAILED_CAPTURE], cwd=root,
                         capture_output=True, text=True, timeout=300)
    print(res.stdout)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "raised:" in res.stdout and res.stdout.rstrip().endswith("OK")


# -- the (data, band) mesh -----------------------------------------------------


def test_mesh_runs_on_the_card(dev):
    """chip_smoke.py's mesh runs (its phase 6 a-b): one rank over NCCL, a
    (1, 1) mesh whose graphed steps hold the band and gradient all-reduces,
    bit-equal to the unsharded entries; two and four ranks sharing the card
    over gloo (Mb = 8 and 4), the eager forms within K12_TOL and >= 90 dB
    of the unsharded card results, every graph refused. One K1 and one K2
    a sharded step, one band all-reduce a synthesis."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    runs = chip_smoke._mesh_runs(torch.cuda.get_device_name(0))
    one = runs["nccl_1x1"][0]
    assert all(v == 0.0 for k, v in one["checks"].items()
               if "K3" not in k), one["checks"]
    graph = one["sharded_step_graph"]
    assert graph["collectives_a_replay"]["band_all_reduce"] == 1
    assert graph["launches_a_replay"][0]["analysis"] == 1
    assert one["launches"]["train step x10 (graph)"]["grad_all_reduce"] == 20
    for which in ("gloo_1x2", "gloo_1x4"):
        for res in runs[which]:
            n = res["launches"]["ShardedPitchShift.eager x8"]
            assert (n["K1"], n["K2"], n["band_all_reduce"]) == (8, 8, 8), n


@pytest.mark.parametrize("tier", ["highest", "bf16x3", "default"])
@pytest.mark.parametrize("Mb", [8, 4])
def test_band_shard_kernels_match_plain(dev, tier, Mb):
    """K1/K2 (K1t/K2t) on every rank's band shard of the 16-band bank, and
    K4/K5 at `highest`, against their plain versions (K12's bar) at a host
    block, 16 blocks and (K4/K5) 60 s."""
    sp, pq = StreamingPQMF(100, 16), PQMF(100, 16)
    hp, hi = pq.params["hk_poly"], pq.params["hk_ipoly"]
    g = torch.Generator().manual_seed(Mb)
    for r in range(16 // Mb):
        sl = slice(r * Mb, (r + 1) * Mb)
        wa, ws = sp.hkf[sl].contiguous(), sp.hki[:, sl].contiguous()
        for B in (1, 16):
            x = torch.randn(B, 1, 8192 + 512, generator=g).to(dev)
            s = torch.randn(B, Mb, 512 + 32, generator=g).to(dev)
            torch.testing.assert_close(
                cc.strided_analysis_conv(x, wa, 16, mxu_precision=tier),
                cc.analysis_conv_plain(x, wa, 16, precision=tier), **TOL)
            torch.testing.assert_close(
                cc.dense_synthesis_conv(s, ws, True, -16, tier),
                cc.synthesis_conv_plain(s, ws, True, -16, tier), **TOL)
        if tier == "highest":
            hp_s, hi_s = hp[sl].contiguous(), hi[:, sl].contiguous()
            x = torch.randn(1, 1, 60 * 44100 // 16 * 16, generator=g).to(dev)
            s = torch.randn(1, Mb, 60 * 44100 // 16, generator=g).to(dev)
            torch.testing.assert_close(
                pk.polyphase_analysis(x, hp_s),
                pk.polyphase_analysis_plain(x, hp_s), **TOL)
            torch.testing.assert_close(
                pk.polyphase_synthesis(s, hi_s),
                pk.polyphase_synthesis_plain(s, hi_s), **TOL)
