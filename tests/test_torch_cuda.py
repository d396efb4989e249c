"""pqmf_tpu_torch on the card: the port's one card check. Every test is
marked ``cuda`` and skips without a CUDA device.

This file imports no JAX (the card's machine has none), so it runs there
without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

It holds, on the card: the build (ptxas reports no spill) and the CUDA
source's shared-memory gates and launch plans against their Python
mirror; each kernel (K1-K6, the tier kernels K1t-K6t, the middle's three
kernels, the band shards) against its plain PyTorch version, at edge
cases and at the main paths' shapes; every entry point, wrapper, CLI and
artifact against the port on the CPU, with its launches counted and
every plain version refused; the 60 s SNR pins; the CUDA graphs against
the eager bodies they capture; the native C data layer; fine-tuning and
the committed recipe; the (data, band) mesh on the one card; the entry
points. ``tools/kernel_times.py`` times the kernels.

The bars are defined once, below. K1/K2 against their plain versions
``K12_TOL`` (pqmf_tpu's kernel-vs-lax bar); K3 against the plain
composition ``K3_TOL`` (it sums the analysis taps phase by phase, another
order); K4/K5 against the polyphase formula ``K12_TOL`` and K6
``K6_TOL`` (another tap order again); the offline path against the CPU
port ``OFFLINE_TOL``; the pitch-shift paths, the torchaudio variant, the
block harness's pitch stream and the standalone shifters ``BAR_DB``
against the CPU port. The tier kernels (``precision="bf16x3"`` and
``"default"``) keep those bars against the plain versions at the same
tier, but for the ``default`` K3t: its f32 sub-bands are rounded to bf16
again, and where they differ from the plain version's by an f32 ulp one
such rounding can flip by a bf16 ulp, so its bound is one bf16 ulp of the
largest sub-band times the largest column sum of |w_syn| times M, with
all but ``k3t_default_off(M)`` of the outputs inside ``K3_TOL``.
"""

import functools
import json
import os
import subprocess
import sys
import time

# The CPU reference of every card-against-CPU test takes one code path on
# every host: MKL in its conditional-numerical-reproducibility mode and
# ATen's AVX2 kernels, set before torch loads (MKL reads its mode at its
# first GEMM). Without them the CPU port's output moved between hosts of
# the same card (MKL dispatches by instruction set and CPU vendor). On the
# card this module is the first to import torch (pytest --noconftest);
# where another module has imported it already, nothing is changed.
CPU_PIN = {"MKL_CBWR": "COMPATIBLE", "ATEN_CPU_CAPABILITY": "avx2"}
if "torch" not in sys.modules:
    os.environ.update(CPU_PIN)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from pqmf_tpu_torch import (PQMF, PQMFPitchShiftWrapper,  # noqa: E402
                            PQMFPitchShiftWrapperTA, PQMFWrapper,
                            StreamingPQMF, TorchaudioPitchShift, stream_ola)
from pqmf_tpu_torch.cli.finetune_bank import bench_signal  # noqa: E402
from pqmf_tpu_torch.kernels import _build  # noqa: E402
from pqmf_tpu_torch.kernels import cached_conv as cc  # noqa: E402
from pqmf_tpu_torch.kernels import middle as pm  # noqa: E402
from pqmf_tpu_torch.kernels import polyphase as pk  # noqa: E402
from pqmf_tpu_torch.ops import filterbank as fb  # noqa: E402
from pqmf_tpu_torch.utils.metrics import (  # noqa: E402
    aligned_roundtrip_snr_db, snr_db)

pytestmark = pytest.mark.cuda

SR, BLOCK = 44100, 8192
SHIFTS16 = [0, 4, -5, -12, 3, -7, 2, -3, 5, -9, 1, -1, -4, -6, -2, -24]
TA_SHIFTS16 = [3.2, -48.5, 12.3, 0, 7, -24, 1, 2, 3, 4, 5, 6, -6, -12, 9,
               -30]  # the reference's random range
TA_SHIFTS8 = [0, -3, 5, 12, -7, 2, 1, -1]
TIERS = ("bf16x3", "default")

# -- the bars -----------------------------------------------------------------

BAR_DB = 90.0
K12_TOL = dict(atol=2e-5, rtol=1e-4)  # pqmf_tpu's own kernel-vs-lax bar
K3_TOL = dict(atol=1e-5, rtol=0.0)    # recomputed halo: another tap order
K6_TOL = dict(atol=2e-5, rtol=1e-4)   # K3's order vs the polyphase formula's
OFFLINE_TOL = dict(atol=2e-5, rtol=1e-4)  # the offline path vs the CPU port
# K3t/K6 at bf16x3 against their plain versions: K12_TOL. Their f32 mid is
# split again, and where it differs from the plain version's by an f32 ulp
# the lo half's rounding moves by one of its ulps (2^-17 of the mid) on
# about 2^-6 of the mids, past K3_TOL's 1e-5 on some outputs at M=2.
K3T_BF16X3_TOL = K12_TOL
# K3t/K6 at "default": the most outputs flipped mids may take past K3_TOL,
# by the bank's M. A flip moves Ks * M outputs, so the share is lumpy on a
# small call and grows with M. M <= 16 keeps its earlier bar (the most an
# NVIDIA H100 80GB HBM3 read there: 4.1%); at M = 32 and 64 each cap is
# 1.5 times the most that card read at that M over tools/k3_bands.py's
# seeds and shapes and these tests (9.28% and 18.58%), rounded up to a
# whole percent (PERF.md)
K3T_DEFAULT_OFF = {16: 0.05, 32: 0.14, 64: 0.28}
# The pitch-shift paths at "default" against the CPU port: their DFT
# operands are rounded to bf16, and where the card's f32 value (cuBLAS, the
# card's atan2/cos/sin) differs from the CPU's by an f32 ulp that rounding
# flips by a bf16 ulp (2^-8 of the value). A flip on a spectral peak of a
# tonal block moves the output by ~80-90 dB (an NVIDIA H100 read 81.4-97.9
# dB on the blocks, 112-138 dB on the round trips and tails). The bar there
# is BAR_DB or, if lower, DEFAULT_MARGIN_DB under the tier's own error
# (the card's default output against its highest output of the block).
DEFAULT_MARGIN_DB = 25.0
# the 60 s signal's round trips, (dB, to within)
SNR_STREAM_DB = (65.1997, 0.01)   # StreamingPQMF.roundtrip, delay 16
SNR_60S_DB = (55.2262, 0.01)      # designed M=16 bank, delay 0, whole signal
SNR_FINETUNED_DB = (104.2123, 0.01)  # fine-tuned M=16 bank, edge_trim=1024
# the JAX package's floors for the committed M = 32 / 64 banks' steady-state
# round trip (tools/tpu_checks.py, tools/gpu_checks.py); the default tier's
FINETUNED_FLOOR_DB = {32: 99.0, 64: 98.0}
FINETUNED_DEFAULT_FLOOR_DB = 45.0
# and what the card read there through K3/K3t before their cluster
# redesign (PERF.md, NVIDIA H100 80GB HBM3): the redesigned kernels
# keep each within 0.01 dB (the bf16x3 readings were kept to two decimals,
# so their bar is 0.015 dB)
FINETUNED_EARLIER_DB = {(32, "highest"): (107.4981, 0.01),
                        (64, "highest"): (104.1370, 0.01),
                        (32, "bf16x3"): (102.38, 0.015),
                        (64, "bf16x3"): (100.94, 0.015)}
# fine-tuning: card against the pinned CPU port (loss relative, the
# gradient against max|g|: the loss is the MSE of a residual about 1e-3 of
# the signal, so f32 summation orders show amplified), and the bars of the
# trained bank (steady-state SNR on the 60 s signal, worst stopband)
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-4, 1e-3
TRAINED_SNR_DB, TRAINED_STOPBAND_DB = 100.0, -55.0
DESIGNED_STEADY_DB = (71.2761, 0.01)  # the designed bank, edge trim 512
# the committed banks' recipe (pqmf_tpu/parallel/training.py), at M = 16
RECIPE = dict(steps=8000, batch=4, length=8192, lr=2e-5,
              lr_schedule="cosine", seed=0)


def k3t_default_off(M: int) -> float:
    """The share of a ``default``-tier K3t's (K6's) outputs that may leave
    K3_TOL at ``M`` bands (``K3T_DEFAULT_OFF``; M <= 16 take M = 16's)."""
    return K3T_DEFAULT_OFF[max(16, M)]


def _audio(n: int, seed: int, batch: int = 1) -> np.ndarray:
    """``batch`` rows of a seeded sine between 110 and 1760 Hz plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    f = rng.uniform(110, 1760, (batch, 1))
    x = 0.4 * np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal(
        (batch, n))
    return x.astype(np.float32)


def _refuse_plain(monkeypatch):
    """Make every plain version a CUDA path could reach raise: a run after
    this shows the path never took one."""
    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the CUDA path")

    for mod, names in ((cc, ("analysis_conv_plain", "synthesis_conv_plain",
                             "roundtrip_conv_plain")),
                       (pk, ("polyphase_analysis_plain",
                             "polyphase_synthesis_plain",
                             "polyphase_roundtrip_plain")),
                       (pm, ("frame_plain", "spectral_plain",
                             "resynth_plain")),
                       (fb, ("polyphase_forward", "polyphase_inverse",
                             "_conv1d"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)


def _launches(want=None):
    """K1-K3's launches since the last ``cc.reset_launches``: all three
    keys, the ones ``want`` leaves out zero."""
    return {"analysis": 0, "synthesis": 0, "roundtrip": 0, **(want or {})}


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
            cc.analysis_conv_plain(x, hkf, M, fuse), **K12_TOL)
    sub = F.pad(cc.strided_analysis_conv(x, hkf, M), (Ks // 2, Ks // 2))
    for fuse, off in [(True, -(Ks // 2)), (True, -15), (True, 3),
                      (True, 0), (False, 0)]:
        torch.testing.assert_close(
            cc.dense_synthesis_conv(sub, hki, fuse, off),
            cc.synthesis_conv_plain(sub, hki, fuse, off), **K12_TOL)
    if cc.fused_roundtrip_supported(M, Ka, Ks):
        for pad in [(Ks // 2, Ks // 2), (3, 0)]:
            torch.testing.assert_close(
                cc.fused_roundtrip_conv(x, hkf, hki, M, pad),
                cc.roundtrip_conv_plain(x, hkf, hki, M, pad), **K3_TOL)
    torch.cuda.synchronize()


# the launch plans the main paths take: (kernel, (B, M, Mb, Ka, Ks, T_out));
# K4-K6 are K1-K3 at the offline geometry (even taps)
MAIN_PLANS = [
    ("analysis", (1, 16, 16, 513, 0, 512)),
    ("analysis", (16, 16, 16, 513, 0, 512)),
    ("analysis", (1, 16, 16, 512, 0, 60 * SR // 16)),
    ("analysis", (1, 8, 8, 257, 0, 256)),
    ("analysis", (215, 16, 16, 513, 0, 256)),
    ("analysis", (1, 32, 32, 1024, 0, 4096)),
    ("analysis", (1, 64, 64, 2048, 0, 2048)),
    ("analysis", (1, 16, 6, 513, 0, 512)),
    ("synthesis", (1, 16, 16, 0, 33, 512)),
    ("synthesis", (16, 16, 16, 0, 33, 512)),
    ("synthesis", (1, 16, 16, 0, 32, 60 * SR // 16)),
    ("synthesis", (1, 8, 8, 0, 33, 256)),
    ("synthesis", (1, 32, 32, 0, 32, 4096)),
    ("synthesis", (1, 64, 64, 0, 32, 2048)),
    ("roundtrip", (1, 16, 16, 513, 33, 60 * SR // 16 + 1)),
    ("roundtrip", (1, 16, 16, 512, 32, 60 * SR // 16 + 1)),
    ("roundtrip", (1, 16, 16, 513, 33, 512)),
    ("roundtrip", (16, 16, 16, 513, 33, 512)),
    ("roundtrip", (215, 16, 16, 513, 33, 256)),
    ("roundtrip", (1, 8, 8, 257, 33, 300)),
    ("roundtrip", (1, 32, 32, 1025, 33, 60 * SR // 32 + 1)),
    ("roundtrip", (1, 32, 32, 1025, 33, 256)),
    ("roundtrip", (16, 32, 32, 1025, 33, 256)),
    ("roundtrip", (1, 32, 32, 1024, 32, 60 * SR // 32)),
    ("roundtrip", (1, 64, 64, 2049, 33, 60 * SR // 64 + 1)),
    ("roundtrip", (1, 64, 64, 2049, 33, 128)),
    ("roundtrip", (16, 64, 64, 2049, 33, 128)),
    ("roundtrip", (1, 64, 64, 2048, 32, 60 * SR // 64))]


def _main_plans_mirror(lib, n_sms, tier):
    """At the main paths' shapes (``MAIN_PLANS``) the CUDA source's launch
    plan (``pqmf_launch_plan``, the tiers' ``pqmf_tc_launch_plan``) is its
    Python mirror's, within the shared-memory gate and the card's limit;
    at M = 32 and 64 the round trip's gates agree at the committed and the
    offline banks' geometries, the fused round trip takes them, and its
    plans use the clusters the card holds at once."""
    import ctypes

    passes = {"highest": 1, "bf16x3": 3, "default": 1}[tier]
    for M, Ka, Ks in [(32, 1025, 33), (32, 1024, 32), (64, 2049, 33),
                      (64, 2048, 32)]:
        gate = (lib.pqmf_smem_bytes(3, M, M, Ka, Ks) if tier == "highest"
                else lib.pqmf_tc_smem_bytes(3, M, M, Ka, Ks, passes))
        assert gate == cc.smem_bytes("roundtrip", M, M, Ka, Ks, tier), \
            (M, Ka, Ks)
        assert cc.fused_roundtrip_supported(M, Ka, Ks, tier), (M, Ka, Ks)
    plan = (ctypes.c_longlong * 8)()
    for which, args in MAIN_PLANS:
        code = {"analysis": 1, "synthesis": 2, "roundtrip": 3}[which]
        big_rt = which == "roundtrip" and args[1] >= 32
        mc = cc.max_clusters(args[1], args[3], args[4], tier) if big_rt else 0
        if tier == "highest":
            assert lib.pqmf_launch_plan(code, *args, n_sms, mc, plan) == 0
        else:
            assert lib.pqmf_tc_launch_plan(code, *args, n_sms, passes, mc,
                                           plan) == 0
            assert lib.pqmf_tc_smem_bytes(code, *args[1:5], passes) == \
                cc.smem_bytes(which, *args[1:5], tier), (which, args)
        mirror = cc.launch_plan(which, *args, n_sms=n_sms, precision=tier,
                                max_clusters=mc if big_rt else None)
        assert tuple(plan) == mirror, (which, args, tuple(plan), mirror)
        assert mirror[7] <= cc.smem_bytes(which, *args[1:5], tier) \
            <= cc.SMEM_LIMIT, (which, args, mirror)


def test_smem_gate_mirrors_the_source(dev):
    """The gates and the launch plans of kernels/cached_conv.py are the
    CUDA source's, on this card's SM count, over a grid of shapes and at
    the main paths' (``_main_plans_mirror``)."""
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
    _main_plans_mirror(lib, n_sms, "highest")


def test_ptxas_reports_no_spill(dev):
    """The build's ptxas report (``-Xptxas -v``, kept beside the library
    as ``.log``) shows no kernel of any source spilling registers."""
    log = _build.build().with_suffix(".log").read_text()
    spills = [ln.strip() for ln in log.splitlines() if "spill" in ln]
    assert spills, "ptxas reported no kernel"
    assert all(" 0 bytes spill stores, 0 bytes spill loads" in ln
               for ln in spills), [ln for ln in spills
                                   if " 0 bytes spill stores" not in ln]


@pytest.mark.parametrize("tier", ["highest", *TIERS])
def test_kernels_on_the_60s_signal(dev, tier):
    """Each kernel on bench.py's 60 s signal, the main paths' shape,
    against its plain version at the tier, output memory NaN-filled first:
    K3 (K3t) at M = 16 on the padded signal, at M = 32 and 64 with the
    centered pad in the kernel; K4, K5 and K6 at M = 16; K6 at M = 32 and
    64. At ``highest`` K3 at M = 16 within K3_TOL, at M = 32 and 64 within
    K12_TOL (its sums run in one thread, K1's and K2's order), K4/K5
    K12_TOL, K6 K6_TOL; at the tiers K4/K5 K12_TOL and the round trips
    ``assert_k3t_close``."""
    raw60 = torch.from_numpy(bench_signal(60 * SR)).to(dev)[None, None]
    for M in (16, 32, 64):
        wa, ws = _bank(M, dev)
        ka, ks = wa.shape[-1], ws.shape[-1]
        half, syn = (ka // 2, ka // 2), (ks // 2, ks // 2)
        x, pad = (F.pad(raw60, half), (0, 0)) if M == 16 else (raw60, half)
        _nan_fill()
        got = cc.fused_roundtrip_conv(x, wa, ws, M, syn, tier, pad)
        ref = cc.roundtrip_conv_plain(x, wa, ws, M, syn, tier, pad)
        assert got.shape == ref.shape and torch.isfinite(got).all(), M
        if tier == "highest":
            torch.testing.assert_close(got, ref,
                                       **(K3_TOL if M == 16 else K12_TOL))
        else:
            assert_k3t_close(got, ref, cc.strided_analysis_conv(
                x, wa, M, pad=pad), ws, tier)
        pq = PQMF(100, M, device="cuda")
        hp, hi, w2 = pq.params["hk_poly"], pq.params["hk_ipoly"], pq._w2
        x6 = raw60[..., : raw60.shape[-1] // M * M]
        _nan_fill()
        got = pk.polyphase_roundtrip(x6, hp, hi, w2, tier)
        ref = pk.polyphase_roundtrip_plain(x6, hp, hi, tier)
        assert got.shape == ref.shape and torch.isfinite(got).all(), M
        if tier == "highest":
            torch.testing.assert_close(got, ref, **K6_TOL)
        else:
            assert_k3t_close(got, ref, pk.polyphase_analysis(x6, hp, w2),
                             hi, tier)
        if M == 16:
            sub60 = pk.polyphase_analysis(raw60, hp, w2)
            for got, ref in [
                    (pk.polyphase_analysis(raw60, hp, w2,
                                           mxu_precision=tier),
                     pk.polyphase_analysis_plain(raw60, hp, tier)),
                    (pk.polyphase_synthesis(sub60, hi, tier),
                     pk.polyphase_synthesis_plain(sub60, hi, tier))]:
                assert torch.isfinite(got).all()
                torch.testing.assert_close(got, ref, **K12_TOL)
    torch.cuda.synchronize()


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
                cc.synthesis_conv_plain(x, hki, True, off), **K12_TOL)
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
                got, cc.analysis_conv_plain(x, w, 16, fuse, pad), **K12_TOL)
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
        got, cc.analysis_conv_plain(x, w, M, True, (M, M)), **K12_TOL)


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
                               **K3_TOL)
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
    torch.testing.assert_close(got.cpu(), cpu.roundtrip(x), **K3_TOL)
    torch.testing.assert_close(back.cpu(), cpu.inverse(cpu.forward(x)),
                               **K12_TOL)
    cst, cblocks = cpu.init_state(2), []
    for blk in np.split(x, 4, axis=-1):
        cst, y = cpu.process_block(cst, blk)
        cblocks.append(y)
    torch.testing.assert_close(torch.cat(blocks, -1).cpu(),
                               torch.cat(cblocks, -1), **K12_TOL)


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
                               pk.polyphase_analysis_plain(x, hp), **K12_TOL)
    torch.testing.assert_close(pk.polyphase_synthesis(s, hi),
                               pk.polyphase_synthesis_plain(s, hi), **K12_TOL)
    L = hp.shape[-1]
    assert pk.roundtrip_supported(M, L * M, L), M  # K6 at every M
    torch.testing.assert_close(pk.polyphase_roundtrip(x, hp, hi),
                               pk.polyphase_roundtrip_plain(x, hp, hi),
                               **K6_TOL)
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
                                   **K12_TOL)


def test_offline_path_runs_no_plain_version(dev, monkeypatch):
    """Every plain version the offline path could reach raises: the CUDA
    path of PQMF (K6, and K4 + K5 at M=32), its classic path aside, and
    PQMFWrapper never call one."""
    _refuse_plain(monkeypatch)
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


@pytest.mark.parametrize("M,buf,shifts,B,T", [
    (16, 8192, TA_SHIFTS16, 1, 8192),
    (16, 8192, None, 16, 8192),
    (8, 2048, TA_SHIFTS8, 2, 2048),  # Tb = 256: K1/K2 at the M=8 bank
    (16, None, TA_SHIFTS16, 1, 54 * 8192)])  # a 10 s file, whole
def test_ta_pitchshifter_on_kernels(dev, monkeypatch, M, buf, shifts, B, T):
    """One K1 and one K2 per pitchshifter call, one K1 per forward, one K2
    per inverse, no plain version; >= 90 dB against the CPU port, forward
    and inverse within OFFLINE_TOL of it. ``buf`` None: the wrapper of
    blocks of 8192 takes a whole file (``max_buffer_size=None``)."""
    kw = dict(shifts_in_semitones=shifts)
    if buf is None:
        buf, kw["max_buffer_size"] = 8192, None
    gpu = PQMFPitchShiftWrapperTA(100, M, buf, **kw, device="cuda")
    cpu = PQMFPitchShiftWrapperTA(100, M, buf, **kw, device="cpu")
    x = np.random.default_rng(M + B).standard_normal((B, 1, T)).astype(
        np.float32) * 0.3
    want = cpu.pitchshifter(x).numpy()
    c_sub = cpu.forward(x)
    c_back = cpu.inverse(c_sub)
    _refuse_plain(monkeypatch)
    cc.reset_launches()
    got = gpu.pitchshifter(x)
    sub = gpu.forward(x)
    back = gpu.inverse(sub)
    torch.cuda.synchronize()
    assert cc.LAUNCHES == {"analysis": 2, "synthesis": 2, "roundtrip": 0}
    assert got.shape == (B, 1, T) and back.shape == (B, 1, T)
    assert torch.isfinite(got).all()
    assert snr_db(want, got.cpu().numpy()) >= BAR_DB
    torch.testing.assert_close(sub.cpu(), c_sub, **OFFLINE_TOL)
    torch.testing.assert_close(back.cpu(), c_back, **OFFLINE_TOL)


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
    torch.testing.assert_close(g_recon.cpu(), c_recon, **OFFLINE_TOL)


SUB_SR = round(SR / 16)  # 2756: the 16-band bank's per-band rate


@pytest.mark.parametrize("shifter", ["TorchaudioPitchShift(2756, -5)",
                                     "TorchaudioPitchShift(2756, 7)",
                                     "TorchaudioPitchShift(2756, 7) batch 2",
                                     "PhaseVocoderPitchShift n_steps 4",
                                     "ResamplePitchShift(4)"])
def test_standalone_shifter_on_card(dev, shifter):
    """The standalone shifters on 10 s (the torchaudio one at the band
    rate, and on a batch of two rows of 5,000 samples) run on the input's
    device, >= 90 dB against the CPU port (the torchaudio shifter's running
    phase is float64 on both)."""
    from pqmf_tpu_torch import PhaseVocoderPitchShift, ResamplePitchShift

    fn, x = {
        "TorchaudioPitchShift(2756, -5)": (TorchaudioPitchShift(SUB_SR, -5),
                                           _audio(10 * SUB_SR, 13)),
        "TorchaudioPitchShift(2756, 7)": (TorchaudioPitchShift(SUB_SR, 7),
                                          _audio(10 * SUB_SR, 13)),
        "TorchaudioPitchShift(2756, 7) batch 2": (
            TorchaudioPitchShift(SUB_SR, 7),
            np.random.default_rng(3).standard_normal((2, 5000)).astype(
                np.float32) * 0.3),
        "PhaseVocoderPitchShift n_steps 4": (
            lambda v: PhaseVocoderPitchShift()(v, 4), _audio(10 * SR, 10)),
        "ResamplePitchShift(4)": (ResamplePitchShift(4),
                                  _audio(10 * SR, 10)),
    }[shifter]
    got = fn(torch.from_numpy(x).to(dev))
    assert got.device.type == "cuda"
    assert got.shape == x.shape and torch.isfinite(got).all()
    assert snr_db(fn(torch.from_numpy(x)).numpy(), got.cpu().numpy()) \
        >= BAR_DB


# -- the paths at the main paths' sizes, against the port on the CPU ----------


def _flagship_outputs(tier, device, blocks, streams, ta_block):
    """The flagship (100 dB, 16 bands, 8192-sample blocks, SHIFTS16) at
    ``tier`` on ``device``: 8 carried blocks, their tail, one 16-stream
    step, its tails and one ``forward_fn`` (K1-K3's and the middle's
    launches read after them), then the TA wrapper's block (16 bands, 8192,
    B = 1) when ``ta_block`` is not None."""
    w = PQMFPitchShiftWrapper(100, 16, BLOCK, SR, SHIFTS16, precision=tier,
                              device=device)
    cc.reset_launches()
    pm.reset_launches()
    s, out = w.init_state(), []
    for blk in blocks:
        s, y = w.pitchshift_fn(s, blk)
        out.append(y)
    ss, y16 = w.pitchshift_streams(w.init_streams(16), streams)
    out += [s["prev_tail"], y16, ss["prev_tail"], w.forward_fn(blocks[0])]
    if device == "cuda":
        torch.cuda.synchronize()
    launches = (dict(cc.LAUNCHES), dict(pm.LAUNCHES))
    if ta_block is not None:
        ta = PQMFPitchShiftWrapperTA(100, 16, BLOCK, SR, TA_SHIFTS16,
                                     precision=tier, device=device)
        out.append(ta.pitchshifter(ta_block))
    return [o.cpu().numpy() for o in out], launches


@pytest.mark.parametrize("tier", ["highest", *TIERS])
def test_flagship_at_its_defaults_matches_cpu(dev, monkeypatch, tier):
    """The flagship at the reference's defaults on the card, every plain
    version refused: 8 carried blocks, one 16-stream step and one
    ``forward_fn`` launch one K1 + one K2 a pitch-shift step, one K3 a
    round trip and each middle kernel once a step; every output and
    carried tail >= BAR_DB against the same wrapper on the CPU at the
    tier, and at the tiers the TA wrapper's block too. At ``default`` each
    bar is BAR_DB or, if lower, DEFAULT_MARGIN_DB under the tier's own
    error there (the card's default output against its highest one)."""
    blocks = np.split(_audio(8 * BLOCK, 2), 8, axis=-1)
    streams = _audio(BLOCK, 3, batch=16)
    ta_block = None if tier == "highest" else _audio(BLOCK, 7)[None]
    want, _ = _flagship_outputs(tier, "cpu", blocks, streams, ta_block)
    bars = [BAR_DB] * len(want)
    if tier == "default":
        high, _ = _flagship_outputs("highest", "cuda", blocks, streams,
                                    ta_block)
    with monkeypatch.context() as m:
        _refuse_plain(m)
        got, (launches, middle) = _flagship_outputs(tier, "cuda", blocks,
                                                    streams, ta_block)
    assert launches == _launches({"analysis": 9, "synthesis": 9,
                                  "roundtrip": 1}), launches
    assert middle == dict.fromkeys(middle, 9), middle
    assert got[0].shape == (1, BLOCK) and got[9].shape == (16, BLOCK)
    assert all(np.isfinite(g).all() for g in got)
    if tier == "default":
        bars = [min(BAR_DB, snr_db(h, g) + DEFAULT_MARGIN_DB)
                for h, g in zip(high, got)]
    dbs = [snr_db(w, g) for w, g in zip(want, got)]
    print(f"flagship [{tier}] vs CPU: {[round(d, 1) for d in dbs]} dB, "
          f"bars {[round(b, 1) for b in bars]}")
    assert all(d >= b for d, b in zip(dbs, bars)), (dbs, bars)


def test_default_k2t_on_the_cpus_inputs_matches_the_cpu(dev, monkeypatch):
    """K2t at ``default`` on the card, given the CPU's own inputs of each
    of its calls in the flagship (8 blocks and a 16-stream step, the DFT
    operands left in f32 on both sides so the only bf16 roundings left are
    K1t's and K2t's, the eager bodies so Python sees each call), is >=
    BAR_DB against the CPU's K2t output: the flagship's distance from the
    CPU at ``default`` comes from its inputs, which the middle computes on
    each device, not from K2t."""
    from pqmf_tpu_torch.ops import stft as S

    dft_real, syn_real = S.dft_matmul, cc.dense_synthesis_conv
    calls = {"cuda": [], "cpu": []}

    def syn_rec(x, *args, **kwargs):
        y = syn_real(x, *args, **kwargs)
        calls[x.device.type].append((x.detach().clone(), kwargs,
                                     y.detach().clone()))
        return y

    blocks = np.split(_audio(8 * BLOCK, 2), 8, axis=-1)
    streams = _audio(BLOCK, 3, batch=16)
    tg, tc = (PQMFPitchShiftWrapper(100, 16, BLOCK, SR, SHIFTS16,
                                    precision="default", device=d)
              for d in ("cuda", "cpu"))
    with monkeypatch.context() as m:
        m.setattr(S, "dft_matmul",
                  lambda a, b, precision="highest": dft_real(a, b))
        m.setattr(cc, "dense_synthesis_conv", syn_rec)
        for w in (tg, tc):
            s = w.init_state()
            for blk in blocks:
                s, _ = w._pitchshift_fn_eager(s, blk)
            w._pitchshift_streams_eager(w.init_streams(16),
                                        w.pqmf.as_tensor(streams))
    dbs = []
    for (xc, kw, yc) in calls["cpu"]:
        yg = cc.dense_synthesis_conv(
            xc.to(dev), tg.pqmf.hki, x_offset=kw["x_offset"],
            mxu_precision="default", pad=kw["pad"],
            bank=tg.pqmf.tc_banks["synthesis"])
        dbs.append(snr_db(yc.numpy(), yg.cpu().numpy()))
    assert len(calls["cuda"]) == len(dbs) == 9 and min(dbs) >= BAR_DB, dbs


def _counted(want, want_pk, fn, *args):
    """``fn(*args)`` with K1-K3's and K4-K6's counters zeroed just before
    and read just after: ``want`` / ``want_pk`` launches, the rest none."""
    cc.reset_launches()
    pk.reset_launches()
    out = fn(*args)
    torch.cuda.synchronize()
    assert cc.LAUNCHES == _launches(want), (fn, dict(cc.LAUNCHES))
    assert pk.LAUNCHES == _launches(want_pk), (fn, dict(pk.LAUNCHES))
    return out


@pytest.mark.parametrize("tier", ["highest", *TIERS])
def test_offline_path_on_the_60s_signal(dev, monkeypatch, tier):
    """``PQMF`` (100 dB, 16 bands) on bench.py's 60 s signal on the card,
    every plain version refused: ``forward``, ``inverse`` and
    ``roundtrip`` one K4 (K1), one K5 (K2), one K6 (K3) launch each,
    within OFFLINE_TOL of the CPU port at the tier (the ``default`` round
    trip: ``assert_k3t_close``). The round trip's SNR at delay 0 keeps
    SNR_60S_DB and ``StreamingPQMF.roundtrip``'s at its delay
    SNR_STREAM_DB (``highest``, ``bf16x3``). At ``highest`` also a stereo
    batch (``n_channels=2``), the committed fine-tuned bank (its SNR at
    ``edge_trim=1024`` SNR_FINETUNED_DB) and the M = 32 round trip."""
    from pqmf_tpu_torch.parallel.training import load_pretrained_bank

    sixty = bench_signal(60 * SR)
    raw60 = torch.from_numpy(sixty).to(dev)[None, None]
    gpu, cpu = (PQMF(100, 16, precision=tier, device=d)
                for d in ("cuda", "cpu"))
    sp = StreamingPQMF(100, 16, precision=tier, device="cuda")
    c_sub = cpu.forward(sixty)
    want = {"forward": c_sub, "inverse": cpu.inverse(c_sub),
            "roundtrip": cpu.roundtrip(sixty)}
    cases = {"forward": (gpu.forward, raw60, {"analysis": 1}),
             "inverse": (gpu.inverse, c_sub.to(dev), {"synthesis": 1}),
             "roundtrip": (gpu.roundtrip, raw60, {"roundtrip": 1})}
    if tier == "highest":
        stereo = _audio(16 * 4096, 4, batch=4).reshape(2, 2, -1)
        st = {d: PQMF(100, 16, n_channels=2, device=d)
              for d in ("cuda", "cpu")}
        ft = {d: PQMF(100, 16, device=d) for d in ("cuda", "cpu")}
        for p in ft.values():
            p.set_weights(load_pretrained_bank("hk16_atten100_finetuned"))
        st_sub = st["cpu"].forward(stereo)
        m32 = {d: PQMF(100, 32, device=d) for d in ("cuda", "cpu")}
        for what, fn, x, n in [
                ("stereo forward", "forward", stereo, {"analysis": 1}),
                ("stereo inverse", "inverse", st_sub, {"synthesis": 1}),
                ("stereo roundtrip", "roundtrip", stereo, {"roundtrip": 1})]:
            cases[what] = (getattr(st["cuda"], fn),
                           torch.as_tensor(x).to(dev), n)
            want[what] = getattr(st["cpu"], fn)(x)
        cases["fine-tuned roundtrip"] = (ft["cuda"].roundtrip, raw60,
                                         {"roundtrip": 1})
        want["fine-tuned roundtrip"] = ft["cpu"].roundtrip(sixty)
        cases["M=32 roundtrip"] = (m32["cuda"].roundtrip,
                                   torch.from_numpy(stereo[0, :1]).to(dev),
                                   {"roundtrip": 1})
        want["M=32 roundtrip"] = m32["cpu"].roundtrip(stereo[0, :1])
    with monkeypatch.context() as m:
        _refuse_plain(m)
        got = {what: _counted(n, n, fn, x)
               for what, (fn, x, n) in cases.items()}
        y60 = _counted({"roundtrip": 1}, {}, sp.roundtrip, raw60)
    for what, ref in want.items():
        g = got[what].cpu()
        assert g.shape == ref.shape and torch.isfinite(g).all(), what
        if what == "roundtrip" and tier == "default":
            assert_k3t_close(g, ref, c_sub, cpu.params["hk_ipoly"], tier)
        else:
            torch.testing.assert_close(g, ref, **OFFLINE_TOL,
                                       msg=lambda m: f"{what}: {m}")
    dbs = {"offline": aligned_roundtrip_snr_db(
               sixty, got["roundtrip"][0, 0].cpu().numpy(), 0),
           "streaming": aligned_roundtrip_snr_db(
               sixty, y60[0, 0].cpu().numpy(), sp.centered_delay)}
    if tier == "highest":
        dbs["fine-tuned"] = aligned_roundtrip_snr_db(
            sixty, got["fine-tuned roundtrip"][0, 0].cpu().numpy(), 0,
            edge_trim=1024)
    print(f"60 s round trips [{tier}]: {dbs} dB")
    if tier != "default":
        assert abs(dbs["offline"] - SNR_60S_DB[0]) <= SNR_60S_DB[1], dbs
        assert abs(dbs["streaming"] - SNR_STREAM_DB[0]) <= SNR_STREAM_DB[1], \
            dbs
    if tier == "highest":
        assert abs(dbs["fine-tuned"] - SNR_FINETUNED_DB[0]) \
            <= SNR_FINETUNED_DB[1], dbs


@pytest.mark.parametrize("tier", ["highest", *TIERS])
@pytest.mark.parametrize("M", [32, 64])
def test_finetuned_banks_on_the_60s_signal(dev, monkeypatch, tier, M):
    """The committed fine-tuned banks at M = 32 and 64 through
    ``StreamingPQMF.roundtrip`` and ``PQMF.roundtrip`` on bench.py's 60 s
    signal, every plain version refused: one K3 (K3t) launch each and no
    K1/K2; against their plain versions on the card (K12_TOL / K6_TOL at
    ``highest``, ``assert_k3t_close`` at the tiers) and at ``highest``
    within OFFLINE_TOL of the CPU port; the steady-state SNR above the JAX
    package's floors (FINETUNED_FLOOR_DB; FINETUNED_DEFAULT_FLOOR_DB at
    ``default``) and ``StreamingPQMF``'s within FINETUNED_EARLIER_DB."""
    from pqmf_tpu_torch.parallel.training import load_pretrained_bank
    from pqmf_tpu_torch.streaming import centered_padding

    bank = load_pretrained_bank(f"hk{M}_atten100_finetuned")
    sixty = bench_signal(60 * SR)
    x_m = sixty[: len(sixty) // M * M][None, None]
    x = torch.from_numpy(x_m).to(dev)
    sp = StreamingPQMF(100, M, precision=tier, device="cuda")
    pq = PQMF(100, M, precision=tier, device="cuda")
    sp.set_weights(bank)
    pq.set_weights(bank)
    with monkeypatch.context() as m:
        _refuse_plain(m)
        y_sp = _counted({"roundtrip": 1}, {}, sp.roundtrip, x)
        y_pq = _counted({"roundtrip": 1}, {"roundtrip": 1}, pq.roundtrip, x)
    apad, spad = centered_padding(sp.hkf.shape[-1]), \
        centered_padding(sp.hki.shape[-1])
    hp, hi = pq.params["hk_poly"], pq.params["hk_ipoly"]
    ref_sp = cc.roundtrip_conv_plain(x, sp.hkf, sp.hki, M, spad, tier,
                                     pad=apad).reshape(y_sp.shape)
    ref_pq = pk.polyphase_roundtrip_plain(x, hp, hi, tier).reshape(
        y_pq.shape)
    if tier == "highest":
        torch.testing.assert_close(y_sp, ref_sp, **K12_TOL)
        torch.testing.assert_close(y_pq, ref_pq, **K6_TOL)
        cpu = {"sp": StreamingPQMF(100, M, device="cpu"),
               "pq": PQMF(100, M, device="cpu")}
        for p in cpu.values():
            p.set_weights(bank)
        torch.testing.assert_close(y_sp.cpu(), cpu["sp"].roundtrip(x_m),
                                   **OFFLINE_TOL)
        torch.testing.assert_close(y_pq.cpu(), cpu["pq"].roundtrip(x_m),
                                   **OFFLINE_TOL)
    else:
        assert_k3t_close(y_sp, ref_sp, cc.strided_analysis_conv(
            x, sp.hkf, M, pad=apad), sp.hki, tier)
        assert_k3t_close(y_pq, ref_pq, pk.polyphase_analysis(
            x, hp, pq._w2), hi, tier)
    floor = (FINETUNED_DEFAULT_FLOOR_DB if tier == "default"
             else FINETUNED_FLOOR_DB[M])
    for what, y, delay in [("StreamingPQMF", y_sp, sp.centered_delay),
                           ("PQMF", y_pq, 0)]:
        assert y.shape == x_m.shape and torch.isfinite(y).all(), what
        db = aligned_roundtrip_snr_db(x_m[0, 0], y[0, 0].cpu().numpy(),
                                      delay,
                                      edge_trim=int(bank["hk"].shape[-1]))
        print(f"fine-tuned M={M} {what} [{tier}] 60 s: {db:.4f} dB")
        assert db > floor, (what, db)
        if what == "StreamingPQMF" and (M, tier) in FINETUNED_EARLIER_DB:
            earlier, within = FINETUNED_EARLIER_DB[M, tier]
            assert abs(db - earlier) <= within, (db, earlier)


def test_wrapper_and_its_artifact_match_cpu(dev, monkeypatch, tmp_path):
    """``PQMFWrapper.process`` on a block of 8192 on the card, and the same
    wrapper saved and reloaded there (``save_artifact`` /
    ``load_artifact``), every plain version refused: one K1 and one K2 a
    call, both outputs within K12_TOL of the CPU port."""
    from pqmf_tpu_torch import load_artifact, save_artifact

    block = _audio(BLOCK, 5)[None]
    want = PQMFWrapper(100, 16, BLOCK, device="cpu").process(block)
    w = PQMFWrapper(100, 16, BLOCK, device="cuda")
    _refuse_plain(monkeypatch)
    live = _counted({"analysis": 1, "synthesis": 1}, {}, w.process, block)
    save_artifact(w, str(tmp_path / "wrapper"))
    reloaded, _ = load_artifact(str(tmp_path / "wrapper"), device="cuda")
    again = _counted({"analysis": 1, "synthesis": 1}, {}, reloaded.process,
                     block)
    for got in (live, again):
        for g, c in zip(got, want):
            torch.testing.assert_close(g.cpu(), c, **K12_TOL)


# each CLI on a 10 s wav with --device cuda: its arguments (after the
# input) and the wavs it writes, by their shapes (None: a 10 s file padded
# to whole blocks of 8192)
CLI_RUNS = {
    "vocoder": (["{t}/pvoc.wav", "--n_steps", "4"],
                {"pvoc.wav": 10 * SR}),
    "ps_torchaudio": (["--out_dir", "{t}/ta", "--shifts", "ta"],
                      {"ta/ta_pitchshifted.wav": None,
                       "ta/reconstruido.wav": None}),
    "blocks": (["--out_dir", "{t}/b", "--shifts", "pvoc"],
               {"b/blocktest_pitchshifter.wav": 10 * SR,
                "b/nonblock_pitchshifter.wav": 10 * SR}),
    "blocks --scan": (["--scan", "--out_dir", "{t}/s", "--shifts", "pvoc"],
                      {"s/blocktest_pitchshifter.wav": 10 * SR,
                       "s/blocktest_recontructed.wav": 10 * SR}),
    "export_pvoc": (["--out_dir", "{t}/art", "--seed", "0", "--save_audio",
                     "--audio_dir", "{t}/pv"],
                    {"pv/phasevocoder.wav": None}),
    "export_pqmf": (["--out_dir", "{t}/art", "--audio_dir", "{t}"],
                    {"reconstruido.wav": None}),
    "export_pqmf --stablehlo": (["--out_dir", "{t}/art", "--audio_dir",
                                 "{t}/audio", "--stablehlo"],
                                {"art/process.pt2": 0}),
    "export_pvoc --stablehlo": (["--out_dir", "{t}/art", "--audio_dir",
                                 "{t}/audio", "--stablehlo"],
                                {"art/pitchshift.pt2": 0}),
}


@pytest.mark.parametrize("cli", sorted(CLI_RUNS))
def test_cli_runs_on_the_card(dev, monkeypatch, tmp_path, cli):
    """Each CLI with ``--device cuda`` on a 10 s wav exits 0 and writes its
    outputs at 44.1 kHz, of their length, finite and not silent (peak >
    0.01; ``export_pqmf``'s reconstruction > 0.1); every plain version
    refused but under ``--stablehlo`` (the export traces the wrapper),
    which writes its program. ``export_pqmf`` (forward, inverse, process)
    launches two K1 and two K2."""
    import importlib

    from pqmf_tpu_torch.utils.audio import read_wav, write_wav

    name, *flag = cli.split()
    wav = str(tmp_path / "in.wav")
    write_wav(wav, _audio(10 * SR, 10) * 0.5, SR)
    args, outputs = CLI_RUNS[cli]
    shifts = {"ta": ",".join(str(v) for v in TA_SHIFTS16),
              "pvoc": ",".join(str(v) for v in SHIFTS16)}
    args = [shifts.get(a, a.format(t=tmp_path)) for a in args]
    args = ([wav] if name in ("vocoder", "ps_torchaudio", "blocks")
            else ["--input", wav]) + args + ["--device", "cuda"]
    main = importlib.import_module(f"pqmf_tpu_torch.cli.{name}").main
    if "--stablehlo" not in flag:
        _refuse_plain(monkeypatch)
    cc.reset_launches()
    assert main(args) == 0, cli
    torch.cuda.synchronize()
    if name == "export_pqmf" and not flag:
        assert cc.LAUNCHES == _launches({"analysis": 2, "synthesis": 2})
    padded = -(-10 * SR // BLOCK) * BLOCK
    for rel, n in outputs.items():
        path = tmp_path / rel
        if n == 0:  # a program
            assert path.stat().st_size > 0, rel
            continue
        y, sr = read_wav(str(path))
        assert sr == SR and y.shape == (1, n or padded), (rel, y.shape)
        peak = 0.1 if name == "export_pqmf" else 0.01
        assert np.isfinite(y).all() and np.abs(y).max() > peak, rel


# ---------------------------------------------------------------------------
# the precision tiers: K1t, K2t, K3t (csrc/cached_conv_tc.cu)
# ---------------------------------------------------------------------------

def assert_k3t_close(got, ref, sub, w_syn, tier):
    """K3t against its plain version: K1t's and K2t's bar at bf16x3 (the
    f32 mid is split again, and where it differs from the plain version's
    by an f32 ulp the lo half's rounding moves by one of its ulps, 2^-17 of
    the mid, on about 2^-6 of the mids); at default the bound of a flipped
    bf16 rounding of the mid (module docstring)."""
    if tier == "bf16x3":
        torch.testing.assert_close(got, ref, **K3T_BF16X3_TOL)
        return
    M = w_syn.shape[0]
    ulp = 2.0 ** (torch.floor(torch.log2(sub.abs().max())).item() - 7)
    bound = ulp * w_syn.abs().sum(dim=(1, 2)).max().item() * M
    err = (got - ref).abs()
    assert err.max().item() <= bound + K3_TOL["atol"], (err.max(), bound)
    # all but k3t_default_off(M) of the outputs within K3_TOL
    off = (err > K3_TOL["atol"]).float().mean().item()
    print(f"K3T_OFF M={M} shape={tuple(got.shape)} off={off:.6f}")
    assert off <= k3t_default_off(M), (M, off)


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
            cc.analysis_conv_plain(x, hkf, M, fuse, precision=tier), **K12_TOL)
    sub = F.pad(cc.strided_analysis_conv(x, hkf, M), (Ks // 2, Ks // 2))
    for fuse, off in [(True, -(Ks // 2)), (True, -15), (True, 3),
                      (False, 0)]:
        torch.testing.assert_close(
            cc.dense_synthesis_conv(sub, hki, fuse, off, mxu_precision=tier),
            cc.synthesis_conv_plain(sub, hki, fuse, off, precision=tier),
            **K12_TOL)
    if cc.fused_roundtrip_supported(M, Ka, Ks, tier):
        for pad in [(Ks // 2, Ks // 2), (3, 0), (0, 40)]:
            assert_k3t_close(
                cc.fused_roundtrip_conv(x, hkf, hki, M, pad, tier),
                cc.roundtrip_conv_plain(x, hkf, hki, M, pad, tier),
                sub, hki, tier)
    torch.cuda.synchronize()


@pytest.mark.parametrize("tier", TIERS)
def test_tier_plans_mirror_the_source(dev, tier):
    """The tier kernels' gates and launch plans are the CUDA source's
    (``pqmf_tc_smem_bytes``, ``pqmf_tc_launch_plan``), over a grid of
    shapes and at the main paths' (``_main_plans_mirror``)."""
    import ctypes

    lib = _build.load()
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = (ctypes.c_longlong * 8)()
    passes = {"bf16x3": 3, "default": 1}[tier]
    for M, Ka, Ks in [(8, 257, 17), (16, 513, 33), (32, 1025, 33),
                      (64, 2049, 33), (2, 65, 33), (16, 512, 32),
                      (16, 9001, 600)]:
        for i, which in enumerate(("analysis", "synthesis", "roundtrip"), 1):
            for Mb in ({M, max(2, M // 2)} if i == 1 else {M}):
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
    _main_plans_mirror(lib, n_sms, tier)


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
                got, cc.analysis_conv_plain(x, w, 16, True, pad, tier),
                **K12_TOL)
    for T_out in (64 + edge, 3 * 64 + edge):
        x = torch.randn(B, 16, T_out + Ks - 1, generator=g).to(dev)
        for off in (-15, -16, 0):
            torch.testing.assert_close(
                cc.dense_synthesis_conv(x, hki, True, off, tier),
                cc.synthesis_conv_plain(x, hki, True, off, tier), **K12_TOL)
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
        a, cc.analysis_conv_plain(x, wa, M, True, (M, M), tier), **K12_TOL)
    torch.testing.assert_close(
        y, cc.synthesis_conv_plain(s, ws, True, -3, tier), **K12_TOL)
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
        pk.polyphase_analysis_plain(x, hp, tier), **K12_TOL)
    torch.testing.assert_close(
        pk.polyphase_synthesis(s, hi, mxu_precision=tier),
        pk.polyphase_synthesis_plain(s, hi, tier), **K12_TOL)
    L = hp.shape[-1]
    if pk.roundtrip_supported(M, L * M, L, tier):
        got = pk.polyphase_roundtrip(x, hp, hi, mxu_precision=tier)
        ref = pk.polyphase_roundtrip_plain(x, hp, hi, tier)
        if tier == "bf16x3":
            torch.testing.assert_close(got, ref, **K12_TOL)
        else:
            assert_k3t_close(got, ref, pk.polyphase_analysis(x, hp), hi,
                             tier)
    torch.cuda.synchronize()


@pytest.mark.parametrize("tier", ["highest", *TIERS])
@pytest.mark.parametrize("M", [4, 16, 32, 64])
def test_k4_without_mask_matches_plain(dev, tier, M):
    """K4 (K4t at a tier, reading its kept bank) with ``fuse_mask=False``
    launches K1 (K1t) once without the sign mask: equal to the plain
    version without it, and not to the masked output; at [2, 1, 300 M],
    host blocks of B = 1 and 16 and (M = 16) the 60 s signal, output
    memory NaN-filled."""
    pq = PQMF(100, M, device="cuda")
    hp, w2 = pq.params["hk_poly"], pq._w2
    bank = (None if tier == "highest"
            else cc.arrange_tc_bank(w2, "analysis", tier))
    g = torch.Generator().manual_seed(M * 11)
    xs = [torch.randn(B, 1, T, generator=g).to(dev)
          for B, T in ((2, M * 300), (1, BLOCK), (16, BLOCK))]
    if M == 16:
        xs.append(torch.from_numpy(bench_signal(60 * SR)).to(dev)[None, None])
    for x in xs:
        _nan_fill()
        cc.reset_launches()
        pk.reset_launches()
        got = pk.polyphase_analysis(x, hp, w2, fuse_mask=False,
                                    mxu_precision=tier, tc_bank=bank)
        torch.cuda.synchronize()
        assert cc.LAUNCHES["analysis"] == 1 and pk.LAUNCHES["analysis"] == 1
        assert torch.isfinite(got).all()
        torch.testing.assert_close(
            got, pk.polyphase_analysis_plain(x, hp, tier, fuse_mask=False),
            **K12_TOL)
    assert not torch.equal(got, pk.polyphase_analysis(
        x, hp, w2, mxu_precision=tier, tc_bank=bank))


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
        cc.analysis_conv_plain(x1, w1, 1, True, (5, 2), tier), **K12_TOL)
    ws = torch.randn(4, 1, 33, generator=g).to(dev)
    s = torch.randn(2, 1, 300, generator=g).to(dev)
    torch.testing.assert_close(
        cc.dense_synthesis_conv(s, ws, False, 0, tier),
        cc.synthesis_conv_plain(s, ws, False, 0, tier), **K12_TOL)


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
    (persistent blocks), the centered pad in the kernel, output memory
    NaN-filled before each call; a kept bank gives the bits of one arranged
    for the call. At M = 16 also the main paths' banks and pads: K1t over
    the offline ``w2`` at (256, 240), a lopsided pad and a band shard of 6
    bands; K2t with in-kernel pads and offsets."""
    g = torch.Generator().manual_seed(M * 31 + B)
    wa, ws = _tier_bank(M, dev, g)
    S, Ka, Ks = max(M, 1), wa.shape[-1], ws.shape[-1]
    # K1t: (bank, pad); K2t: (pad, x_offset, input scale)
    ana = [(wa, (Ka // 2, Ka // 2))]
    syn = [((Ks // 2, Ks // 2), 3, 1 / S ** 0.5)]
    if M == 16:
        hp = torch.tensor(fb.build_filterbank(100, 16)["hk_poly"])
        ana += [(pk.analysis_weights(hp).to(dev), (256, 240)), (wa, (7, 3)),
                (wa[:6].contiguous(), (0, 0))]
        syn += [((16, 16), 0, 1.0), ((15, 16), 0, 1.0), ((0, 0), -15, 1.0),
                ((0, 0), 3, 1.0)]
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def close(got, ref, what):
        torch.cuda.synchronize()
        assert got.shape == ref.shape and torch.isfinite(got).all(), what
        torch.testing.assert_close(got, ref, **K12_TOL,
                                   msg=lambda m: f"{what}: {m}")

    for t_probe in (512, -(-n_sms * 256 // B) + 64):
        for w, pad in ana:
            Mb, K = w.shape[0], w.shape[-1]
            fuse = Mb % 2 == 0
            tile = cc.launch_plan("analysis", B, S, Mb, K, 0, t_probe,
                                  n_sms=n_sms, precision=tier)[4]
            kept = cc.arrange_tc_bank(w, "analysis", tier)
            for edge in (-1, 0, 1):
                T_out = (t_probe // tile) * tile + edge
                x = torch.randn(B, 1, (T_out - 1) * S + K - sum(pad),
                                generator=g).to(dev)
                what = f"K1t Mb={Mb} K={K} pad={pad} T_out {T_out}"
                _nan_fill()
                got = cc.strided_analysis_conv(x, w, S, fuse, pad, tier, kept)
                close(got, cc.analysis_conv_plain(x, w, S, fuse, pad, tier),
                      what)
                _nan_fill()
                assert torch.equal(got, cc.strided_analysis_conv(
                    x, w, S, fuse, pad, tier)), f"kept bank, {what}"
        Ms, Mi = ws.shape[0], ws.shape[1]
        fuse = Mi % 2 == 0
        tile = cc.launch_plan("synthesis", B, Ms, Mi, 0, Ks, t_probe,
                              n_sms=n_sms, precision=tier)[4]
        kept = cc.arrange_tc_bank(ws, "synthesis", tier)
        for edge in (-1, 0, 1):
            T_out = (t_probe // tile) * tile + edge
            for pad, off, scale in syn:
                x = torch.randn(B, Mi, T_out + Ks - 1 - sum(pad),
                                generator=g).to(dev) * scale
                what = f"K2t T_out {T_out} pad={pad} x_offset={off}"
                _nan_fill()
                got = cc.dense_synthesis_conv(x, ws, fuse, off, tier, pad,
                                              kept)
                close(got, cc.synthesis_conv_plain(x, ws, fuse, off, tier,
                                                   pad), what)
                _nan_fill()
                assert torch.equal(got, cc.dense_synthesis_conv(
                    x, ws, fuse, off, tier, pad)), f"kept bank, {what}"


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
        torch.testing.assert_close(sub.cpu(), cpu.forward(x), **K12_TOL)
        after = gpu.inverse(sub).cpu()
        torch.testing.assert_close(after, cpu.inverse(sub.cpu()), **K12_TOL)
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
            got, cc.synthesis_conv_plain(x, hki, True, off, tier, pad),
            **K12_TOL)


# ---------------------------------------------------------------------------
# K3t redesigned: kept arranged banks, call-sized plans, the analysis pad of
# K3/K3t in the kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("B", [1, 16, 215])
@pytest.mark.parametrize("M", [2, 4, 8, 16])
def test_k3t_at_its_plans_tiles(dev, tier, B, M):
    """K3t against its plain version at T_out one short of, at and one past
    a multiple of the tile its plan takes, for a host block (tiles of 16-64
    steps, split reductions), a whole file and the 60 s signal's length
    (persistent tiles) and ``stream_ola``'s 215 blocks of 4096, with the
    centered analysis pad in the kernel and the kept banks; output memory
    NaN-filled; kept and per-call banks give the same bits."""
    hkf, hki = _bank(M, dev)
    Ka, Ks = hkf.shape[-1], hki.shape[-1]
    pad, spad = (Ka // 2, Ka // 2), (Ks // 2, Ks // 2)
    kept = (cc.arrange_tc_bank(hkf, "analysis", tier),
            cc.arrange_tc_bank(hki, "synthesis", tier))
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator().manual_seed(M * 7 + B)
    probes = {1: (512, -(-n_sms * 256 // B) + 64, 60 * SR // 16),
              16: (512, -(-n_sms * 256 // B) + 64), 215: (4096 // 16,)}[B]
    for t_probe in probes:
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
        torch.testing.assert_close(got, ref, **K12_TOL)
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
    with the flagship's and lopsided syn_pads, the 60 s signal with the
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
            torch.testing.assert_close(got.cpu(), ref, **K12_TOL)
        else:
            assert_k3t_close(got.cpu(), ref, sub, w_syn, tier)


def test_tuned_64_band_files_match_the_plain_reference(dev, monkeypatch):
    """The ``pqmf64.files`` cell's call: ``PQMF(100, 64)`` with the
    committed fine-tuned bank installed by ``set_weights``, one
    ``roundtrip`` of 8 clips of 60 s (2,645,952 samples, a multiple of 64)
    on the card. Exactly one K6 and one K3, counted once in
    ``KERNELS["K3"]`` and once in ``CLUSTERS["K3"]`` (the cluster kernel),
    every plain version refused; each clip within the cell's limit
    (2e-5 relative) of the benchmark's plain reference fed the same
    committed bank (``bank.polyphase_roundtrip``, cuDNN in full float32)."""
    from benchmark import audio
    from benchmark.reference import bank, tuned_bank
    from pqmf_tpu_torch.parallel.training import load_pretrained_bank

    name = "hk64_atten100_finetuned"
    pq = PQMF(100, 64, device=dev)
    pq.set_weights(load_pretrained_bank(name))
    T = 60 * SR - 60 * SR % 64
    x = audio.rows(8, T, 2**31 + 26, SR, dev)
    with monkeypatch.context() as mp:
        _refuse_plain(mp)
        cc.reset_launches()
        pk.reset_launches()
        y = pq.roundtrip(x[:, None])
        torch.cuda.synchronize()
    assert pk.LAUNCHES == _launches({"roundtrip": 1})
    assert cc.LAUNCHES == _launches({"roundtrip": 1})
    assert cc.KERNELS == {**dict.fromkeys(cc.KERNELS, 0), "K3": 1}
    assert cc.CLUSTERS == {"K3": 1, "K3t": 0}
    assert y.shape == (8, 1, T)
    hk = tuned_bank.load(name)
    for b in range(8):
        r = bank.polyphase_roundtrip(x[b:b + 1], hk)
        rel = (y[b].reshape(-1) - r.reshape(-1)).norm() / r.norm()
        assert rel.item() <= 2e-5, (b, rel.item())


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


def test_committed_recipe_on_the_card(dev):
    """The committed banks' recipe (``RECIPE``: 8000 graphed Adam steps,
    lr 2e-5 cosine, batch 4, length 8192, seed 0) on the card: its losses
    finite and falling, no K1/K2/K3 while training; the steady-state SNR
    on the 60 s signal through ``StreamingPQMF.roundtrip`` (one K3 each)
    of the trained bank >= TRAINED_SNR_DB with its worst stopband <=
    TRAINED_STOPBAND_DB, of the designed bank DESIGNED_STEADY_DB, and of
    the committed bank >= TRAINED_SNR_DB."""

    from pqmf_tpu_torch.parallel import training as tt

    cc.reset_launches()
    t0 = time.perf_counter()
    params, losses = tt.finetune_filterbank(100, 16, **RECIPE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_launches = dict(cc.LAUNCHES)
    cc.reset_launches()
    snr = {name: tt.roundtrip_snr(p, 100, 16, bench_signal(60 * SR))
           for name, p in [("designed", None),
                           ("committed", tt.load_pretrained_bank()),
                           ("trained", params)]}
    torch.cuda.synchronize()
    stopband = tt.worst_stopband_db(params["hk"])
    print(f"recipe on {torch.cuda.get_device_name(0)}: {wall:.2f} s, loss "
          f"{losses[0]:.4e} -> {losses[-1]:.4e}; steady-state SNR {snr} dB, "
          f"trained stopband {stopband:.2f} dB")
    assert losses.shape == (RECIPE["steps"],) and np.isfinite(losses).all()
    assert losses[-1] < losses[0], (losses[0], losses[-1])
    assert all(v == 0 for v in train_launches.values()), train_launches
    assert cc.LAUNCHES == _launches({"roundtrip": 3}), dict(cc.LAUNCHES)
    assert snr["trained"] >= TRAINED_SNR_DB, snr
    assert stopband <= TRAINED_STOPBAND_DB, stopband
    assert abs(snr["designed"] - DESIGNED_STEADY_DB[0]) \
        <= DESIGNED_STEADY_DB[1], snr
    assert snr["committed"] >= TRAINED_SNR_DB, snr


def test_remat_step_equals_a_plain_step_on_the_card(dev):
    """A train step with the loss recomputed in the backward equals a plain
    step (the JAX package's remat test): |dloss| < 1e-7, max|dhk| <=
    1e-7."""
    from pqmf_tpu_torch.parallel import training as tt

    hk = fb.build_filterbank(70, 4)["hk"]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 1, 256)).astype(np.float32)).to(dev)
    res = []
    for remat in (False, True):
        init, step = tt.make_train_step(remat=remat)
        res.append(step(init(hk), x))
    dl = abs(res[0][1].item() - res[1][1].item())
    dhk = (res[0][0].hk - res[1][0].hk).abs().max().item()
    assert dl < 1e-7 and dhk <= 1e-7, (dl, dhk)


# -- the ahead-of-time artifact on the card -----------------------------------

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
    """The torch.export program saved on the card: its manifest names its
    method, length and device; it calls K1 and K2 (and the middle's three
    kernels in the flagship) as operators; every constant and buffer lies
    on the card. Reloaded there it runs 8 blocks (the flagship's tail
    carried) through its graph and through ``program.eager`` (the module
    without its graph), each launching one K1 and one K2 a block with
    every plain version refused, and both equal the live wrapper bit for
    bit."""
    from pqmf_tpu_torch.export import load_stablehlo, save_artifact

    w = _aot_wrapper(kind, tier)
    path = save_artifact(w, str(tmp_path / "a"), with_stablehlo=True)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    (method, spec), = manifest["torch_export"].items()
    assert spec == {"length": 8192, "device": "cuda"}, spec
    assert "stablehlo" not in manifest
    ep = torch.export.load(os.path.join(path, method + ".pt2"))
    ops = [str(n.target) for n in ep.graph.nodes
           if n.op == "call_function" and "pqmf_tpu_torch" in str(n.target)]
    middle = ([f"pqmf_tpu_torch.pv_{k}.default"
               for k in ("frame", "resynth", "spectral")]
              if kind == "flagship" else [])
    assert sorted(ops) == sorted(["pqmf_tpu_torch.analysis_conv.default",
                                  "pqmf_tpu_torch.synthesis_conv.default",
                                  *middle]), ops
    assert all(c.device.type == "cuda" for c in (*ep.constants.values(),
                                                 *ep.state_dict.values()))
    program = load_stablehlo(path)
    g = torch.Generator().manual_seed(3)
    xs = [torch.randn(1, 1, 8192, generator=g).to(dev) * 0.3
          for _ in range(8)]
    tail0 = w.init_state()["prev_tail"] if kind == "flagship" else None

    def run(fn):
        """The 8 blocks through ``fn``, counted: the outputs (and the
        flagship's last tail)."""
        ys, tail = [], tail0
        cc.reset_launches()
        with pytest.MonkeyPatch.context() as mp:
            _refuse_plain(mp)
            for x in xs:
                if kind == "flagship":
                    tail, y = fn(tail, x[0])
                    ys.append(y)
                elif kind == "ta":
                    ys.append(fn(x))
                else:
                    ys.extend(fn(x))
        torch.cuda.synchronize()
        assert dict(cc.LAUNCHES) == {"analysis": 8, "synthesis": 8,
                                     "roundtrip": 0}, (kind, tier)
        return ys + ([tail] if kind == "flagship" else [])

    # the first block runs the module eagerly, the rest replay its graph:
    # all equal the module run without a graph
    got = run(program)
    _bit_equal(got, run(program.eager), f"AOT {kind} graph vs eager [{tier}]")
    want, tail_l = [], tail0
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
        want.append(tail_l)
    assert len(got) == len(want)
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


# the child of the fresh-process reload: it imports only pqmf_tpu_torch's
# load_stablehlo (and the launch counters), no wrapper, and runs each
# program over the blocks in inputs.npz, the flagship's tail carried
_AOT_CHILD = r"""
import json, os, sys
import numpy as np, torch
from pqmf_tpu_torch.export import load_stablehlo
from pqmf_tpu_torch.kernels import cached_conv as cc
td, names = sys.argv[1], json.loads(sys.argv[2])
with np.load(os.path.join(td, "inputs.npz")) as z:
    blocks = torch.from_numpy(z["blocks"]).to("cuda")
counts = {}
for name in names:
    program = load_stablehlo(os.path.join(td, name), device="cuda")
    cc.reset_launches()
    if name.startswith("flagship"):
        with open(os.path.join(td, name, "manifest.json")) as f:
            spec = json.load(f)["state_spec"]["prev_tail"]
        tail, ys = torch.zeros(spec, device="cuda"), []
        for b in blocks:
            tail, y = program(tail, b[0])
            ys.append(y)
        outs = {"y": torch.stack(ys), "tail": tail}
    elif name == "ta":
        outs = {"y": torch.stack([program(b) for b in blocks])}
    else:
        pairs = [program(b) for b in blocks]
        outs = {"rec": torch.stack([r for r, _ in pairs]),
                "sub": torch.stack([s for _, s in pairs])}
    torch.cuda.synchronize()
    counts[name] = dict(cc.LAUNCHES)
    np.savez(os.path.join(td, name + "_child.npz"),
             **{k: v.cpu().numpy() for k, v in outs.items()})
print(json.dumps(counts))
"""


def test_aot_programs_reload_in_a_fresh_process_on_the_card(dev, tmp_path):
    """The flagship at each tier, ``PQMFWrapper`` and the TA wrapper (16
    bands, 8192 blocks) saved with their ``torch.export`` program and
    reloaded in a fresh process that imports only ``load_stablehlo``, 8
    blocks each (the flagship's tail carried): one K1 and one K2 a block,
    and every output and tail within 1e-6 of the live wrapper."""

    from pqmf_tpu_torch.export import save_artifact

    blocks = np.stack(np.split(_audio(8 * BLOCK, 5), 8, axis=-1))[:, None]
    np.savez(tmp_path / "inputs.npz", blocks=blocks)  # [8, 1, 1, T]
    xs = torch.from_numpy(blocks).to(dev)
    wrappers = {f"flagship_{t}": _aot_wrapper("flagship", t)
                for t in ("highest", *TIERS)}
    wrappers["plain"] = _aot_wrapper("plain", "highest")
    wrappers["ta"] = _aot_wrapper("ta", "highest")
    lives = {}
    for name, w in wrappers.items():
        save_artifact(w, str(tmp_path / name), with_stablehlo=True)
        if name.startswith("flagship"):
            state, ys = w.init_state(), []
            for b in xs:
                state, y = w.pitchshift_fn(state, b[0])
                ys.append(y)
            lives[name] = {"y": torch.stack(ys), "tail": state["prev_tail"]}
        elif name == "ta":
            lives[name] = {"y": torch.stack([w.pitchshifter(b) for b in xs])}
        else:
            pairs = [w.process(b) for b in xs]
            lives[name] = {"rec": torch.stack([r for r, _ in pairs]),
                           "sub": torch.stack([s for _, s in pairs])}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    child = subprocess.run(
        [sys.executable, "-c", _AOT_CHILD, str(tmp_path),
         json.dumps(list(wrappers))], capture_output=True, text=True,
        timeout=600, cwd=root)
    assert child.returncode == 0, child.stderr[-4000:]
    counts = json.loads(child.stdout.strip().splitlines()[-1])
    for name, live in lives.items():
        assert counts[name] == _launches({"analysis": 8, "synthesis": 8}), \
            (name, counts[name])
        with np.load(tmp_path / f"{name}_child.npz") as z:
            err = max((torch.from_numpy(z[k]).to(dev) - v).abs().max().item()
                      for k, v in live.items())
        assert err <= 1e-6, (name, err)


def test_native_blocks_cli_on_the_card(dev, monkeypatch, tmp_path):
    """The native C data layer on the card's machine: the library builds;
    the ``blocks`` CLI's host loop (10 s, 4096 / 2048, the flagship on the
    card) reads its wav, overlap-adds every block and writes its three
    wavs through it; the same run with the library withheld (the NumPy
    path) writes the same arrays and files bit for bit; the library's
    encoder, decoder and OLA equal the NumPy forms on 2^20 in-range
    samples."""
    from pqmf_tpu_torch import native
    from pqmf_tpu_torch.cli import blocks as blocks_cli
    from pqmf_tpu_torch.utils import audio

    path, lib = native.build(), native.get()
    assert path is not None and lib is not None, "the C library did not build"
    wav = str(tmp_path / "in.wav")
    audio.write_wav(wav, _audio(10 * SR, 14) * 0.5, SR)
    n_frames = -(-(10 * SR - 4096) // 2048) + 1
    written, calls, real_write = {}, {}, audio.write_wav
    for arm in ("C", "NumPy"):
        with monkeypatch.context() as m:
            def capture(p, x, sr, subtype="PCM_16", arm=arm):
                written.setdefault(arm, {})[os.path.basename(p)] = \
                    np.array(x)
                real_write(p, x, sr, subtype)

            m.setattr(audio, "write_wav", capture)
            if arm == "NumPy":
                m.setattr(native, "get", lambda: None)
                m.setattr(audio, "_native", lambda: None)
            native.CALLS.clear()
            assert blocks_cli.main([
                wav, "--out_dir", str(tmp_path / arm), "--block", "4096",
                "--overlap", "2048", "--shifts",
                ",".join(str(v) for v in SHIFTS16), "--device", "cuda"]) == 0
            torch.cuda.synchronize()
            calls[arm] = dict(native.CALLS)
    assert calls == {"C": {"pcm16_to_f32": 1, "ola_accumulate": 2 * n_frames,
                           "f32_to_pcm16": 3}, "NumPy": {}}, calls
    assert len(written["C"]) == 3
    for name, a in written["C"].items():
        b = written["NumPy"][name]
        assert a.shape == b.shape == (1, 10 * SR) and np.array_equal(a, b), \
            name
        assert (tmp_path / "C" / name).read_bytes() == \
            (tmp_path / "NumPy" / name).read_bytes(), name
    x = np.random.default_rng(16).uniform(-1.0, 1.0, 1 << 20).astype(
        np.float32)
    pcm = lib.f32_to_pcm16(x)
    assert np.array_equal(
        pcm, (np.clip(x, -1.0, 1.0) * 32767.0).round().astype("<i2"))
    assert np.array_equal(lib.pcm16_to_f32(pcm.tobytes()),
                          pcm.astype(np.float32) / 32768.0)
    acc, nrm = np.zeros(1 << 16, np.float32), np.zeros(1 << 16, np.float32)
    acc_np, nrm_np = acc.copy(), nrm.copy()
    win = x[:4096] ** 2
    for i in range(0, acc.size - 4096 + 1, 2048):
        blk = x[i:i + 4096]
        lib.ola_accumulate(acc, nrm, blk, win, i)
        acc_np[i:i + 4096] += blk * win
        nrm_np[i:i + 4096] += win * win
    assert np.array_equal(acc, acc_np) and np.array_equal(nrm, nrm_np)


def test_gpu_checks_pass(dev):
    """``tools/gpu_checks.py`` (``tools/tpu_checks.py``'s checks, one by
    one) ends in ALL PASS and exits 0 on the card. Its lines are printed
    (``-rP`` shows them): this test is the script's one run in a card
    call."""
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


def _host_blocks(n, T, seed):
    """``n`` host blocks [1, T] as NumPy arrays, as a plug-in hands them
    over."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((1, T)) * 0.3).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("tier", ["highest", *TIERS])
def test_graph_process_equals_eager(dev, tier):
    """``PQMFWrapper.process`` on 512-sample host blocks: the second call
    replays (its ``pqmf.graph.launch`` span in a trace), each replay adds
    one K1 and one K2 (K1t/K2t at a tier) to the counters, the outputs
    equal the eager body bit for bit and no later call changes them, and
    a block of 1024 captures a graph of its own."""
    w = PQMFWrapper(100, 16, 512, precision=tier, device="cuda")
    xs = _host_blocks(6, 512, 70)
    eager = [w._process_eager(torch.from_numpy(x).to(dev)) for x in xs]
    w.process(xs[0])  # the eager call, then the capture
    (prog,) = w._graphs.values()
    assert prog.launches[0] == {"analysis": 1, "synthesis": 1,
                                "roundtrip": 0}
    cc.reset_launches()
    with torch.profiler.profile() as prof:
        graph = [w.process(x) for x in xs]
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()}
    assert "pqmf.graph.launch" in names and "pqmf.graph.capture" not in names
    assert cc.LAUNCHES == {"analysis": 6, "synthesis": 6, "roundtrip": 0}
    k1, k2 = ("K1", "K2") if tier == "highest" else ("K1t", "K2t")
    assert cc.KERNELS == {**dict.fromkeys(cc.KERNELS, 0), k1: 6, k2: 6}
    flat = [t for pair in graph for t in pair]
    kept = [t.clone() for t in flat]
    _bit_equal(flat, [t for pair in eager for t in pair],
               f"process [{tier}]")
    w.process(xs[1])
    torch.cuda.synchronize()
    _bit_equal(flat, kept, "outputs after a later call")
    (x2,) = _host_blocks(1, 1024, 71)
    first, second = w.process(x2), w.process(x2)
    assert {k[:3] for k in w._graphs} == {("process", 1, 512),
                                          ("process", 1, 1024)}
    _bit_equal(list(first) + list(second),
               list(w._process_eager(torch.from_numpy(x2).to(dev))) * 2,
               f"process at 1024 [{tier}]")


def test_graph_process_follows_set_weights(dev):
    """After set_weights to the committed fine-tuned M = 16 bank the old
    graph is evicted, and the new one equals the eager body on the new
    bank (and differs from the old bank's output)."""
    from pqmf_tpu_torch.parallel.training import load_pretrained_bank

    w = PQMFWrapper(100, 16, 512, device="cuda")
    (x,) = _host_blocks(1, 512, 72)
    old = [w.process(x) for _ in range(2)]
    w.pqmf.set_weights(load_pretrained_bank("hk16_atten100_finetuned"))
    new = [w.process(x) for _ in range(2)]
    assert [k[-1] for k in w._graphs] == [1]
    _bit_equal(new[1], w._process_eager(torch.from_numpy(x).to(dev)),
               "process after set_weights")
    assert (new[1][1] - old[1][1]).abs().max().item() > 1e-4


# a replay's copies in and out are the graph's own memcpy nodes, re-pointed
# at each call's tensors (graphs.IO, csrc/graph_io.cu)


def _io():
    from pqmf_tpu_torch import graphs

    graphs.IO.update(bound=0, dispatched=0)
    return graphs.IO


def test_graph_queued_replays_equal_eager(dev):
    """Two replays queued behind a 20 ms device sleep, with no sync between
    them: the second re-points the copy nodes before the first has run,
    and each still equals the eager body bit for bit (a change to an
    instantiated graph holds only for later launches)."""
    w = _flagship16("highest", dev)
    xs = _blocks(dev, 3, 81)
    s0, _ = w.pitchshift_fn(w.init_state(), xs[0])  # eager, then capture
    se1, ye1 = w._pitchshift_fn_eager(s0, xs[1])
    se2, ye2 = w._pitchshift_fn_eager(se1, xs[2])
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)  # ~20 ms of a 1.98 GHz SM clock
    s1, y1 = w.pitchshift_fn(s0, xs[1])
    s2, y2 = w.pitchshift_fn(s1, xs[2])
    torch.cuda.synchronize()
    _bit_equal([y1, s1["prev_tail"], y2, s2["prev_tail"]],
               [ye1, se1["prev_tail"], ye2, se2["prev_tail"]],
               "queued replays")


def test_graph_replays_return_fresh_storages(dev):
    """Three replays return three distinct output storages, none the
    graph's, and the earlier outputs keep their values after the later
    replays."""
    w = _flagship16("highest", dev)
    xs = _blocks(dev, 4, 82)
    state, _ = w.pitchshift_fn(w.init_state(), xs[0])
    outs = []
    for x in xs[1:]:
        state, y = w.pitchshift_fn(state, x)
        torch.cuda.synchronize()
        outs.append((y, state["prev_tail"], y.clone(),
                     state["prev_tail"].clone()))
    (prog,) = w._graphs.values()
    graph_own = {t.untyped_storage().data_ptr()
                 for t in pytree_leaves(prog._static_out)}
    storages = [t.untyped_storage().data_ptr() for o in outs for t in o[:2]]
    assert len(set(storages)) == 6 and not graph_own & set(storages)
    torch.cuda.synchronize()
    _bit_equal([t for o in outs for t in o[:2]],
               [t for o in outs for t in o[2:]], "outputs after replays")


def test_graph_strided_block_equals_eager(dev):
    """A strided block through ``pitchshift_fn`` is made contiguous by one
    copy of its own (``IO["dispatched"]``) and equals the eager body bit
    for bit; a contiguous block at an odd storage offset (4-byte aligned)
    is read by the graph's copy node itself and equals it too."""
    w = _flagship16("highest", dev)
    wide = torch.stack(_blocks(dev, 2, 83), dim=-1).reshape(1, 2 * 8192)
    state, _ = w.pitchshift_fn(w.init_state(), _blocks(dev, 1, 84)[0])
    for x, dispatched in ((wide[:, ::2], 1),
                          (wide.view(-1)[1:8193].view(1, 8192), 0)):
        io = _io()
        sg, yg = w.pitchshift_fn(state, x)
        assert io == {"bound": 4, "dispatched": dispatched}, x.stride()
        se, ye = w._pitchshift_fn_eager(state, x)
        torch.cuda.synchronize()
        _bit_equal([yg, sg["prev_tail"]], [ye, se["prev_tail"]],
                   f"strided block {x.stride()} at {x.storage_offset()}")


@pytest.mark.parametrize("tier", ["highest", "default"])
def test_graph_replays_bind_every_leaf(dev, tier):
    """On ``pitchshift_fn`` (tail and x in, tail and y out),
    ``pitchshift_streams`` (the same over 16 streams) and ``process`` (x
    in, both outputs out) every tensor leaf of every replay is carried by
    a re-pointed copy node and none is dispatched."""
    w = _flagship16(tier, dev)
    bank = PQMFWrapper(100, 16, 512, precision=tier, device="cuda")
    xs = _blocks(dev, 4, 85)
    streams = [x[:, 0] for x in _blocks(dev, 4, 86, B=16)]
    blocks = [torch.from_numpy(b).to(dev) for b in _host_blocks(4, 512, 87)]
    s, ss = w.init_state(), w.init_streams(16)
    s, _ = w.pitchshift_fn(s, xs[0])
    ss, _ = w.pitchshift_streams(ss, streams[0])
    bank.process(blocks[0])
    io = _io()
    for x in xs[1:]:
        s, _ = w.pitchshift_fn(s, x)
    assert io == {"bound": 3 * 4, "dispatched": 0}
    io = _io()
    for x in streams[1:]:
        ss, _ = w.pitchshift_streams(ss, x)
    assert io == {"bound": 3 * 4, "dispatched": 0}
    io = _io()
    for x in blocks[1:]:
        bank.process(x)
    assert io == {"bound": 3 * 3, "dispatched": 0}
    torch.cuda.synchronize()


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
    """``scan_blocks`` over 16 pre-framed 8192 blocks is one graph a
    stream: its replay equals the loop of eager steps bit for bit (state
    too), and launches 16 K1 + 16 K2."""
    from pqmf_tpu_torch.streaming import scan_blocks

    if owner.startswith("StreamingPQMF"):
        sp = StreamingPQMF(100, 16, precision=tier, device="cuda")
        step, eager, s0 = sp.process_block, sp.process_block, sp.init_state()
        x = torch.stack(_blocks(dev, 16, 70))[:, :, None]  # [16, 1, 1, T]
        graphs_of = sp._graphs
    else:
        w = _flagship16(tier, dev)
        step, eager, s0 = (w.pitchshift_fn, w._pitchshift_fn_eager,
                           w.init_state())
        x = torch.stack(_blocks(dev, 16, 71))             # [16, 1, T]
        graphs_of = w._graphs
    state, loop = s0, []
    for b in x:
        state, y = eager(state, b)
        loop.append(y)
    first = scan_blocks(step, s0, x)
    cc.reset_launches()
    replay = scan_blocks(step, s0, x)
    torch.cuda.synchronize()
    assert cc.LAUNCHES == {"analysis": 16, "synthesis": 16, "roundtrip": 0}
    for ts, ys in (first, replay):
        _bit_equal([ys, *pytree_leaves(ts)],
                   [torch.stack(loop), *pytree_leaves(state)],
                   f"scan_blocks over {owner} [{tier}]")
    scans = [p for k, p in graphs_of.items() if k[0] == "scan_blocks"]
    assert len(scans) == 1 and scans[0].launches[0] == {
        "analysis": 16, "synthesis": 16, "roundtrip": 0}


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
    """Fifty steps of the committed recipe's loss and shapes (cosine lr
    over the fifty): the graphed step (one capture, then 49 replays) equals
    the eager capturable step bit for bit in every loss, in hk and in
    Adam's moments and count; no K1/K2/K3 runs."""
    _, init, step, hk, xs = _train(tier, remat, steps=50)
    sg, se = init(hk), init(hk)
    assert sg.optimizer.param_groups[0]["capturable"]
    cc.reset_launches()
    replays = [0]
    for i, x in enumerate(xs):
        _, lg = step(sg, x)
        _, le = step.eager(se, x)
        _bit_equal([lg], [le], f"train step loss [{tier}, remat={remat}]")
        if i == 0:  # count the replays from here on
            (prog,) = sg._graphs.values()

            def counted(leaves, outs, replay=prog._replay):
                replays[0] += 1
                replay(leaves, outs)
            prog._replay = counted
    torch.cuda.synchronize()
    assert all(v == 0 for v in cc.LAUNCHES.values())
    _same_state(sg, se, f"train state [{tier}, remat={remat}]")
    assert list(sg._graphs.values()) == [prog] and replays[0] == 49
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


# -- the (data, band) mesh ---------------------------------------------------


# Three runs of ranks spawned on the one card (one card can show correctness,
# never multi-card scaling): "nccl_1x1", a (1, 1) mesh over NCCL whose graphs
# hold the band and gradient all-reduces; "gloo_1x2" and "gloo_1x4", two and
# four ranks sharing cuda:0 over gloo (NCCL refuses two ranks on one card),
# band 2 and 4 (Mb = 8 and 4), through the steps' eager forms (gloo cannot be
# captured; the graphs must raise there).

MESH_RUNS = {"nccl_1x1": ("nccl", 1), "gloo_1x2": ("gloo", 2),
             "gloo_1x4": ("gloo", 4)}
MESH_TIMEOUT = 420  # seconds for all three runs, started together
N_BAND = 16


def _mesh_rank(rank: int, world: int, init: str, backend: str, which: str,
               out_dir: str) -> None:
    """One rank of a mesh run: writes ``<which>_<rank>.json`` (its checks,
    errors, launches and collectives) or ``.err`` (its traceback)."""
    import traceback

    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world)
    try:
        res = (_mesh_nccl() if backend == "nccl"
               else _mesh_gloo(rank, world))
        with open(os.path.join(out_dir, f"{which}_{rank}.json"), "w") as f:
            json.dump(res, f)
    except BaseException:
        with open(os.path.join(out_dir, f"{which}_{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def _mesh_counts() -> dict:
    """The kernels' launches and the collectives since the last reset."""
    from pqmf_tpu_torch import graphs

    return {**{f"K{i + 1}": cc.LAUNCHES[k] for i, k in enumerate(
        ("analysis", "synthesis", "roundtrip"))},
            **{f"K{i + 4}": pk.LAUNCHES[k] for i, k in enumerate(
                ("analysis", "synthesis", "roundtrip"))},
            **graphs.COLLECTIVES}


def _mesh_reset() -> None:
    from pqmf_tpu_torch import graphs

    torch.cuda.synchronize()
    cc.reset_launches()
    pk.reset_launches()
    graphs.reset_collectives()


def _mesh_nccl() -> dict:
    """(a) A (1, 1) mesh over NCCL at full width (atten 100, 16 bands,
    8192-sample blocks): every entry through the mesh is bit-equal to the
    unsharded entry on the card, the steps' CUDA graphs included (the band
    all-reduce and the gradient all-reduce inside the capture)."""
    from pqmf_tpu_torch.parallel import training as tt
    from pqmf_tpu_torch.parallel.sharding import ShardedPitchShift, make_mesh

    mesh = make_mesh(1, n_band=N_BAND, device_type="cuda")
    assert tuple(mesh.shape) == (1, 1), mesh.shape
    res = {"checks": {}, "launches": {}}
    on = {"device": "cuda"}
    dev = "cuda"

    def equal(what, got, want):
        got = got.to_local() if hasattr(got, "to_local") else got
        want = want.to_local() if hasattr(want, "to_local") else want
        assert got.shape == want.shape, (what, got.shape, want.shape)
        assert torch.isfinite(got).all(), what
        err = (got - want).abs().max().item()
        assert torch.equal(got, want), (what, err)
        res["checks"][what] = err

    x = torch.from_numpy(_audio(8 * BLOCK, 21)[None]).to(dev)  # [1,1,8T]
    sp, spu = (StreamingPQMF(100, N_BAND, mesh=mesh, **on),
               StreamingPQMF(100, N_BAND, **on))
    _mesh_reset()
    y = sp.roundtrip(x)
    res["launches"]["StreamingPQMF.roundtrip"] = _mesh_counts()
    equal("StreamingPQMF(mesh).roundtrip == unsharded K1+K2", y,
          spu.inverse(spu.forward(x)))
    k3 = (y.to_local() - spu.roundtrip(x)).abs().max().item()
    assert k3 <= K3_TOL["atol"], k3
    res["checks"]["StreamingPQMF(mesh).roundtrip vs unsharded K3"] = k3
    pq, pqu = PQMF(100, N_BAND, mesh=mesh, **on), PQMF(100, N_BAND, **on)
    _mesh_reset()
    sub = pq.forward(x)
    rec = pq.inverse(sub)
    rt = pq.roundtrip(x)
    res["launches"]["PQMF forward, inverse, roundtrip"] = _mesh_counts()
    equal("PQMF(mesh).forward", sub, pqu.forward(x))
    equal("PQMF(mesh).inverse", rec, pqu.inverse(pqu.forward(x)))
    equal("PQMF(mesh).roundtrip == K4+K5", rt, pqu.inverse(pqu.forward(x)))
    blk = x[..., :BLOCK]
    wr, wru = (PQMFWrapper(100, N_BAND, mesh=mesh, **on),
               PQMFWrapper(100, N_BAND, **on))
    _mesh_reset()
    r_m, s_m = wr.process(blk)
    res["launches"]["PQMFWrapper.process"] = _mesh_counts()
    r_u, s_u = wru.process(blk)
    equal("PQMFWrapper(mesh).process rec", r_m, r_u)
    equal("PQMFWrapper(mesh).process sub", s_m, s_u)

    # the graphed ShardedPitchShift step: 8 blocks, the tail carried
    w = PQMFPitchShiftWrapper(100, N_BAND, BLOCK, SR,
                              shifts_in_semitones=SHIFTS16, **on)
    sh = ShardedPitchShift(w, mesh)
    blocks = torch.from_numpy(_audio(8 * BLOCK, 22)).to(dev).reshape(
        8, 1, 1, BLOCK)
    _mesh_reset()
    tail, ys = sh.init_state(), []
    for b in blocks:
        tail, yb = sh(tail, b)
        ys.append(yb.to_local())
    res["launches"]["ShardedPitchShift x8 (graph)"] = _mesh_counts()
    prog = next(iter(sh.wrapper._graphs.values()))
    res["sharded_step_graph"] = {
        "collectives_a_replay": prog.collectives,
        "launches_a_replay": prog.launches, "capture": prog.stats}
    st, ys_u = w.init_state(), []
    for b in blocks:
        st, yb = w.pitchshift_fn(st, b)
        ys_u.append(yb)
    equal("ShardedPitchShift (graph) y x8", torch.stack(ys),
          torch.stack(ys_u))
    equal("ShardedPitchShift (graph) tail", tail, st["prev_tail"])
    te, ye = sh.eager(sh.init_state(), blocks[0])
    equal("ShardedPitchShift eager == graph", ye, ys[0])

    # the TA block through the wrapper's mesh, graphed
    ta = PQMFPitchShiftWrapperTA(100, N_BAND, BLOCK, SR,
                                 shifts_in_semitones=TA_SHIFTS16, mesh=mesh,
                                 **on)
    tau = PQMFPitchShiftWrapperTA(100, N_BAND, BLOCK, SR,
                                  shifts_in_semitones=TA_SHIFTS16, **on)
    _mesh_reset()
    y_ta = [ta.pitchshifter(blocks[i]) for i in range(3)]
    res["launches"]["TA pitchshifter x3 (graph)"] = _mesh_counts()
    for i in range(3):
        equal(f"TA(mesh) block {i}", y_ta[i], tau.pitchshifter(blocks[i]))

    # the graphed data-parallel train step over 10 steps
    hk = fb.build_filterbank(100, N_BAND)["hk"]
    loss_fn = tt.make_finetune_loss(N_BAND, hk.shape[-1])
    xs = [torch.from_numpy(a).to(dev) for a in np.random.default_rng(
        3).standard_normal((10, 4, 1, 8192)).astype(np.float32)]
    init_m, step_m = tt.make_train_step(tt.adam(2e-5), mesh=mesh,
                                        loss_fn=loss_fn, **on)
    init_u, step_u = tt.make_train_step(tt.adam(2e-5), loss_fn=loss_fn,
                                        **on)
    sm, su = init_m(hk), init_u(hk)
    _mesh_reset()
    lm = [step_m(sm, xb)[1] for xb in xs]
    res["launches"]["train step x10 (graph)"] = _mesh_counts()
    lu = [step_u(su, xb)[1] for xb in xs]
    equal("train step (mesh, graph) losses x10", torch.stack(lm),
          torch.stack(lu))
    equal("train step (mesh, graph) hk", sm.hk, su.hk)
    return res


def _mesh_gloo(rank: int, world: int) -> dict:
    """(b) ``world`` ranks sharing the card over gloo, band = world: the
    eager forms against the unsharded entries on the card (K12_TOL, >= 90
    dB, fine-tuning's tolerances), the graphs refused."""
    import torch.distributed as dist

    from pqmf_tpu_torch.parallel import training as tt
    from pqmf_tpu_torch.parallel.sharding import ShardedPitchShift, make_mesh

    dev = "cuda"
    mesh = make_mesh(world, n_band=N_BAND, device_type=dev)
    assert tuple(mesh.shape) == (1, world), mesh.shape
    Mb = N_BAND // world
    sl = slice(rank * Mb, (rank + 1) * Mb)
    res = {"Mb": Mb, "checks": {}, "launches": {}}
    on = {"device": dev}

    def graph_refused(fn, what):
        """A graphed step over gloo raises."""
        try:
            fn()
        except RuntimeError as e:
            assert "NCCL only" in str(e), e
            return
        raise AssertionError(f"a graphed {what} over gloo ran")

    def close(what, got, want, tol=K12_TOL):
        got = got.to_local() if hasattr(got, "to_local") else got
        assert got.shape == want.shape, (what, got.shape, want.shape)
        assert torch.isfinite(got).all(), what
        torch.testing.assert_close(got, want, **tol,
                                   msg=lambda m: f"{what}: {m}")
        res["checks"][what] = (got - want).abs().max().item()

    x = torch.from_numpy(_audio(8 * BLOCK, 21)[None]).to(dev)
    for tier in ("highest", "bf16x3", "default"):
        sp = StreamingPQMF(100, N_BAND, precision=tier, mesh=mesh, **on)
        spu = StreamingPQMF(100, N_BAND, precision=tier, **on)
        assert sp.hkf_shard.shape[0] == Mb and sp.hki_shard.shape[1] == Mb
        _mesh_reset()
        sub = sp.forward(x)
        y = sp.roundtrip(x)
        res["launches"][f"StreamingPQMF forward + roundtrip [{tier}]"] = \
            _mesh_counts()
        sub_u = spu.forward(x)
        close(f"StreamingPQMF(mesh).forward band shard [{tier}]", sub,
              sub_u[:, sl])
        close(f"StreamingPQMF(mesh).roundtrip [{tier}]", y,
              spu.inverse(sub_u))
    pq, pqu = PQMF(100, N_BAND, mesh=mesh, **on), PQMF(100, N_BAND, **on)
    _mesh_reset()
    sub = pq.forward(x)
    rec = pq.inverse(sub)
    res["launches"]["PQMF forward + inverse"] = _mesh_counts()
    sub_u = pqu.forward(x)
    close("PQMF(mesh).forward band shard", sub, sub_u[:, sl])
    close("PQMF(mesh).inverse", rec, pqu.inverse(sub_u))

    w = PQMFPitchShiftWrapper(100, N_BAND, BLOCK, SR,
                              shifts_in_semitones=SHIFTS16, **on)
    sh = ShardedPitchShift(w, mesh)
    blocks = torch.from_numpy(_audio(8 * BLOCK, 22)).to(dev).reshape(
        8, 1, 1, BLOCK)
    graph_refused(lambda: sh(sh.init_state(), blocks[0]),
                  "ShardedPitchShift step")
    _mesh_reset()
    tail, ys = sh.init_state(), []
    for b in blocks:
        tail, yb = sh.eager(tail, b)
        ys.append(yb.to_local())
    res["launches"]["ShardedPitchShift.eager x8"] = _mesh_counts()
    st, ys_u = w.init_state(), []
    for b in blocks:
        st, yb = w.pitchshift_fn(st, b)
        ys_u.append(yb)
    db = min(snr_db(ys_u[i].cpu().numpy(), ys[i].cpu().numpy())
             for i in range(8))
    # the whole tail from every rank's bands (gloo gathers CPU copies; a
    # shard of near-silent bands alone has no meaningful dB)
    parts = [torch.empty((Mb, w.band_overlap)) for _ in range(world)]
    dist.all_gather(parts, tail.to_local().cpu())
    tail_db = snr_db(st["prev_tail"].cpu().numpy(),
                     torch.cat(parts).numpy())
    assert db >= BAR_DB and tail_db >= BAR_DB, (db, tail_db)
    res["checks"]["ShardedPitchShift.eager y x8, min dB"] = db
    res["checks"]["ShardedPitchShift.eager tail dB"] = tail_db
    ta = PQMFPitchShiftWrapperTA(100, N_BAND, BLOCK, SR,
                                 shifts_in_semitones=TA_SHIFTS16, mesh=mesh,
                                 **on)
    graph_refused(lambda: ta.pitchshifter(blocks[0]), "TA block")

    if world == 2:  # one data-parallel step, batch 4 over 2 ranks
        hk = fb.build_filterbank(100, N_BAND)["hk"]
        loss_fn = tt.make_finetune_loss(N_BAND, hk.shape[-1])
        xb = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (4, 1, 8192)).astype(np.float32)).to(dev)
        hkt = torch.from_numpy(hk).to(dev)
        lc, gc = tt.loss_and_grad(loss_fn, hkt, xb)
        ll, gl = tt.loss_and_grad(loss_fn, hkt, xb[2 * rank:2 * rank + 2])
        dist.all_reduce(ll)
        dist.all_reduce(gl)
        rel = abs(ll.item() / 2 - lc.item()) / lc.item()
        gerr = ((gl / 2 - gc).abs().max() / gc.abs().max()).item()
        assert rel <= TRAIN_LOSS_RTOL and gerr <= TRAIN_GRAD_RTOL, (rel,
                                                                    gerr)
        init_m, step_m = tt.make_train_step(tt.adam(2e-5), mesh=mesh,
                                            loss_fn=loss_fn, **on)
        init_u, step_u = tt.make_train_step(tt.adam(2e-5), loss_fn=loss_fn,
                                            **on)
        sm, su = init_m(hk), init_u(hk)
        graph_refused(lambda: step_m(sm, xb), "train step")
        sm = init_m(hk)
        _mesh_reset()
        _, lm = step_m.eager(sm, xb)
        res["launches"]["train step.eager"] = _mesh_counts()
        _, lu = step_u.eager(su, xb)
        step_rel = abs(lm.item() - lu.item()) / lu.item()
        hk_err = (sm.hk - su.hk).abs().max().item()
        assert step_rel <= TRAIN_LOSS_RTOL and hk_err <= 2 * 2e-5, (
            step_rel, hk_err)
        res["checks"]["DP loss rel, grad rel (mean of 2 ranks)"] = [rel,
                                                                    gerr]
        res["checks"]["DP step loss rel, max|dhk|"] = [step_rel, hk_err]
    return res


def _mesh_runs(td: str) -> dict:
    """Spawn the three runs together on the card and return every rank's
    results; a rank that fails or hangs fails the test."""

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = []
    for which, (backend, world) in MESH_RUNS.items():
        init = "file://" + os.path.join(td, f"{which}.rendezvous")
        for r in range(world):
            p = ctx.Process(target=_mesh_rank,
                            args=(r, world, init, backend, which, td))
            p.start()
            procs.append(p)
    deadline = time.monotonic() + MESH_TIMEOUT
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    errs = [open(os.path.join(td, f)).read() for f in sorted(os.listdir(td))
            if f.endswith(".err")]
    codes = [p.exitcode for p in procs]
    assert not hung and not any(codes) and not errs, (
        f"mesh ranks: {len(hung)} hung, exit codes {codes}\n"
        + "\n".join(errs))
    out = {}
    for which, (_, world) in MESH_RUNS.items():
        out[which] = []
        for r in range(world):
            with open(os.path.join(td, f"{which}_{r}.json")) as f:
                out[which].append(json.load(f))
    return out



def test_mesh_runs_on_the_card(dev, tmp_path):
    """The (data, band) mesh on the one card (a correctness run, never a
    scaling result), its ranks spawned together: one rank over NCCL, a (1,
    1) mesh whose graphed steps hold the band and gradient all-reduces,
    bit-equal to the unsharded entries; two and four ranks sharing the
    card over gloo (Mb = 8 and 4), the eager forms within K12_TOL and >=
    BAR_DB of the unsharded card results, every graph refused. The
    streaming forward and round trip launch two K1 and one K2 a rank at
    each tier, a sharded step one K1 and one K2, a synthesis one band
    all-reduce."""
    runs = _mesh_runs(str(tmp_path))
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
            for tier in ("highest", *TIERS):
                n = res["launches"][
                    f"StreamingPQMF forward + roundtrip [{tier}]"]
                assert (n["K1"], n["K2"], n["K3"]) == (2, 1, 0), (tier, n)


@pytest.mark.parametrize("tier", ["highest", "bf16x3", "default"])
@pytest.mark.parametrize("Mb", [8, 4])
def test_band_shard_kernels_match_plain(dev, tier, Mb):
    """K1/K2 (K1t/K2t) on every rank's band shard of the 16-band bank, and
    K4/K5 at `highest`, against their plain versions (K12's bar) at a host
    block, 16 blocks and 60 s (K4 also at a block), output memory
    NaN-filled before each call."""
    sp, pq = StreamingPQMF(100, 16), PQMF(100, 16)
    hp, hi = pq.params["hk_poly"], pq.params["hk_ipoly"]
    g = torch.Generator().manual_seed(Mb)

    def close(kern, plain):
        _nan_fill()
        got = kern()
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, plain(), **K12_TOL)

    for r in range(16 // Mb):
        sl = slice(r * Mb, (r + 1) * Mb)
        wa, ws = sp.hkf[sl].contiguous(), sp.hki[:, sl].contiguous()
        for B in (1, 16):
            x = torch.randn(B, 1, 8192 + 512, generator=g).to(dev)
            s = torch.randn(B, Mb, 512 + 32, generator=g).to(dev)
            close(lambda: cc.strided_analysis_conv(x, wa, 16,
                                                   mxu_precision=tier),
                  lambda: cc.analysis_conv_plain(x, wa, 16, precision=tier))
            close(lambda: cc.dense_synthesis_conv(s, ws, True, -16, tier),
                  lambda: cc.synthesis_conv_plain(s, ws, True, -16, tier))
        if tier == "highest":
            hp_s, hi_s = hp[sl].contiguous(), hi[:, sl].contiguous()
            for x in (torch.randn(1, 1, 8192, generator=g).to(dev),
                      torch.randn(1, 1, 60 * 44100 // 16 * 16,
                                  generator=g).to(dev)):
                close(lambda: pk.polyphase_analysis(x, hp_s),
                      lambda: pk.polyphase_analysis_plain(x, hp_s))
            s = torch.randn(1, Mb, 60 * 44100 // 16, generator=g).to(dev)
            close(lambda: pk.polyphase_synthesis(s, hi_s),
                  lambda: pk.polyphase_synthesis_plain(s, hi_s))


# -- the flagship's middle: pv_frame, pv_spectral, pv_resynth ----------------

# (n_band, m_buffer_size, block, shifts): the flagship's default; 8 bands
# with bands of one frame (rates above the frame count); 32 bands; 4 bands
# (n_fft 1024) with one band of one frame; blocks of 256 through a
# 16 x 1024 wrapper (Tb = 16 against n_fft 64: short bands, bands of one
# frame); a hop that does not divide n_fft (188 / 47 / 256)
MIDDLE_GEOMETRIES = {
    "16x8192": (16, 8192, 8192, None),
    "8x2048": (8, 2048, 2048, [0, -48, 5, -40, 12, -36, 3, 7]),
    "32x8192": (32, 8192, 8192, None),
    "4x4096": (4, 4096, 4096, [-50, 7, -3, 1]),
    "16x1024_short": (16, 1024, 256, [-48] * 4 + [3, -2, 0, 1] * 3),
    "16x3008_odd_hop": (16, 3008, 3008, None),
}
# the spectral kernel against its plain version on the card: the same
# libdevice atan2f / sinf / cosf / sqrt and the same explicitly rounded
# arithmetic, so the magnitudes and phases agree to an ulp (the running
# phase: the kernel's double sum in frame order against the plain
# version's double scan, each rounded once to f32); a phase past it is a
# phase-rule branch that fell the other way
MIDDLE_ULPS = 2
# the whole step against the plain step: the products' inputs agree to an
# ulp of the phase, the rest is the same arithmetic
MIDDLE_STEP_DB = 100.0


@functools.lru_cache(maxsize=None)
def _middle_wrapper(geometry, phase_rule, tier):
    M, buf, _, shifts = MIDDLE_GEOMETRIES[geometry]
    return PQMFPitchShiftWrapper(100, M, buf, 44100, shifts,
                                 precision=tier, phase_rule=phase_rule,
                                 device="cuda")


def _middle_input(dev, geometry, B, seed):
    M, _, block, _ = MIDDLE_GEOMETRIES[geometry]
    x = np.random.default_rng(seed).standard_normal((B, 1, block)).astype(
        np.float32) * 0.3
    return torch.from_numpy(x).to(dev)


def _plain_resynth(prod, p, B, prev, fade_out, fade_in, mode):
    """The plain resynthesis of the card's operands, run on the host and
    returned to the card: PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal (the resample's ``src_len / Tb``, one ulp
    off where Tb is no power of two), and a card's index_add (the
    overlap-add where hop does not divide n_fft) adds in any order; the
    kernel, like the host, divides and adds the frames in one order."""
    from pqmf_tpu_torch.kernels import middle as pm

    cpu = [None if t is None else t.cpu() for t in (
        prod, p.table, p.wsq, p.window, prev.contiguous(), fade_out,
        fade_in)]
    return tuple(t.to(prod.device) for t in pm.resynth_plain(
        *cpu, B, p.Tb, p.n_fft, p.hop, p.win, mode))


def _plain_middle(monkeypatch):
    """Route the wrappers' middle through the plain stage functions (the
    frames and the spectrum on the card's tensors, the resynthesis on the
    host's copies of them): the plain step."""
    from pqmf_tpu_torch.kernels import middle as pm

    monkeypatch.setattr(pm, "frame", lambda sub, p: pm.frame_plain(
        sub, p.window, p.n_fft, p.hop, p.frames))
    monkeypatch.setattr(pm, "spectral", lambda spec, p, B, acc:
                        pm.spectral_plain(spec, p.rates, p.table, p.omega,
                                          B, p.n_fft, acc))
    monkeypatch.setattr(pm, "resynth", _plain_resynth)


def _middle_stages_match(w, sub, plan, prev, B, tag):
    """Each kernel against its plain version on the same card inputs; every
    launch counted once."""
    from pqmf_tpu_torch.kernels import middle as pm
    from pqmf_tpu_torch.ops import stft as S

    acc = w.phase_rule == "accumulate"
    stft_basis, istft_basis = pm.bases(plan.n_fft, sub.device)
    pm.reset_launches()
    frames = pm.frame(sub, plan)
    assert torch.equal(frames, pm.frame_plain(sub, plan.window, plan.n_fft,
                                              plan.hop, plan.frames)), tag
    spec = S.dft_matmul(frames, stft_basis, w.precision)
    rows = pm.spectral(spec, plan, B, acc)
    want = pm.spectral_plain(spec, plan.rates, plan.table, plan.omega, B,
                             plan.n_fft, acc)
    assert rows.shape == want.shape == (B * plan.rows, plan.n_fft + 2)
    mag, phase = pm._spectral_ulps(rows, want, plan, acc)
    flips = int((phase > MIDDLE_ULPS).sum())
    print(f"{tag}: spectral max {mag.max().item():.2f} magnitude ulps, "
          f"{phase.max().item():.2f} phase ulps, {flips} past "
          f"{MIDDLE_ULPS}")
    assert mag.max() <= MIDDLE_ULPS and flips == 0, tag
    prod = S.dft_matmul(want, istft_basis, w.precision)
    modes = [pm.NO_FADE, pm.STREAM_FADE] + ([pm.SHARED_FADE] if B == 1
                                            else [])
    L = w.band_overlap
    for mode in modes:
        tail = prev[0] if mode == pm.SHARED_FADE else prev
        got = pm.resynth(prod, plan, B, tail, w._fade_out, w._fade_in, mode)
        exp = _plain_resynth(prod, plan, B, tail, w._fade_out, w._fade_in,
                             mode)
        for g, e in zip(got, exp):
            assert g.shape == e.shape and g.is_contiguous(), (tag, mode)
            assert torch.equal(g, e), (tag, mode)
        if mode != pm.NO_FADE:
            assert got[1].shape[-1] == L
    torch.cuda.synchronize()
    assert pm.LAUNCHES == {"frame": 1, "spectral": 1,
                           "resynth": len(modes)}, (tag, pm.LAUNCHES)


@pytest.mark.parametrize("B", [1, 3, 128])
@pytest.mark.parametrize("phase_rule", ["reference", "accumulate"])
@pytest.mark.parametrize("geometry", sorted(MIDDLE_GEOMETRIES))
def test_middle_kernels_match_plain(dev, geometry, phase_rule, B):
    """pv_frame_kernel and pv_resynth_kernel equal their plain versions bit
    for bit (every crossfade mode); pv_spectral_kernel's rows agree with
    the plain rows at the frames that exist to an ulp of magnitude and
    phase, no phase-rule branch flipped."""
    w = _middle_wrapper(geometry, phase_rule, "highest")
    x = _middle_input(dev, geometry, B, 40 + B)
    sub = w.pqmf._forward_local(x)
    g = torch.Generator().manual_seed(B)
    prev = torch.randn(B, w.n_band, w.band_overlap, generator=g).to(dev)
    _middle_stages_match(w, sub, w._plan(sub.shape[-1]), prev, B,
                         f"{geometry} {phase_rule} B={B}")


@pytest.mark.parametrize("phase_rule", ["reference", "accumulate"])
def test_middle_kernels_on_a_band_slice(dev, phase_rule):
    """A mesh rank's middle: the plan of bands 8-15 of the 16-band
    geometry over those bands only."""
    from pqmf_tpu_torch.kernels import middle as pm

    w = _middle_wrapper("16x8192", phase_rule, "highest")
    sl = slice(8, 16)
    plan = pm.plan(w._rates_py[sl], w.n_fft, w.hop, w.win, 512, dev)
    for B in (1, 3):
        sub = w.pqmf._forward_local(_middle_input(dev, "16x8192", B, 7))
        sub = sub[:, sl].contiguous()
        g = torch.Generator().manual_seed(B)
        prev = torch.randn(B, 8, w.band_overlap, generator=g).to(dev)
        _middle_stages_match(w, sub, plan, prev, B,
                             f"bands 8-15 {phase_rule} B={B}")


def _middle_case(w, x, case, state):
    """One step of a crossfade mode: (state', y)."""
    if case == "fn_shared":        # B = 1, the reference's shared tail
        return w._pitchshift_fn_eager(state, x)
    if case == "fn_no_fade":       # a sharded step's B > 1 (the global batch)
        return w._pitchshift_fn_eager(state, x, crossfade=False)
    if case == "fn_batch":         # B > 1: no blend, the tail untouched
        return w._pitchshift_fn_eager(state, x)
    return w._pitchshift_streams_eager(state, x[:, 0])  # a tail a stream


def _middle_graphed(w, x, case, state):
    if case in ("fn_shared", "fn_batch"):
        return w.pitchshift_fn(state, x)
    if case == "streams":
        return w.pitchshift_streams(state, x[:, 0])
    return None


MIDDLE_CASES = {"fn_shared": 1, "fn_no_fade": 1, "fn_batch": 3,
                "streams": 128}


@pytest.mark.parametrize("case", sorted(MIDDLE_CASES))
@pytest.mark.parametrize("tier", ["highest", *TIERS])
@pytest.mark.parametrize("phase_rule", ["reference", "accumulate"])
@pytest.mark.parametrize("geometry", sorted(MIDDLE_GEOMETRIES))
def test_middle_step_matches_the_plain_step(dev, monkeypatch, geometry,
                                            phase_rule, tier, case):
    """Three blocks, the tail carried, at each tier and crossfade mode: the
    step on the kernels (eager, and its CUDA graph where the entry has
    one) against the same step on the plain stages; the graph equals the
    eager step bit for bit, and each step launches each kernel once."""
    from pqmf_tpu_torch.kernels import middle as pm

    w = _middle_wrapper(geometry, phase_rule, tier)
    B = MIDDLE_CASES[case]
    xs = [_middle_input(dev, geometry, B, 60 + i) for i in range(3)]
    init = (w.init_streams(B) if case == "streams" else w.init_state())
    pm.reset_launches()
    eager, graph, se, sg = [], [], init, init
    for x in xs:
        se, y = _middle_case(w, x, case, se)
        eager.append((y, se["prev_tail"]))
        res = _middle_graphed(w, x, case, sg)
        if res is not None:
            sg, y = res
            graph.append((y, sg["prev_tail"]))
    torch.cuda.synchronize()
    n = len(xs) * (2 if graph else 1)
    assert pm.LAUNCHES == dict.fromkeys(pm.LAUNCHES, n), pm.LAUNCHES
    for (gy, gt), (ey, et) in zip(graph, eager):
        _bit_equal([gy, gt], [ey, et], f"{geometry} {case} [{tier}]")
    with monkeypatch.context() as m:
        _plain_middle(m)
        sp, plain = init, []
        for x in xs:
            sp, y = _middle_case(w, x, case, sp)
            plain.append((y, sp["prev_tail"]))
    dbs = []
    for (ey, et), (py, pt) in zip(eager, plain):
        dbs.append(snr_db(py.cpu().numpy(), ey.cpu().numpy()))
        if case in ("fn_shared", "streams"):
            dbs.append(snr_db(pt.cpu().numpy(), et.cpu().numpy()))
        else:
            assert torch.equal(et, pt)
    print(f"{geometry} {phase_rule} {case} [{tier}]: kernels vs plain "
          f"{min(dbs):.1f} dB")
    assert min(dbs) >= MIDDLE_STEP_DB, dbs


def test_middle_launches_once_a_step_and_a_replay(dev):
    """On the card every flagship step launches pv_frame_kernel,
    pv_spectral_kernel and pv_resynth_kernel once: eagerly, and in each
    graph replay (a capture adds nothing), and the graph records them."""
    from pqmf_tpu_torch.kernels import middle as pm

    w = _flagship16("highest", dev)
    xs = _blocks(dev, 5, 70)
    pm.reset_launches()
    st = w.init_state()
    for x in xs:
        st, _ = w.pitchshift_fn(st, x)
    ss = w.init_streams(4)
    for x in xs[:3]:
        ss, _ = w.pitchshift_streams(ss, x.expand(4, -1))
    torch.cuda.synchronize()
    assert pm.LAUNCHES == {"frame": 8, "spectral": 8, "resynth": 8}
    for prog in w._graphs.values():
        assert prog.launches[2] == {"frame": 1, "spectral": 1, "resynth": 1}


def test_no_cuda_route_reaches_the_plain_middle(dev, monkeypatch):
    """Every entry that steps the flagship on the card takes the kernels:
    the plain stage functions raise there, and each step counts one launch
    of each kernel."""
    from pqmf_tpu_torch.entry import entry
    from pqmf_tpu_torch.kernels import middle as pm

    def refuse(*args, **kwargs):
        raise AssertionError("a plain middle stage ran on the card")

    for name in ("frame_plain", "spectral_plain", "resynth_plain"):
        monkeypatch.setattr(pm, name, refuse)
    w = _flagship16("highest", dev)
    x = _blocks(dev, 1, 71)[0]
    pm.reset_launches()
    st, _ = w.pitchshift_fn(w.init_state(), x)           # eager + capture
    w.pitchshift_fn(st, x)                               # replay
    w._pitchshift_fn_eager(st, x)
    w.pitchshift_streams(w.init_streams(2), x.expand(2, -1))
    w.pitchshift(x)
    stream_ola(w, x.cpu().numpy(), 4096)
    fn, args = entry(device="cuda")
    fn(*args)
    torch.cuda.synchronize()
    assert min(pm.LAUNCHES.values()) >= 7 and len(set(
        pm.LAUNCHES.values())) == 1, pm.LAUNCHES


# -- the entry points (pqmf_tpu_torch/entry.py) ------------------------------


@pytest.mark.parametrize("inputs", ["seeded blocks", "example x"])
def test_entry_on_the_card_matches_entry_on_the_cpu(dev, inputs):
    """``entry()``'s step (the flagship, a CUDA graph) for 3 carried steps
    against ``entry(device="cpu")``'s, one K1 and one K2 a step: on seeded
    audio blocks each output and the tail >= BAR_DB; on its own example
    input (a pure sine, ill-conditioned for the reference's phase rule) at
    ``entry.EXAMPLE_FLOOR_DB``."""
    from pqmf_tpu_torch import entry as ent

    fg, (tail_g, x_g) = ent.entry()
    fc, (tail_c, x_c) = ent.entry(device="cpu")
    assert x_g.is_cuda and tail_g.is_cuda and torch.equal(x_g.cpu(), x_c)
    steps = 3
    if inputs == "seeded blocks":
        xs = [torch.from_numpy(b)[None] for b in np.split(
            _audio(steps * BLOCK, 23), steps, axis=-1)]
        bar = BAR_DB
    else:
        xs, bar = [x_c] * steps, ent.EXAMPLE_FLOOR_DB
    cc.reset_launches()
    ys = []
    for x in xs:
        tail_g, y = fg(tail_g, x.cuda())
        ys.append(y)
    torch.cuda.synchronize()
    assert cc.LAUNCHES == _launches({"analysis": steps, "synthesis": steps})
    dbs = []
    for x, y in zip(xs, ys):
        tail_c, yc = fc(tail_c, x)
        assert y.shape == yc.shape == (1, BLOCK) and torch.isfinite(y).all()
        dbs.append(snr_db(yc.numpy(), y.cpu().numpy()))
    dbs.append(snr_db(tail_c.numpy(), tail_g.cpu().numpy()))
    assert min(dbs) >= bar, (dbs, bar)


def test_dryrun_multichip_on_the_card(dev):
    """``dryrun_multichip(4)`` on the one card (4 ranks sharing it over
    gloo, the JAX dry run's four steps) runs, and its sharded step
    launches K1 and K2."""
    from pqmf_tpu_torch import entry as ent

    res = ent.dryrun_multichip(4)
    n = res["launches"]["sharded step"]
    assert n["K1"] >= 1 and n["K2"] >= 1, n
