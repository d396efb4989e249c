"""pqmf_tpu_torch on the card: each CUDA kernel against its plain PyTorch
version, and the streaming path and flagship slice against the port on the
CPU. Every test is marked ``cuda`` and skips without a CUDA device.

This file imports no JAX (the card's machine has none), so it runs there
without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: K1/K2 atol=2e-5 / rtol=1e-4 (pqmf_tpu's kernel-vs-lax bar);
K3 against the plain composition atol=1e-5 (its recomputed halo sums the
taps in another order); the slice >= 90 dB.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pqmf_tpu_torch import PQMFPitchShiftWrapper, StreamingPQMF
from pqmf_tpu_torch.kernels import _build
from pqmf_tpu_torch.kernels import cached_conv as cc
from pqmf_tpu_torch.utils.metrics import snr_db

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
    pq = StreamingPQMF(100, M)
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
    lib = _build.load()
    for M, Ka, Ks in [(8, 257, 17), (16, 513, 33), (32, 1025, 33),
                      (64, 2049, 33)]:
        for i, which in enumerate(("analysis", "synthesis", "roundtrip"), 1):
            assert lib.pqmf_smem_bytes(i, M, M, Ka, Ks) == \
                cc.smem_bytes(which, M, M, Ka, Ks), (which, M)


def test_streaming_routes_through_kernels(dev):
    gpu, cpu = StreamingPQMF(100, 16, device="cuda"), StreamingPQMF(100, 16)
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
    cpu = PQMFPitchShiftWrapper(100, 16, 2048, 44100, SHIFTS16)
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
