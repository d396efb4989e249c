"""The port's three conv kernels — K1 analysis, K2 synthesis, K3 fused
round trip — against pqmf_tpu's Pallas kernels (interpret mode on the CPU,
as tests/test_kernels.py runs them).

On the CPU a wrapper runs its kernel's plain PyTorch version; the CUDA
kernels themselves are checked against those plain versions on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``). Tolerance: the JAX
package's own kernel-vs-lax bar, atol=2e-5 / rtol=1e-4 (sums of up to 513
f32 products taken in another order).
"""

import numpy as np
import pytest
import torch
from jax import numpy as jnp

from pqmf_tpu.kernels import cached_conv as jcc
from pqmf_tpu.ops import filterbank as jfb
from pqmf_tpu.streaming import centered_padding
from pqmf_tpu.streaming import kernels_from_params as j_kernels
from pqmf_tpu_torch.kernels import _build
from pqmf_tpu_torch.kernels import cached_conv as cc

TOL = dict(atol=2e-5, rtol=1e-4)


def _bank(M):
    hkf, hki = j_kernels(jfb.build_filterbank(100, M))
    return np.asarray(hkf), np.asarray(hki)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("M", [8, 16])
@pytest.mark.parametrize("t_out", [3, 40])
@pytest.mark.parametrize("fuse_mask", [True, False])
def test_analysis_plain_matches_pallas(M, t_out, fuse_mask):
    hkf, _ = _bank(M)
    K = hkf.shape[-1]
    x = np.random.default_rng(M + t_out).standard_normal(
        (2, 1, (t_out - 1) * M + K + 5)).astype(np.float32)
    ref = np.asarray(jcc.strided_analysis_conv(
        jnp.asarray(x), jnp.asarray(hkf), M, fuse_mask=fuse_mask))
    got = cc.strided_analysis_conv(_t(x), _t(hkf), M, fuse_mask=fuse_mask)
    assert got.shape == ref.shape == (2, M, t_out)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("M", [8, 16])
@pytest.mark.parametrize("fuse_mask,x_offset",
                         [(True, 0), (True, -16), (True, -15), (False, 0)])
def test_synthesis_plain_matches_pallas(M, fuse_mask, x_offset):
    _, hki = _bank(M)
    K = hki.shape[-1]
    x = np.random.default_rng(M - x_offset).standard_normal(
        (2, M, 37 + K - 1)).astype(np.float32)
    ref = np.asarray(jcc.dense_synthesis_conv(
        jnp.asarray(x), jnp.asarray(hki), fuse_mask=fuse_mask,
        x_offset=x_offset))
    got = cc.dense_synthesis_conv(_t(x), _t(hki), fuse_mask=fuse_mask,
                                  x_offset=x_offset)
    assert got.shape == ref.shape == (2, 37, M)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("M,T", [(8, 8 * 40), (16, 16 * 64)])
def test_roundtrip_plain_matches_pallas(M, T):
    hkf, hki = _bank(M)
    al, ar = centered_padding(hkf.shape[-1])
    syn_pad = centered_padding(hki.shape[-1])
    x = np.random.default_rng(T).standard_normal((1, 1, T)).astype(
        np.float32)
    xx = np.pad(x, ((0, 0), (0, 0), (al, ar)))
    ref = np.asarray(jcc.fused_roundtrip_conv(
        jnp.asarray(xx), jnp.asarray(hkf), jnp.asarray(hki), M, syn_pad))
    got = cc.fused_roundtrip_conv(_t(xx), _t(hkf), _t(hki), M, syn_pad)
    assert got.shape == ref.shape == (1, T // M, M)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_roundtrip_plain_is_the_composition():
    """K3's contract: K2(pad(K1(x)), mask parity from the sub-band signal)
    — the masks cancel even for an odd left pad."""
    M = 8
    hkf, hki = _bank(M)
    x = _t(np.random.default_rng(5).standard_normal(
        (2, 1, 8 * 30 + hkf.shape[-1] - 1)).astype(np.float32))
    for pad in [(16, 16), (3, 0), (0, 5)]:
        sub = cc.strided_analysis_conv(x, _t(hkf), M)
        sub = torch.nn.functional.pad(sub, pad)
        comp = cc.dense_synthesis_conv(sub, _t(hki), x_offset=-pad[0])
        got = cc.fused_roundtrip_conv(x, _t(hkf), _t(hki), M, pad)
        np.testing.assert_array_equal(got.numpy(), comp.numpy())


def test_cpu_wrappers_do_not_count_launches():
    cc.reset_launches()
    hkf, hki = _bank(8)
    x = _t(np.zeros((1, 1, 600), np.float32))
    cc.strided_analysis_conv(x, _t(hkf), 8)
    cc.fused_roundtrip_conv(x, _t(hkf), _t(hki), 8, (16, 16))
    assert cc.LAUNCHES == {"analysis": 0, "synthesis": 0, "roundtrip": 0}


def test_wrappers_refuse_what_the_kernels_do_not_take():
    hkf, hki = _bank(8)
    x = _t(np.zeros((1, 1, 600), np.float32))
    with pytest.raises(ValueError, match="float32"):
        cc.strided_analysis_conv(x.double(), _t(hkf).double(), 8)
    with pytest.raises(ValueError, match="contiguous"):
        cc.strided_analysis_conv(
            _t(np.zeros((1, 1, 1200), np.float32))[..., ::2], _t(hkf), 8)
    with pytest.raises(ValueError, match="even-sized"):
        cc.strided_analysis_conv(x, _t(hkf[:3]), 8)
    with pytest.raises(ValueError, match="band dims"):
        cc.dense_synthesis_conv(_t(np.zeros((1, 4, 60), np.float32)),
                                _t(hki))
    with pytest.raises(ValueError, match="empty"):
        cc.strided_analysis_conv(x[..., :100], _t(hkf), 8)
    with pytest.raises(ValueError, match="is on"):
        cc.dense_synthesis_conv(_t(np.zeros((1, 8, 60), np.float32)),
                                _t(hki).to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        cc.strided_analysis_conv(x.to("meta"), _t(hkf).to("meta"), 8)
    with pytest.raises(ValueError, match="full-bank"):
        cc.fused_roundtrip_conv(x, _t(hkf[:4]), _t(hki), 8, (16, 16))
    with pytest.raises(TypeError):
        cc.strided_analysis_conv(np.zeros((1, 1, 600), np.float32),
                                 _t(hkf), 8)


@pytest.mark.parametrize("M", [2, 4, 8, 16, 32, 64])
def test_gates(M):
    """K1/K2 take every committed geometry (their bank is staged in
    chunks); K3 holds both full banks in one block and stops past M=16."""
    hkf, hki = _bank(M)
    Ka, Ks = hkf.shape[-1], hki.shape[-1]
    assert cc.supports(M, Ka, Ks)
    assert cc.fused_roundtrip_supported(M, Ka, Ks) == (M <= 16)
    assert cc.smem_bytes("roundtrip", 16, 16, 513, 33) <= cc.SMEM_LIMIT


def test_build_targets_hopper():
    cmd = _build.nvcc_command("nvcc", _build.BUILD_DIR / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert str(_build.SOURCE) in cmd
    assert _build.SOURCE.exists()
    text = _build.SOURCE.read_text()
    for entry in ("pqmf_analysis_conv", "pqmf_synthesis_conv",
                  "pqmf_roundtrip_conv"):
        assert f"int {entry}(" in text


def test_build_without_nvcc_raises(monkeypatch):
    """Without a compiler the build fails loudly (no plain-version
    fallback exists for CUDA tensors)."""
    import shutil

    import torch.utils.cpp_extension as ext

    if shutil.which("nvcc") or ext.CUDA_HOME:
        pytest.skip("a CUDA toolkit is present")
    monkeypatch.setattr(_build, "_library_path",
                        lambda: _build.BUILD_DIR / "absent.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
