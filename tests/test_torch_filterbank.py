"""pqmf_tpu_torch's bank build, tensor ops and package surface against
pqmf_tpu on the CPU."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pqmf_tpu import design as jdesign
from pqmf_tpu.ops import filterbank as jfb
from pqmf_tpu.streaming import kernels_from_params as j_kernels_from_params
from pqmf_tpu.utils import metrics as jmetrics
from pqmf_tpu_torch import design as tdesign
from pqmf_tpu_torch.convert import params_from_jax
from pqmf_tpu_torch.ops import filterbank as tfb
from pqmf_tpu_torch.streaming import kernels_from_params
from pqmf_tpu_torch.utils import metrics as tmetrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n_band", [4, 8, 16])
def test_bank_bit_equal(n_band):
    ref = jfb.build_filterbank(100, n_band)
    got = tfb.build_filterbank(100, n_band)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("n_band", [4, 16])
def test_stream_kernels_bit_equal(n_band):
    p = jfb.build_filterbank(100, n_band)
    jf, ji = j_kernels_from_params(p)
    tf, ti = kernels_from_params(tfb.build_filterbank(100, n_band))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_design_is_a_copy():
    """design.py is copied verbatim: the prototypes agree to the bit."""
    for m in (2, 8, 32):
        np.testing.assert_array_equal(tdesign.get_prototype(100, m),
                                      jdesign.get_prototype(100, m))


def test_params_from_hk_non_divisible():
    hk = np.random.default_rng(0).standard_normal((3, 16)).astype(np.float32)
    ref = jfb.params_from_hk(hk)
    got = tfb.params_from_hk(hk)
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("shape", [(2, 16, 37), (1, 8, 64), (3, 4, 1)])
def test_reverse_half(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jfb.reverse_half(jnp.asarray(x)))
    got = tfb.reverse_half(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_conv1d_matches_lax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 200)).astype(np.float32)
    w = rng.standard_normal((5, 3, 17)).astype(np.float32)
    ref = np.asarray(jfb._conv1d(jnp.asarray(x), jnp.asarray(w), stride=4,
                                 padding=(8, 3)))
    got = tfb._conv1d(torch.from_numpy(x), torch.from_numpy(w), stride=4,
                      padding=(8, 3)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)


def test_full_f32_restores_flags():
    conv, mm = torch.backends.cudnn.allow_tf32, \
        torch.get_float32_matmul_precision()
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        with tfb.full_f32():
            assert torch.backends.cudnn.allow_tf32 is False
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.backends.cudnn.allow_tf32 is True
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.set_float32_matmul_precision(mm)


@pytest.mark.parametrize("delay,edge", [(0, 0), (16, 0), (16, 100)])
def test_metrics_copy_agrees(delay, edge):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(4096)
    y = np.roll(x, delay) + 1e-3 * rng.standard_normal(4096)
    assert tmetrics.aligned_roundtrip_snr_db(x, y, delay, edge) == \
        jmetrics.aligned_roundtrip_snr_db(x, y, delay, edge)


def test_params_from_jax():
    p = jfb.build_filterbank(100, 8)
    got = params_from_jax({k: np.asarray(v) for k, v in p.items()}, "cpu")
    for k, v in p.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))
    with pytest.raises(KeyError):
        params_from_jax({"hk": np.asarray(p["hk"])})


def test_precision_tiers_refused():
    """An unknown tier is refused, naming the three the port takes."""
    from pqmf_tpu_torch import PQMFPitchShiftWrapper, StreamingPQMF

    for tier in ("high", "bf16", "HIGHEST"):
        with pytest.raises(ValueError, match="'highest', 'bf16x3', "
                                             "'default'"):
            StreamingPQMF(100, 16, precision=tier, device="cpu")
        with pytest.raises(ValueError, match="unknown precision"):
            PQMFPitchShiftWrapper(100, 16, 2048, precision=tier, device="cpu")


def test_cuda_device_refused_without_cuda():
    """device='cuda' raises where there is no card — never a silent run on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from pqmf_tpu_torch import PQMFPitchShiftWrapper, StreamingPQMF

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamingPQMF(100, 16, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PQMFPitchShiftWrapper(100, 16, 2048, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax(jfb.build_filterbank(100, 4), "cuda")


def test_import_leaves_jax_out():
    """Importing the port (every module) never imports JAX."""
    code = (
        "import sys, pkgutil, importlib, pqmf_tpu_torch\n"
        "for m in pkgutil.walk_packages(pqmf_tpu_torch.__path__, "
        "'pqmf_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "want = ['filterbank', 'kernels.polyphase', 'export', "
        "'cli.export_pqmf', 'utils.audio', 'parallel.training', "
        "'shifters', 'pipelines', 'ops.resample', 'cli._common', "
        "'cli.vocoder', 'cli.ps_torchaudio', 'cli.blocks', "
        "'cli.export_pvoc', 'entry']\n"
        "missing = [w for w in want if 'pqmf_tpu_torch.' + w "
        "not in sys.modules]\n"
        "assert not missing, missing\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' "
        "or n.startswith(('jax.', 'pqmf_tpu.')) or n == 'pqmf_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("offset", [0, -16, -15, 3])
def test_reverse_half_offset(offset):
    """With an offset the mask reads the parity of each sample's position
    in the signal (x[..., 0] sits at ``offset``): only the parity counts,
    so it equals the JAX mask of x behind ``offset % 2`` leading zeros."""
    x = np.random.default_rng(7).standard_normal((2, 4, 40)).astype(
        np.float32)
    lead = offset % 2
    full = np.pad(x, ((0, 0), (0, 0), (lead, 0)))
    ref = np.asarray(jfb.reverse_half(jnp.asarray(full)))[..., lead:]
    got = tfb.reverse_half(torch.from_numpy(x), offset=offset).numpy()
    np.testing.assert_array_equal(got, ref)
