"""K1t/K2t's arranged bank, their launch plans and window addressing, the
in-kernel pad of K2/K2t, and the pinned CPU reference — on the CPU.

- ``arrange_tc_bank`` (the bank as the tensor-core kernels read it) is
  decoded here from the mma's fragment layout, written out independently
  of the port: its hi and lo halves are bit-equal to JAX's ``_split_bf16``
  of the GEMM's B operand, and a NumPy GEMM over it (Hankel A x arranged
  B, float64 sums of bf16 values) equals the plain versions at each tier
  within atol=2e-5 / rtol=1e-4 (the JAX package's kernel-vs-lax bar: the
  same exact products in another order).
- The launch plans of ``cached_conv.launch_plan`` at the tiers fit the
  card and cover every output once; a model of the kernels' swizzled
  window holds every ldmatrix row where the kernel reads it, without bank
  conflicts.
- K2's pad: a padded call equals ``F.pad`` and the call, bit for bit.
- The pin of ``tests/test_torch_cuda.py`` (``CPU_PIN``): with it,
  the CPU flagship is bit-equal under MKL's SSE4.2 path and its default.
The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pqmf_tpu.kernels import cached_conv as jcc
from pqmf_tpu.ops import filterbank as jfb
from pqmf_tpu.streaming import kernels_from_params as j_kernels
from pqmf_tpu_torch import PQMF, StreamingPQMF
from pqmf_tpu_torch.kernels import cached_conv as cc
from pqmf_tpu_torch.kernels import polyphase as pk
from pqmf_tpu_torch.parallel.training import load_pretrained_bank

TOL = dict(atol=2e-5, rtol=1e-4)
TIERS = ("bf16x3", "default")
ROOT = Path(__file__).resolve().parent.parent


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _banks(M):
    hkf, hki = j_kernels(jfb.build_filterbank(100, M))
    return np.asarray(hkf), np.asarray(hki)


def _finetuned_banks():
    hkf, hki = j_kernels(load_pretrained_bank("hk16_atten100_finetuned"))
    return np.asarray(hkf), np.asarray(hki)


def b_operand(w, kind):
    """The GEMM's B, written out: analysis B[q, c] = w[c, 0, q]; synthesis
    B[k*Mb + m, c] = w[M-1-c, m, k]."""
    w = np.asarray(w, np.float32)
    if kind == "analysis":
        return w[:, 0, :].T.copy()
    M, Mb, K = w.shape
    B = np.zeros((K * Mb, M), np.float32)
    for k in range(K):
        for m in range(Mb):
            B[k * Mb + m] = w[::-1, m, k]
    return B


def decode(words):
    """B's halves [H, Qp, Np] from the arranged bank [H, n_cb, n_k, 32,
    4*NN]: lane l = 4g + tq of k-step ks, channel block cb holds, for n8
    tile nn, b0 = rows 2tq, 2tq+1 and b1 = rows 2tq+8, 2tq+9 of column
    8nn + g, the lower row in the lower half of each 32-bit word."""
    w = words.float().numpy()
    H, n_cb, n_k, _, W = w.shape
    NN = W // 4
    out = np.full((H, 16 * n_k, 8 * NN * n_cb), np.nan, np.float32)
    for lane in range(32):
        g, tq = divmod(lane, 4)
        for nn in range(NN):
            for j in range(2):          # b0, b1
                for e in range(2):      # low, high half of the word
                    q = 16 * np.arange(n_k) + 2 * tq + 8 * j + e
                    for cb in range(n_cb):
                        c = cb * 8 * NN + 8 * nn + g
                        out[:, q, c] = w[:, cb, :, lane, 4 * nn + 2 * j + e]
    return out


def _check_halves(w, kind, tier):
    bank = cc.arrange_tc_bank(_t(w), kind, tier)
    assert bank.words.dtype == torch.bfloat16 and bank.words.is_contiguous()
    assert (bank.kind, bank.precision, bank.w_shape) == (kind, tier,
                                                         tuple(w.shape))
    got = decode(bank.words)
    assert not np.isnan(got).any()  # every element of the layout is written
    B = b_operand(w, kind)
    Q, N = B.shape
    j_hi, j_lo = (np.asarray(h.astype(jnp.float32))
                  for h in jcc._split_bf16(jnp.asarray(B)))
    want = [j_hi, j_lo] if tier == "bf16x3" else [j_hi]
    assert got.shape[0] == len(want)
    for half, ref in zip(got, want):
        np.testing.assert_array_equal(half[:Q, :N], ref)
        assert not half[Q:].any() and not half[:, N:].any()  # zero padding


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("kind", ["analysis", "synthesis"])
@pytest.mark.parametrize("M", [2, 4, 8, 16, 32, 64])
def test_arranged_halves_are_jax_split(M, kind, tier):
    hkf, hki = _banks(M)
    _check_halves(hkf if kind == "analysis" else hki, kind, tier)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("kind", ["analysis", "synthesis"])
def test_arranged_halves_of_the_finetuned_bank(kind, tier):
    hkf, hki = _finetuned_banks()
    _check_halves(hkf if kind == "analysis" else hki, kind, tier)


@pytest.mark.parametrize("tier", TIERS)
def test_arranged_halves_of_a_band_shard_and_the_polyphase_banks(tier):
    hkf, _ = _banks(16)
    _check_halves(hkf[:6], "analysis", tier)
    p = jfb.build_filterbank(100, 16)
    _check_halves(pk.analysis_weights(_t(p["hk_poly"])).numpy(), "analysis",
                  tier)
    _check_halves(p["hk_ipoly"], "synthesis", tier)


def _hankel_gemm(buf, S, T_out, halves_a, halves_b, tier):
    """sum over the tier's products of A[t, q] = buf_h[S*t + q] times the
    decoded B halves, in float64."""
    Qp = halves_b.shape[1]
    idx = S * np.arange(T_out)[:, None] + np.arange(Qp)[None]
    A = [np.pad(a.astype(np.float64), (0, max(0, idx.max() + 1 - a.size)))[idx]
         for a in halves_a]
    Bh = halves_b.astype(np.float64)
    y = A[0] @ Bh[0]
    if tier == "bf16x3":
        y = y + A[0] @ Bh[1] + A[1] @ Bh[0]
    return y


def _split_np(a):
    hi, lo = jcc._split_bf16(jnp.asarray(a, jnp.float32))
    return [np.asarray(hi.astype(jnp.float32)),
            np.asarray(lo.astype(jnp.float32))]


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("M", [2, 8, 16])
def test_gemm_over_arranged_analysis_bank_is_plain_k1(M, tier):
    hkf, _ = _banks(M)
    K = hkf.shape[-1]
    x = _rand(M, 2, 1, 23 * M + K - 7)
    pad = (5, 2)
    want = cc.analysis_conv_plain(_t(x), _t(hkf), M, True, pad, tier).numpy()
    halves = decode(cc.arrange_tc_bank(_t(hkf), "analysis", tier).words)
    T_out = want.shape[-1]
    for b in range(2):
        buf = np.pad(x[b, 0], pad)
        y = _hankel_gemm(buf, M, T_out, _split_np(buf), halves, tier)
        y = y[:, :M].T.copy()
        y[1::2, 0::2] *= -1  # reverse_half on the output
        np.testing.assert_allclose(y, want[b], **TOL)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("M", [2, 8, 16])
def test_gemm_over_arranged_synthesis_bank_is_plain_k2(M, tier):
    _, hki = _banks(M)
    Ks = hki.shape[-1]
    x = _rand(M + 1, 2, M, 31)
    pad, x_offset = (Ks // 2, Ks // 2), 3
    want = cc.synthesis_conv_plain(_t(x), _t(hki), True, x_offset, tier,
                                   pad).numpy()
    halves = decode(cc.arrange_tc_bank(_t(hki), "synthesis", tier).words)
    T_out = want.shape[1]
    for b in range(2):
        xm = x[b].copy()
        xm[1::2, x_offset % 2::2] *= -1  # -1 at odd bands, even times
        win = np.pad(xm, ((0, 0), pad)).T.reshape(-1)  # time-major
        y = _hankel_gemm(win, M, T_out, _split_np(win), halves, tier)
        np.testing.assert_allclose(M * y[:, :M], want[b], **TOL)


def test_tc_bank_must_match_the_call():
    hkf, hki = (_t(a) for a in _banks(8))
    bank = cc.arrange_tc_bank(hkf, "analysis", "bf16x3")
    assert cc._tc_bank(bank, hkf, "analysis", "bf16x3") is bank
    for w, kind, tier in [(hkf, "analysis", "default"),
                          (hki, "synthesis", "bf16x3"),
                          (hkf[:4].contiguous(), "analysis", "bf16x3")]:
        with pytest.raises(ValueError, match="arranged bank is for"):
            cc._tc_bank(bank, w, kind, tier)
    with pytest.raises(ValueError, match="'bf16x3' and 'default'"):
        cc.arrange_tc_bank(hkf, "analysis", "highest")
    with pytest.raises(ValueError, match="unknown kernel"):
        cc.arrange_tc_bank(hkf, "roundtrip", "bf16x3")


# ---------------------------------------------------------------------------
# launch plans and the window's addressing
# ---------------------------------------------------------------------------

PLAN_CASES = [  # (which, B, M, Mb, Ka, Ks, T_out)
    ("analysis", 1, 16, 16, 513, 0, 512), ("analysis", 16, 16, 16, 513, 0, 512),
    ("analysis", 1, 16, 16, 512, 0, 165375), ("analysis", 2, 16, 6, 513, 0, 77),
    ("analysis", 1, 64, 64, 2049, 0, 300), ("analysis", 1, 64, 64, 2049, 0,
                                            40000),
    ("analysis", 3, 1, 2, 31, 0, 470), ("analysis", 2, 16, 16, 9001, 0, 300),
    ("synthesis", 1, 16, 16, 0, 33, 512), ("synthesis", 16, 16, 16, 0, 33, 512),
    ("synthesis", 1, 16, 16, 0, 32, 165375), ("synthesis", 2, 64, 64, 0, 33,
                                              300),
    ("synthesis", 1, 64, 64, 0, 33, 40000), ("synthesis", 2, 4, 1, 0, 33, 268),
    ("synthesis", 2, 16, 6, 0, 33, 300), ("synthesis", 2, 16, 16, 0, 600, 300),
    ("synthesis", 215, 16, 16, 0, 33, 256)]


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_tc_plans_fit_and_cover(case):
    """Every output step of every row falls in exactly one tile of one
    block's walk; the reduction's k-steps fall in exactly one slice; a
    call of one host block spreads over 32+ blocks; whole files run
    persistent blocks that the card holds at once."""
    which, B, M, Mb, Ka, Ks, T_out = case
    gx, gy, gz, threads, tile, WK, CB, smem = cc.launch_plan(
        which, B, M, Mb, Ka, Ks, T_out, precision="bf16x3")
    assert cc.launch_plan(which, B, M, Mb, Ka, Ks, T_out,
                          precision="default")[:7] == (gx, gy, gz, threads,
                                                       tile, WK, CB)
    N = Mb if which == "analysis" else M
    Q = Ka if which == "analysis" else Mb * Ks
    n_k = -(-Q // 16)
    assert threads == 128 and gz == 1 and gy == -(-N // CB)
    assert smem <= cc.smem_bytes(which, M, Mb, Ka, Ks, "bf16x3") \
        <= cc.SMEM_LIMIT
    WM = 4 // WK
    MT = tile // (16 * WM)
    assert (MT, WK) in cc._TC_SHAPES
    tiles_x = -(-T_out // tile)
    seen = np.zeros((B, tiles_x * tile), np.int64)
    for blk in range(gx):
        for tl in range(blk, B * tiles_x, gx):
            b, t0 = divmod(tl, tiles_x)
            seen[b, t0 * tile:(t0 + 1) * tile] += 1
    assert (seen == 1).all()
    k_seen = np.zeros(n_k, np.int64)
    for wk in range(WK):
        k_seen[n_k * wk // WK:n_k * (wk + 1) // WK] += 1
    assert (k_seen == 1).all() and n_k // WK >= 1
    m16 = B * -(-T_out // 16) * gy
    per_sm = max(1, min(2048 // 128, cc._SMEM_PER_SM // (smem + 1024)))
    if m16 >= cc.N_SMS * cc._TC_PERSIST_M16:
        assert tile == 128 and gx * gy <= max(gy, cc.N_SMS * per_sm)
    else:
        assert gx == B * tiles_x  # one tile a block
        assert gx * gy * WK >= min(m16 * WK, 32)
    if (which, B, M, T_out) in (("analysis", 1, 16, 512),
                                ("synthesis", 1, 16, 512)):
        assert gx >= 32 and WK == 4  # the flagship's block


@pytest.mark.parametrize("S", [8, 16, 24, 32, 64])
def test_swizzled_window_serves_ldmatrix_without_conflicts(S):
    """A model of K1t/K2t's split window: element i is stored at 16-byte
    chunk swizzle(i >> 3); every lane of every ldmatrix.x4 at every
    (m16 tile, k-step) finds its 8 elements where it reads them, and the 8
    rows of each 8x8 matrix hit 8 distinct bank groups (S a power of two;
    S = 24 is stored plainly and still read right)."""
    pow2 = S & (S - 1) == 0
    swz = min(S // 8, 8) - 1 if pow2 else 0

    def swizzle(u):
        return u ^ ((u >> 3) & swz)

    R, Qp = 128, 528
    nT = R - 1 + -(-Qp // S)
    WL = -(-S * nT // 64) * 64
    store = np.full(WL, -1, np.int64)
    i = np.arange(WL)
    store[8 * swizzle(i >> 3) + (i & 7)] = i
    assert (np.sort(store) == i).all()  # a permutation of the window
    for r0 in (0, 16, 112):
        for ks in range(Qp // 16):
            lanes = np.arange(32)
            u = S * (r0 + (lanes & 15)) // 8 + (lanes >> 4) + 2 * ks
            for lane in lanes:
                row, col = r0 + (lane & 15), 16 * ks + 8 * (lane >> 4)
                got = store[8 * swizzle(u[lane]) + np.arange(8)]
                assert (got == S * row + col + np.arange(8)).all()
            if pow2:
                for mat in range(4):
                    groups = swizzle(u[8 * mat:8 * mat + 8]) % 8
                    assert len(set(groups.tolist())) == 8, (r0, ks, mat)


# ---------------------------------------------------------------------------
# kept banks follow the weights
# ---------------------------------------------------------------------------


def _equal_banks(a, b):
    return (a.kind, a.precision, a.w_shape) == (b.kind, b.precision,
                                                b.w_shape) \
        and torch.equal(a.words, b.words)


@pytest.mark.parametrize("tier", TIERS)
def test_set_weights_rebuilds_the_kept_arrangement(tier):
    ft = load_pretrained_bank("hk16_atten100_finetuned")
    sp = StreamingPQMF(100, 16, precision=tier, device="cpu")
    before = dict(sp.tc_banks)
    sp.set_weights(ft)
    for kind, w in (("analysis", sp.hkf), ("synthesis", sp.hki)):
        assert _equal_banks(sp.tc_banks[kind],
                            cc.arrange_tc_bank(w, kind, tier))
        assert not torch.equal(sp.tc_banks[kind].words, before[kind].words)
    pq = PQMF(100, 16, precision=tier, device="cpu")
    before = dict(pq.tc_banks)
    pq.set_weights(ft)
    assert _equal_banks(pq.tc_banks["analysis"], cc.arrange_tc_bank(
        pk.analysis_weights(pq.params["hk_poly"]), "analysis", tier))
    assert _equal_banks(pq.tc_banks["synthesis"], cc.arrange_tc_bank(
        pq.params["hk_ipoly"], "synthesis", tier))
    assert not torch.equal(pq.tc_banks["analysis"].words,
                           before["analysis"].words)


def test_highest_keeps_no_arrangement():
    assert StreamingPQMF(100, 16, device="cpu").tc_banks == {
        "analysis": None, "synthesis": None}
    assert PQMF(100, 16, device="cpu").tc_banks == {"analysis": None,
                                                    "synthesis": None}


# ---------------------------------------------------------------------------
# K2's in-kernel pad
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", ["highest", *TIERS])
@pytest.mark.parametrize("pad,x_offset", [((16, 16), 0), ((15, 16), 0),
                                          ((32, 0), 3), ((0, 7), -1)])
def test_padded_synthesis_is_pad_then_call(tier, pad, x_offset):
    _, hki = (_t(a) for a in _banks(16))
    x = _t(_rand(7, 2, 16, 40))
    got = cc.dense_synthesis_conv(x, hki, True, x_offset, tier, pad)
    ref = cc.dense_synthesis_conv(F.pad(x, pad), hki, True,
                                  x_offset - pad[0], tier)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    assert got.shape == (2, pad[0] + 40 + pad[1] - hki.shape[-1] + 1, 16)
    with pytest.raises(ValueError, match="non-negative"):
        cc.dense_synthesis_conv(x, hki, True, 0, tier, (-1, 0))


def test_k5_and_the_offline_synthesis_hand_k2_the_unpadded_input(
        monkeypatch):
    """K5's route and StreamingPQMF's offline and causal synthesis give K2
    the sub-bands themselves and the pad: no padded copy is written."""
    seen = []
    real = cc.dense_synthesis_conv

    def spy(x, w, fuse_mask=True, x_offset=0, mxu_precision="highest",
            pad=(0, 0), bank=None):
        seen.append((x.data_ptr(), tuple(x.shape), tuple(pad), x_offset))
        return real(x, w, fuse_mask, x_offset, mxu_precision, pad, bank)

    monkeypatch.setattr(cc, "dense_synthesis_conv", spy)
    p = jfb.build_filterbank(100, 16)
    hi = _t(p["hk_ipoly"])
    s = _t(_rand(8, 2, 16, 30))
    pk.synthesis_over_k2(s, hi)
    L = hi.shape[-1]
    same = (s.data_ptr(), tuple(s.shape))
    assert seen[-1] == (*same, (L // 2 - 1, L - L // 2), 0)
    sp = StreamingPQMF(100, 16, device="cpu")
    sp.inverse(s)
    assert seen[-1] == (*same, (16, 16), 0)
    sp.inverse_causal(s)
    assert seen[-1] == (*same, (32, 0), 0)


# ---------------------------------------------------------------------------
# the pinned CPU reference
# ---------------------------------------------------------------------------

_FLAGSHIP = """
import hashlib, sys
import numpy as np
import torch
from pqmf_tpu_torch import PQMFPitchShiftWrapper
shifts = [0, 4, -5, -12, 3, -7, 2, -3, 5, -9, 1, -1, -4, -6, -2, -24]
w = PQMFPitchShiftWrapper(100, 16, 2048, 44100, shifts, device="cpu")
x = np.random.default_rng(1).standard_normal((1, 2 * 2048)).astype(
    np.float32) * 0.3
s, out = w.init_state(), []
for blk in np.split(x, 2, axis=-1):
    s, y = w.pitchshift_fn(s, blk)
    out.append(y.numpy().tobytes())
print(torch.backends.cpu.get_cpu_capability(),
      hashlib.sha256(b"".join(out)).hexdigest())
"""

CPU_PIN = {"MKL_CBWR": "COMPATIBLE", "ATEN_CPU_CAPABILITY": "avx2"}


def _flagship_digest(extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("MKL_ENABLE_INSTRUCTIONS", "MKL_CBWR",
                        "ATEN_CPU_CAPABILITY")}
    env.update(CPU_PIN, **extra)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", _FLAGSHIP], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    return res.stdout.split()


def test_pinned_cpu_flagship_is_bit_equal_across_mkl_paths():
    """The CPU flagship (2048-sample blocks) with the pin: MKL's SSE4.2 path
    and its default give the same bits, at ATen's AVX2 level."""
    default = _flagship_digest({})
    sse42 = _flagship_digest({"MKL_ENABLE_INSTRUCTIONS": "SSE4_2"})
    assert default[0] == "AVX2"
    assert sse42 == default
