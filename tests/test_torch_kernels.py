"""The port's three conv kernels — K1 analysis, K2 synthesis, K3 fused
round trip — against pqmf_tpu's Pallas kernels (interpret mode on the CPU,
as tests/test_kernels.py runs them).

On the CPU a wrapper runs its kernel's plain PyTorch version; the CUDA
kernels themselves are checked against those plain versions on the card
(``tests/test_torch_cuda.py``). Tolerance: the JAX
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
    chunks); K3 takes every geometry the JAX gate takes (M = 8 to 64; from
    M = 32 its banks stream through chunk buffers), and M = 2 and 4, which
    the JAX gate refuses only for its 128-lane grouping of the synthesis
    left pad."""
    hkf, hki = _bank(M)
    Ka, Ks = hkf.shape[-1], hki.shape[-1]
    assert cc.supports(M, Ka, Ks)
    j_gate = jcc.fused_roundtrip_supported(M, centered_padding(Ks)[0])
    lane_only = not j_gate and jcc.fused_roundtrip_supported(M, 0)
    assert cc.fused_roundtrip_supported(M, Ka, Ks) == (j_gate or lane_only)
    assert lane_only == (M in (2, 4))
    assert cc.smem_bytes("roundtrip", 16, 16, 513, 33) <= cc.SMEM_LIMIT


def test_build_targets_hopper():
    """Every source compiles for sm_90a into an object, and the objects
    link into one library that holds every C entry the binding declares."""
    for source in _build.SOURCES:
        cmd = _build.nvcc_command("nvcc", source, _build.BUILD_DIR / "k.o")
        assert "arch=compute_90a,code=sm_90a" in cmd and "-c" in cmd
        assert str(source) in cmd and source.exists()
    objects = [_build.BUILD_DIR / f"{s.stem}.o" for s in _build.SOURCES]
    cmd = _build.link_command("nvcc", objects, _build.BUILD_DIR / "lib.so")
    assert "-shared" in cmd and all(str(o) in cmd for o in objects)
    text = "".join(s.read_text() for s in _build.SOURCES)
    for entry in ("pqmf_analysis_conv", "pqmf_synthesis_conv",
                  "pqmf_roundtrip_conv", "pqmf_tc_analysis_conv",
                  "pqmf_tc_synthesis_conv", "pqmf_tc_roundtrip_conv",
                  "pqmf_pv_frame", "pqmf_pv_spectral", "pqmf_pv_resynth"):
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


BLOCK_SUB = 8192 // 16  # sub-band steps of one flagship block


# ---------------------------------------------------------------------------
# launch plans (the CUDA source's pqmf_launch_plan, mirrored in Python; the
# card checks the mirror against the source in tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B", [1, 16])
def test_k2_plan_fills_the_card_at_block_shapes(B):
    """K2 at the flagship's sub-band block [B, 16, 512 + 32] launches at
    least one block per SM of an H100."""
    gx, gy, gz, threads, *_ = cc.launch_plan("synthesis", B, 16, 16, 0, 33,
                                             BLOCK_SUB)
    assert gx * gy * gz >= cc.N_SMS
    assert 1 <= threads <= 128



@pytest.mark.parametrize("Ka,Ks", [(513, 33), (512, 32)])
def test_k3_halo_is_small(Ka, Ks):
    """K3 recomputes at most 13% more sub-band steps than it outputs
    (streaming bank 513/33, offline polyphase bank 512/32)."""
    gx, _, _, threads, tile, n_sub, _, _ = cc.launch_plan(
        "roundtrip", 1, 16, 16, Ka, Ks, 60 * 44100 // 16 + 1)
    assert (tile + Ks - 1) / tile <= 1.13  # sub-band steps per output step
    assert tile >= 256 and tile + Ks - 1 <= n_sub
    assert gx == cc.N_SMS and threads == 256  # persistent: one an SM


@pytest.mark.parametrize("M", [2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("B,T_out", [(1, 1), (1, 37), (1, 512), (16, 512),
                                     (215, 256), (1, 165375)])
def test_plans_fit_and_cover(M, B, T_out):
    """Every plan of the committed banks fits one block's shared memory,
    stays inside its kernel's gate, and its tiles cover the output."""
    hkf, hki = _bank(M)
    Ka, Ks = hkf.shape[-1], hki.shape[-1]
    for which in ("analysis", "synthesis", "roundtrip"):
        if which == "roundtrip" and not cc.fused_roundtrip_supported(M, Ka,
                                                                     Ks):
            continue
        gx, gy, gz, threads, tile, aux, split, smem = cc.launch_plan(
            which, B, M, M, Ka, Ks, T_out)
        assert smem <= cc.smem_bytes(which, M, M, Ka, Ks) <= cc.SMEM_LIMIT
        assert gx >= 1 and gy >= 1 and gz >= 1
        if which == "roundtrip" and M >= 32:
            # the cluster K3: M/8 blocks a tile; whole files (from 16 m16
            # output tiles an SM) persistent clusters of 2x8 thread tiles,
            # smaller calls one tile of 16-64 steps a cluster of 1x4
            # thread tiles
            tiles = B * -(-T_out // tile)
            C = M // 8
            assert aux >= tile + Ks - 1 and threads % 32 == 0
            assert split == C and gx % C == 0 and threads <= 256
            if B * -(-T_out // 16) >= cc.N_SMS * 16:
                assert gx == min(tiles, cc.N_SMS // C) * C
            else:
                assert tile in (16, 32, 64) and gx == tiles * C
            continue
        assert 1 <= threads <= 256
        if which in ("analysis", "synthesis"):
            # K1's band groups and K2's phase groups: 4 channels each
            tiles = B * -(-T_out // tile)
            groups = threads // (tile // aux * split)
            assert gx <= tiles and gy * 4 * groups >= M and gz == 1
            assert (gy - 1) * 4 * groups < M  # no block without a channel
            assert tile % aux == 0 and split <= min(M, 16)
            if split > 1:
                assert gx == tiles  # one tile a block when the sum is split
            if which == "analysis":
                assert tile <= max(8, 4096 // M)  # the window's size
        else:
            assert gx == min(B * -(-T_out // tile), cc.N_SMS)


def test_k2_plan_keeps_big_tiles_for_long_calls():
    """A 60 s synthesis (K5's shape) needs no band split and takes
    256-step tiles of 8 phases; a 512-step block splits the sum."""
    long_call = cc.launch_plan("synthesis", 1, 16, 16, 0, 32, 165375)
    block = cc.launch_plan("synthesis", 1, 16, 16, 0, 33, BLOCK_SUB)
    assert long_call[6] == 1 and long_call[4] == 256
    assert long_call[:2] == (-(-165375 // 256), 2)
    assert block[6] == 16 and block[4] <= 32
    # a call with more tiles than fit on the card at once walks them
    many = cc.launch_plan("synthesis", 64, 16, 16, 0, 32, 165375)
    assert many[0] < 64 * -(-165375 // 256)


# ---------------------------------------------------------------------------
# K1: its launch plan and a NumPy model of its tiling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B", [1, 16])
def test_k1_plan_fills_the_card_at_block_shapes(B):
    """K1 at the flagship's block [B, 1, 8192 + 512] launches at least one
    block per SM of an H100 (its first design ran 8)."""
    gx, gy, gz, threads, *_ = cc.launch_plan("analysis", B, 16, 16, 513, 0,
                                             BLOCK_SUB)
    assert gx * gy * gz >= cc.N_SMS
    assert 1 <= threads <= 128


def test_k1_plan_is_persistent_at_60s():
    """K4's 60 s call (K1 at [1, 1, 2646000], K = 512, pad (256, 240))
    splits no sum and runs no more blocks than fit on the card at once,
    each staging its 8-band bank chunk once and walking 256-step tiles."""
    T_out = 60 * 44100 // 16
    gx, gy, gz, threads, tile, nt, split, smem = cc.launch_plan(
        "analysis", 1, 16, 16, 512, 0, T_out)
    assert split == 1 and tile == 256 and nt == 8
    tiles = -(-T_out // tile)
    assert gx < tiles  # persistent: blocks walk tiles
    per_sm = min(2048 // threads, cc._SMEM_PER_SM // (smem + 1024))
    assert gx * gy <= cc.N_SMS * per_sm
    J = 512 // 16
    window = 16 * ((tile + J + 4 + 3) & ~3) * 4
    assert smem == 4 * 16 * J * 8 + window  # bank chunk + one window


@pytest.mark.parametrize("M", [2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("shard", [1, 2])
@pytest.mark.parametrize("K_kind", ["streaming", "polyphase"])
def test_k1_plans_fit_band_shards(M, shard, K_kind):
    """Every K1 plan of the full bank and of an even band shard (half the
    bands, or 2) fits shared memory, and the shard's plan covers it."""
    K = {"streaming": 32 * M + 1, "polyphase": 32 * M}[K_kind]
    if M == 8 and K_kind == "streaming":
        K = 257  # the M=8 bank pads to 256 taps
    Mb = M if shard == 1 else max(2, M // 2)
    assert cc.smem_bytes("analysis", M, Mb, K, 0) <= cc.SMEM_LIMIT
    for B, T_out in [(1, 1), (1, 256), (16, 512), (1, 165375)]:
        gx, gy, _, threads, tile, nt, split, smem = cc.launch_plan(
            "analysis", B, M, Mb, K, 0, T_out)
        assert smem <= cc.smem_bytes("analysis", M, Mb, K, 0)
        groups = threads // (tile // nt * split)
        assert gy * 4 * groups >= Mb > (gy - 1) * 4 * groups
        assert gx <= B * -(-T_out // tile)


def k1_model(x, w, M, fuse_mask=True, pad=(0, 0), n_sms=cc.N_SMS):
    """K1's arithmetic as its launch plan tiles it, in f32 NumPy: per band
    chunk, the phase-major bank (zero past the last band); per
    tile, the polyphase window ``xp[r][tau] = xpad[M*(t0 + tau) + r]`` with
    zeros outside the input; thread ``ms`` of a split sums its phases
    ``r = ms, ms + MS, ...`` tap by tap; the split sums add in order of
    ``ms``; outputs past T_out are dropped; then the sign mask by the global
    step. Taps and window steps the kernel does not copy are NaN here, so
    a read of one would show. x [B, 1, T],
    w [Mb, 1, K] (numpy) -> [B, Mb, T_out]."""
    B, _, T = x.shape
    Mb, _, K = w.shape
    T_out = (pad[0] + T + pad[1] - K) // M + 1
    gx, gy, _, threads, Tt, NT, MS, _ = cc.launch_plan(
        "analysis", B, M, Mb, K, 0, T_out, n_sms=n_sms)
    SG = Tt // NT
    CB = 4 * (threads // (SG * MS))
    J = -(-K // M)
    XR = (Tt + J + 4 + 3) & ~3
    tiles_x = -(-T_out // Tt)
    n_tiles = B * tiles_x
    # every tile's window at once: [n_tiles, M, XR]
    rows = np.arange(n_tiles) // tiles_x
    p0 = (np.arange(n_tiles) % tiles_x) * Tt * M - pad[0]
    p = p0[:, None] + np.arange(M * XR)[None, :]
    inside = (p >= 0) & (p < T)
    xp = np.where(inside, x[rows[:, None], 0, np.clip(p, 0, T - 1)], 0)
    xp = xp.astype(np.float32).reshape(n_tiles, XR, M).transpose(0, 2, 1)
    xp[:, :, Tt + J - 1:] = np.nan  # not copied: must never be multiplied
    out = np.full((B, Mb, tiles_x * Tt), np.nan, np.float32)
    for y in range(gy):
        c0 = y * CB
        wa = np.zeros((M, J, CB), np.float32)  # wa[r, j, c]
        for c in range(min(CB, Mb - c0)):
            taps = np.full(J * M, np.nan, np.float32)  # past K: not copied
            taps[:K] = w[c0 + c, 0]
            wa[:, :, c] = taps.reshape(J, M).T
        total = np.zeros((n_tiles, CB, Tt), np.float32)
        for ms in range(MS):
            acc = np.zeros((n_tiles, CB, Tt), np.float32)
            for r in range(ms, M, MS):
                nq = (K - r + M - 1) // M
                # slide_fma reads x[0 .. nq + NT + 3] from each thread's
                # first step (inside the window row) and multiplies
                # x[0 .. nq + NT - 2]
                assert (SG - 1) * NT + nq + NT + 3 < XR
                for j in range(nq):
                    acc += (wa[r, j][None, :, None]
                            * xp[:, r, None, j:j + Tt])
            total = total + acc if MS > 1 else acc
        cb = min(CB, Mb - c0)
        out[:, c0:c0 + cb] = total[:, :cb].reshape(
            B, tiles_x, cb, Tt).transpose(0, 2, 1, 3).reshape(B, cb, -1)
    out = out[..., :T_out]
    if fuse_mask:
        out[:, 1::2, 0::2] *= -1
    return out


# (M, Mb, K, B, pad, T_out of the plan whose tile is probed)
K1_CASES = {
    "flagship K=513 B=1": (16, 16, 513, 1, (256, 256), 512),
    "flagship K=513 B=3": (16, 16, 513, 3, (256, 256), 37),
    "K4 K=512 pad (256,240)": (16, 16, 512, 2, (256, 240), 512),
    "K4 persistent B=16": (16, 16, 512, 16, (256, 240), 2304),
    "TA M=8 K=257": (8, 8, 257, 1, (128, 128), 256),
    "M=32 chunks K=1025": (32, 32, 1025, 1, (0, 0), 600),
    "M=64 chunks K=2049 causal": (64, 64, 2049, 1, (1985, 0), 300),
    "shard Mb=6 (short chunk)": (16, 6, 513, 2, (7, 3), 512),
    "M=2 K=65": (2, 2, 65, 1, (32, 32), 4096),
}


@pytest.mark.parametrize("case", list(K1_CASES))
@pytest.mark.parametrize("edge", [-1, 0, 1])
def test_k1_tiling_model_matches_plain(case, edge):
    """The NumPy model of K1's tiling equals analysis_conv_plain within
    K12_TOL at T_out one short of, at and one past a multiple of the tile
    (ragged tiles), odd and even K, pads, split and unsplit sums, band
    chunks at M=32/64 and a band shard with a short last chunk."""
    M, Mb, K, B, pad, t_probe = K1_CASES[case]
    tile = cc.launch_plan("analysis", B, M, Mb, K, 0, t_probe)[4]
    T_out = max(1, (t_probe // tile) * tile + edge)
    rng = np.random.default_rng(M * 1000 + Mb * 10 + edge + 2)
    T = (T_out - 1) * M + K - pad[0] - pad[1] + int(rng.integers(0, M))
    x = rng.standard_normal((B, 1, T)).astype(np.float32)
    w = (rng.standard_normal((Mb, 1, K)) / np.sqrt(K)).astype(np.float32)
    for fuse in (True, False):
        got = k1_model(x, w, M, fuse, pad)
        ref = cc.analysis_conv_plain(_t(x), _t(w), M, fuse, pad)
        assert got.shape == tuple(ref.shape) == (B, Mb, T_out)
        np.testing.assert_allclose(got, ref.numpy(), **TOL)


@pytest.mark.parametrize("pad", [(0, 0), (256, 256), (5, 0), (0, 17)])
def test_k1_pad_is_the_padded_call(pad):
    """``strided_analysis_conv(x, pad=p)`` equals the call on ``F.pad(x,
    p)`` (the CPU route is one formula for both)."""
    hkf, _ = _bank(16)
    x = _t(np.random.default_rng(sum(pad)).standard_normal(
        (2, 1, 16 * 40 + 3)).astype(np.float32))
    padded = torch.nn.functional.pad(x, pad)
    for fuse in (True, False):
        got = cc.strided_analysis_conv(x, _t(hkf), 16, fuse, pad=pad)
        want = cc.strided_analysis_conv(padded, _t(hkf), 16, fuse)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError, match="non-negative"):
        cc.strided_analysis_conv(x, _t(hkf), 16, pad=(-1, 0))
