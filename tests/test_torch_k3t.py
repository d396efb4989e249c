"""K3t, the tensor-core fused round trip, and the analysis pad of K3/K3t —
on the CPU.

- A NumPy model of K3t as its launch plan runs it: per tile the signal
  window from ``M*(t0 - syn_left) - pad_left`` (zeros outside the input),
  the analysis GEMM over the arranged analysis bank (decoded from the mma's
  fragment layout, ``tests/test_torch_tc_bank.py``), sub-band rows outside
  the signal zeroed, the sub-bands split again, the synthesis GEMM over the
  arranged synthesis bank, gain M. Its sub-band rows and its outputs are
  within atol=2e-5 / rtol=1e-4 of the plain versions (the JAX package's
  kernel-vs-lax bar: the same exact products summed in another order).
  Where the model's f32 sub-bands may differ from the plain version's by an
  f32 ulp, a "default" split could flip by a bf16 ulp, so its synthesis is
  held on the plain version's sub-bands (as the card tests bound the flip).
- The swizzled signal window and sub-band tile serve every ldmatrix.x4 of
  both phases from where the kernel (and the analysis epilogue) stores
  them, without bank conflicts at M >= 8.
- K3t's plans fit the card, cover every output step once, and spread a host
  block over 32 blocks.
- At M = 32 and 64, the cluster split: each block of the cluster stages
  its channels of both arranged banks (a channel block by 16-byte copies,
  or half of one by 8-byte copies, decoded here against the bank's B
  matrix), computes those sub-bands into its own swizzled sub-band tile,
  gathers the other blocks' 16-byte chunks from where they stored them,
  and computes its output channels; the model of that against the plain
  version as above.
- ``pad=`` is ``F.pad`` then the call, bit for bit, at every tier; a wrong
  ``banks=`` raises; ``StreamingPQMF.roundtrip`` and ``PQMF.roundtrip``
  hand K3 the unpadded signal and their kept banks; K6's route without its
  pad copy and slice is bit-equal to the route it replaced.
- ``StreamingPQMF.roundtrip`` at each tier on bench.py's signal against
  ``pqmf_tpu``: ``bf16x3`` within the bar above of JAX's Pallas kernel (in
  interpret mode), ``default`` within 45-80 dB of JAX's ``highest`` (JAX on
  the CPU computes ``default`` in f32).
The kernels run only on the card (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pqmf_tpu.kernels import cached_conv as jcc
from pqmf_tpu.ops import filterbank as jfb
from pqmf_tpu.streaming import StreamingPQMF as JStreamingPQMF
from pqmf_tpu.streaming import kernels_from_params as j_kernels
from pqmf_tpu_torch import PQMF, StreamingPQMF
from pqmf_tpu_torch.kernels import cached_conv as cc
from pqmf_tpu_torch.kernels import polyphase as pk
from pqmf_tpu_torch.utils.metrics import snr_db

TOL = dict(atol=2e-5, rtol=1e-4)
TIERS = ("bf16x3", "default")


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _banks(M):
    hkf, hki = j_kernels(jfb.build_filterbank(100, M))
    return np.asarray(hkf), np.asarray(hki)


def _split(a):
    """JAX's split of a float32 array: (hi, lo) as float64."""
    hi, lo = jcc._split_bf16(jnp.asarray(a, jnp.float32))
    return [np.asarray(h.astype(jnp.float32)).astype(np.float64)
            for h in (hi, lo)]


def _decode(words):
    """B's halves [H, Qp, Np] (float64) from an arranged bank [H, 1, n_k,
    32, 4*NN]: lane 4g + tq of k-step ks holds, for n8 tile nn, rows 2tq,
    2tq+1 (b0) and 2tq+8, 2tq+9 (b1) of column 8nn + g."""
    w = words.float().numpy()
    H, n_cb, n_k, _, W = w.shape
    NN = W // 4
    out = np.zeros((H, 16 * n_k, 8 * NN * n_cb))
    for lane in range(32):
        g, tq = divmod(lane, 4)
        for nn in range(NN):
            for j in range(2):
                for e in range(2):
                    q = 16 * np.arange(n_k) + 2 * tq + 8 * j + e
                    out[:, q, 8 * nn + g] = w[:, 0, :, lane, 4 * nn + 2 * j + e]
    return out


def _gemm(win, S, rows, B_halves, tier):
    """sum over the tier's products of A[t, q] = win[S*t + q] (win split)
    times the decoded bank's halves, float64."""
    Qp = B_halves.shape[1]
    idx = S * np.arange(rows)[:, None] + np.arange(Qp)[None]
    A = [h[idx] for h in _split(win)]
    y = A[0] @ B_halves[0]
    if tier == "bf16x3":
        y = y + A[0] @ B_halves[1] + A[1] @ B_halves[0]
    return y


def model_k3t(x, w_ana, w_syn, M, syn_pad, pad, tier, plan, mid=None):
    """K3t as ``plan`` (``launch_plan("roundtrip", ...)``) runs it. Returns
    (output [B, T_out, M], the f32 sub-band rows its tiles computed, as
    [B, T_ana] slices keyed by (b, tau)). ``mid``: the padded f32 sub-bands
    [B, M, syn_left + T_ana + syn_right] the synthesis reads in place of the
    model's own."""
    B, _, T = x.shape
    Ka, Ks = w_ana.shape[-1], w_syn.shape[-1]
    T_ana = (pad[0] + T + pad[1] - Ka) // M + 1
    T_out = syn_pad[0] + T_ana + syn_pad[1] - Ks + 1
    Tt, n_sub = plan[4], plan[5]
    Ba = _decode(cc.arrange_tc_bank(_t(w_ana), "analysis", tier).words)
    Bs = _decode(cc.arrange_tc_bank(_t(w_syn), "synthesis", tier).words)
    Qa, Qs = Ba.shape[1], Bs.shape[1]
    assert n_sub >= Tt - 1 + -(-Qs // M)  # every row an output reads
    out = np.full((B, T_out, M), np.nan, np.float32)
    sub_rows = {}
    WL = M * (n_sub - 1) + Qa
    for b in range(B):
        for t0 in range(0, T_out, Tt):
            p = M * (t0 - syn_pad[0]) - pad[0] + np.arange(WL)
            win = np.where((p >= 0) & (p < T), x[b, 0, np.clip(p, 0, T - 1)],
                           0.0).astype(np.float32)
            sub = _gemm(win, M, n_sub, Ba, tier)[:, :M].astype(np.float32)
            tau = t0 - syn_pad[0] + np.arange(n_sub)
            inside = (tau >= 0) & (tau < T_ana)
            sub[~inside] = 0.0
            for s in np.nonzero(inside)[0]:
                sub_rows[b, tau[s]] = sub[s]
            if mid is not None:
                j = t0 + np.arange(n_sub)
                ok = j < mid.shape[-1]
                sub[ok] = mid[b][:, j[ok]].T
            y = _gemm(sub.reshape(-1), M, Tt, Bs, tier)[:, :M] * M
            n_out = min(Tt, T_out - t0)
            out[b, t0:t0 + n_out] = y[:n_out]
    return out, sub_rows


PLAN_SHAPES = [  # (B, T_sub, n_sms): host block (small plan) or whole file
    (2, 96, 132), (1, 300, 4), (3, 41, 132)]


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("M", [2, 4, 8, 16])
@pytest.mark.parametrize("B,T_sub,n_sms", PLAN_SHAPES)
def test_model_over_arranged_banks_is_plain_k3t(M, tier, B, T_sub, n_sms):
    hkf, hki = _banks(M)
    Ka, Ks = hkf.shape[-1], hki.shape[-1]
    pad, syn_pad = (Ka // 2, Ka // 2 - 3), (Ks // 2, Ks // 2 + 1)
    x = _rand(M * T_sub + B, B, 1, M * T_sub + 5)
    want = cc.roundtrip_conv_plain(_t(x), _t(hkf), _t(hki), M, syn_pad,
                                   tier, pad).numpy()
    T_ana = (pad[0] + x.shape[-1] + pad[1] - Ka) // M + 1
    plan = cc.launch_plan("roundtrip", B, M, M, Ka, Ks, want.shape[1],
                          n_sms=n_sms, precision=tier)
    # the plain version's sub-bands (its first half), zero-padded
    mid = cc.analysis_conv_plain(_t(x), _t(hkf), M, True, pad,
                                 tier).numpy()
    mid[:, 1::2, ::2] *= -1  # undo reverse_half: the kernel's masks cancel
    mid_p = np.pad(mid, ((0, 0), (0, 0), syn_pad))
    got, rows = model_k3t(x, hkf, hki, M, syn_pad, pad, tier, plan, mid_p)
    assert len(rows) == B * T_ana  # every sub-band step, by some tile
    for (b, tau), r in rows.items():
        np.testing.assert_allclose(r, mid[b, :, tau], **TOL)
    np.testing.assert_allclose(got, want, **TOL)
    if tier == "bf16x3":  # the model's own sub-bands, split again
        got, _ = model_k3t(x, hkf, hki, M, syn_pad, pad, tier, plan)
        np.testing.assert_allclose(got, want, **TOL)


def _swizzle(u, swz):
    return u ^ ((u >> 3) & swz)


@pytest.mark.parametrize("M", [2, 4, 8, 16])
@pytest.mark.parametrize("B,T_out,n_sms", [(1, 512, 132), (16, 512, 132),
                                           (1, 165377, 132)])
def test_swizzled_windows_serve_ldmatrix_without_conflicts(M, B, T_out,
                                                           n_sms):
    """K3t's two windows, the split signal window (n_sub rows of stride M,
    Qa columns) and the split sub-band tile (Tt rows, Qs columns), stored at
    16-byte chunk swizzle(i >> 3): the analysis epilogue's pair stores land
    each sub-band (s, c) at row s, column c of the tile; every ldmatrix.x4
    of both phases (rows 16 apart from each item's first, two chunks a
    k-step) reads its 8 elements where they were stored; at M >= 8 the 8
    rows of each matrix hit 8 distinct bank groups."""
    hkf, hki = _banks(M)
    Ka, Ks = hkf.shape[-1], hki.shape[-1]
    plan = cc.launch_plan("roundtrip", B, M, M, Ka, Ks, T_out, n_sms=n_sms,
                          precision="bf16x3")
    Tt, n_sub = plan[4], plan[5]
    swz = min(M // 8, 8) - 1 if M >= 8 else 0
    Qa, Qs = -(-Ka // 16) * 16, -(-M * Ks // 16) * 16
    WL = -(-(M * (n_sub - 1) + Qa) // 64) * 64
    i = np.arange(WL)
    store = np.full(WL, -1, np.int64)
    store[8 * _swizzle(i >> 3, swz) + (i & 7)] = i  # the split pass
    assert (np.sort(store) == i).all()
    tile = np.full(WL, -1, np.int64)  # the analysis epilogue's pairs
    for s in range(n_sub):
        for c in range(0, M, 2):
            e = s * M + c
            tile[8 * _swizzle(e >> 3, swz) + (e & 7) + np.arange(2)] = \
                e + np.arange(2)
    for buf, rows, Qp in [(store, n_sub, Qa), (tile, Tt, Qs)]:
        lanes = np.arange(32)
        for r0 in range(0, rows, 16):
            for ks in range(Qp // 16):
                if M % 8:  # 32-bit pairs: the plain layout, read in place
                    assert swz == 0
                    continue
                u = M * (r0 + (lanes & 15)) // 8 + (lanes >> 4) + 2 * ks
                for lane in lanes:
                    row, col = r0 + (lane & 15), 16 * ks + 8 * (lane >> 4)
                    got = buf[8 * _swizzle(u[lane], swz) + np.arange(8)]
                    assert (got == M * row + col + np.arange(8)).all()
                if M >= 8:
                    for mat in range(4):
                        groups = _swizzle(u[8 * mat:8 * mat + 8], swz) % 8
                        assert len(set(groups.tolist())) == 8
    assert M * n_sub <= WL  # the sub-band tile fits the window's place


K3T_PLANS = [  # (B, M, Ka, Ks, T_out): [1,1,8704], [16,1,8704], 60 s,
    # 215 x 4096 (stream_ola), the offline 60 s, M = 2..8
    (1, 16, 513, 33, 512), (16, 16, 513, 33, 512),
    (1, 16, 513, 33, 165377), (215, 16, 513, 33, 256),
    (1, 16, 512, 32, 165375), (1, 2, 65, 33, 300), (3, 4, 129, 33, 4097),
    (1, 8, 257, 33, 300), (2, 8, 257, 33, 120000), (1, 2, 65, 33, 80000)]


@pytest.mark.parametrize("case", K3T_PLANS,
                         ids=lambda c: "-".join(map(str, c)))
def test_k3t_plans_fit_and_cover(case):
    B, M, Ka, Ks, T_out = case
    for tier in TIERS:
        gx, gy, gz, threads, Tt, n_sub, split, smem = cc.launch_plan(
            "roundtrip", B, M, M, Ka, Ks, T_out, precision=tier)
        gate = cc.smem_bytes("roundtrip", M, M, Ka, Ks, tier)
        assert smem <= gate <= cc.SMEM_LIMIT
        assert (gy, gz, threads, split) == (1, 1, 256, 1)
        rows_s = -(-(-(-M * Ks // 16) * 16) // M)
        assert n_sub >= Tt - 1 + rows_s and n_sub % 16 == 0
        tiles_x = -(-T_out // Tt)
        seen = np.zeros((B, tiles_x * Tt), np.int64)
        for blk in range(gx):
            for tl in range(blk, B * tiles_x, gx):
                b, t0 = divmod(tl, tiles_x)
                seen[b, t0 * Tt:(t0 + 1) * Tt] += 1
        assert (seen == 1).all()
        per_sm = min(8, cc._SMEM_PER_SM // (smem + 1024))
        if B * -(-T_out // 16) >= cc.N_SMS * 16:  # whole files: persistent
            assert Tt % 32 == 0 and gx <= cc.N_SMS * per_sm
            if (M, Ka) == (16, 513):
                assert (Tt, n_sub) == (224, 256) and per_sm >= 2
        else:  # one tile a block, of 16-64 steps
            assert Tt in (16, 32, 64) and gx == B * tiles_x
        if (B, M, T_out) == (1, 16, 512):
            assert gx == 32 and Tt == 16  # a host block on 32 SMs


@pytest.mark.parametrize("tier", ["highest", *TIERS])
@pytest.mark.parametrize("pad,syn_pad", [((256, 256), (16, 16)),
                                         ((0, 7), (3, 0)),
                                         ((13, 0), (15, 16))])
def test_padded_roundtrip_is_pad_then_call(tier, pad, syn_pad):
    hkf, hki = (_t(a) for a in _banks(16))
    x = _t(_rand(3, 2, 1, 16 * 80 + 9))
    got = cc.fused_roundtrip_conv(x, hkf, hki, 16, syn_pad, tier, pad)
    ref = cc.fused_roundtrip_conv(F.pad(x, pad), hkf, hki, 16, syn_pad, tier)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    with pytest.raises(ValueError, match="non-negative"):
        cc.fused_roundtrip_conv(x, hkf, hki, 16, syn_pad, tier, (-1, 0))


def test_banks_of_another_kind_tier_or_shape_raise():
    hkf, hki = (_t(a) for a in _banks(8))
    x = _t(_rand(4, 1, 1, 8 * 40 + 256))
    a3 = cc.arrange_tc_bank(hkf, "analysis", "bf16x3")
    s3 = cc.arrange_tc_bank(hki, "synthesis", "bf16x3")
    s1 = cc.arrange_tc_bank(hki, "synthesis", "default")
    other = cc.arrange_tc_bank(_t(_banks(16)[0]), "analysis", "bf16x3")
    for banks in [(s3, s3), (a3, a3), (a3, s1), (other, s3)]:
        with pytest.raises(ValueError, match="arranged bank is for"):
            cc.fused_roundtrip_conv(x, hkf, hki, 8, (16, 16), "bf16x3",
                                    banks=banks)
    with pytest.raises(ValueError):
        cc.fused_roundtrip_conv(x, hkf, hki, 8, (16, 16), "bf16x3",
                                banks=(a3,))
    with pytest.raises(ValueError, match="'bf16x3' and 'default'"):
        cc.fused_roundtrip_conv(x, hkf, hki, 8, (16, 16), "highest",
                                banks=(a3, s3))
    got = cc.fused_roundtrip_conv(x, hkf, hki, 8, (16, 16), "bf16x3",
                                  banks=(a3, s3))
    np.testing.assert_array_equal(got.numpy(), cc.fused_roundtrip_conv(
        x, hkf, hki, 8, (16, 16), "bf16x3").numpy())


def test_roundtrips_hand_k3_the_unpadded_signal_and_the_kept_banks(
        monkeypatch):
    """``StreamingPQMF.roundtrip`` and ``PQMF.roundtrip`` (K6) give K3 the
    signal itself with the analysis pad as an argument, and at a tier the
    banks they keep (the same objects): no padded copy, no per-call
    arrangement."""
    seen = []
    real = cc.fused_roundtrip_conv

    def spy(x, w_ana, w_syn, M, syn_pad, precision="highest", pad=(0, 0),
            banks=None):
        seen.append((x.data_ptr(), tuple(x.shape), tuple(pad),
                     tuple(syn_pad), banks))
        return real(x, w_ana, w_syn, M, syn_pad, precision, pad, banks)

    monkeypatch.setattr(cc, "fused_roundtrip_conv", spy)
    x = _t(_rand(6, 1, 1, 16 * 64))
    for tier in ("highest", *TIERS):
        sp = StreamingPQMF(100, 16, precision=tier, device="cpu")
        sp.roundtrip(x)
        kept = None if tier == "highest" else (sp.tc_banks["analysis"],
                                                sp.tc_banks["synthesis"])
        ptr, shape, pad, syn_pad, banks = seen[-1]
        assert (ptr, shape, pad, syn_pad) == (x.data_ptr(), (1, 1, 1024),
                                              (256, 256), (16, 16))
        assert banks is None if kept is None else \
            all(a is b for a, b in zip(banks, kept))
        # PQMF hands K6 its kept banks; K6's route hands them to K3 with
        # the signal itself and both pads (on the CPU K6 runs its plain
        # version, so its route is called here as K6 calls it on a card)
        pq = PQMF(100, 16, precision=tier, device="cpu")
        k6 = []
        real_k6 = pk.polyphase_roundtrip
        monkeypatch.setattr(pk, "polyphase_roundtrip",
                            lambda *a: k6.append(a) or real_k6(*a))
        pq.roundtrip(x)
        monkeypatch.setattr(pk, "polyphase_roundtrip", real_k6)
        kept = None if tier == "highest" else (pq.tc_banks["analysis"],
                                                pq.tc_banks["synthesis"])
        assert k6[-1][4] == tier and (k6[-1][5] is None if kept is None
                                      else all(a is b for a, b in
                                               zip(k6[-1][5], kept)))
        hi = pq.params["hk_ipoly"]
        pk.roundtrip_over_k3(x, pq._w2, hi, 16, tier, kept)
        L = hi.shape[-1]
        ptr, shape, pad, syn_pad, banks = seen[-1]
        assert (ptr, shape, pad) == (x.data_ptr(), (1, 1, 1024),
                                     (16 * (L // 2), 16 * (L - L // 2 - 1)))
        assert syn_pad == (L // 2 - 1, L - L // 2)  # K5's own pad
        assert banks is kept


def _k6_before(x, w2, hk_ipoly, M, precision):
    """K6's route as it was: a padded copy of the signal, K3 with the
    synthesis pad one wider on the left, and output step 0 dropped."""
    B, _, T = x.shape
    L, Ls = w2.shape[-1] // M, hk_ipoly.shape[-1]
    out = cc.fused_roundtrip_conv(F.pad(x, pk._analysis_pad(M, L)), w2,
                                  hk_ipoly, M, (Ls // 2, Ls - Ls // 2),
                                  precision)
    return out[:, 1:, :].reshape(B, 1, T)


@pytest.mark.parametrize("tier", ["highest", *TIERS])
@pytest.mark.parametrize("M", [4, 16])
def test_k6_route_without_its_copies_is_the_old_route(tier, M):
    p = jfb.build_filterbank(100, M)
    hp, hi = _t(p["hk_poly"]), _t(p["hk_ipoly"])
    w2 = pk.analysis_weights(hp)
    x = _t(_rand(M + 2, 2, 1, M * 96))
    got = pk.roundtrip_over_k3(x, w2, hi, M, tier)
    np.testing.assert_array_equal(got.numpy(),
                                  _k6_before(x, w2, hi, M, tier).numpy())


def _bench_signal(n):
    """bench.py's signal: a 440 Hz sine plus seeded noise (bench._signal)."""
    rng = np.random.default_rng(0)
    t = np.arange(n, dtype=np.float32) / 44100
    return (0.5 * np.sin(2 * np.pi * 440 * t)
            + 0.1 * rng.standard_normal(n).astype(np.float32)).astype(
                np.float32)


@pytest.fixture(scope="module")
def bench_x():
    return _bench_signal(16 * 512)[None, None]


def test_bf16x3_roundtrip_on_the_bench_signal_matches_jax(bench_x):
    jp = JStreamingPQMF(100, 16, use_pallas=True, precision="bf16x3")
    tp = StreamingPQMF(100, 16, precision="bf16x3", device="cpu")
    np.testing.assert_allclose(tp.roundtrip(bench_x).numpy(),
                               np.asarray(jp.roundtrip(bench_x)), **TOL)


def test_default_roundtrip_on_the_bench_signal_keeps_jax_bar(bench_x):
    """JAX on the CPU computes "default" in f32; its own bar for the tier
    is the round trip within 45 dB of "highest" (tests/test_kernels.py)."""
    jp = JStreamingPQMF(100, 16, use_pallas=True)
    tp = StreamingPQMF(100, 16, precision="default", device="cpu")
    db = snr_db(np.asarray(jp.roundtrip(bench_x)),
                tp.roundtrip(bench_x).numpy())
    assert 45 <= db < 80, db


# ---------------------------------------------------------------------------
# M = 32 and 64: a thread-block cluster of M/8 blocks a tile
# ---------------------------------------------------------------------------


def _decode_block(words, rank, nn):
    """The B columns block ``rank`` of a K3t cluster stages, [H, Qp, 8 nn]
    (float64): from the arranged bank [H, n_cb, n_k, 32, 8] (NN = 2) the
    kernel copies, for blocks of nn = 2 n8 tiles, channel block ``rank``
    whole (16 bytes a lane a k-step); for nn = 1 channel block rank // 2,
    words 4 (rank % 2) .. +3 of each lane (8 bytes), into the layout of one
    n8 tile. Lane 4g + tq holds, for n8 tile t, rows 2tq, 2tq+1 (b0) and
    2tq+8, 2tq+9 (b1) of column 8t + g."""
    w = words.float().numpy()
    H, n_cb, n_k, _, W = w.shape
    assert W == 8
    staged = (w[:, rank] if nn == 2 else
              w[:, rank // 2, :, :, 4 * (rank % 2):4 * (rank % 2) + 4])
    out = np.full((H, 16 * n_k, 8 * nn), np.nan)
    for lane in range(32):
        g, tq = divmod(lane, 4)
        for t in range(nn):
            for j in range(2):
                for e in range(2):
                    q = 16 * np.arange(n_k) + 2 * tq + 8 * j + e
                    out[:, q, 8 * t + g] = staged[:, :, lane,
                                                  4 * t + 2 * j + e]
    return out


def _gather_tile(own, M, n_sub, C, swz):
    """The split sub-band tile of every block after the gather: block k's
    array holds its own chunks (row s, channels 8 nn k .. 8 nn (k+1) - 1,
    nn = M / (8 C)) where its analysis stored them; it copies chunk u of
    every other owner (u % (M/8)) // nn from the owner's array at the
    swizzled place. Returns the arrays."""
    got = []
    nn = M // (8 * C)
    for rank in range(C):
        mine = own[rank].copy()
        for u in range(n_sub * M // 8):
            owner = (u % (M // 8)) // nn
            if owner != rank:
                o = 8 * _swizzle(u, swz)
                mine[o:o + 8] = own[owner][o:o + 8]
        got.append(mine)
    return got


def model_k3t_cluster(x, w_ana, w_syn, M, syn_pad, pad, tier, plan,
                      mid=None):
    """K3t at M = 32 / 64 as ``plan`` runs it: per tile and block of the
    cluster, the analysis over the block's bank slice into its swizzled
    sub-band tile (one half's values; the model keeps them in float64 and
    splits at the synthesis), the gather, then the synthesis over the
    block's synthesis slice into its 8 output channels. ``mid`` as in
    :func:`model_k3t`."""
    B, _, T = x.shape
    Ka, Ks = w_ana.shape[-1], w_syn.shape[-1]
    T_ana = (pad[0] + T + pad[1] - Ka) // M + 1
    T_out = syn_pad[0] + T_ana + syn_pad[1] - Ks + 1
    Tt, n_sub, C = plan[4], plan[5], plan[6]
    nn = M // (8 * C)  # n8 tiles a block
    assert nn in (1, 2)
    swz = min(M // 8, 8) - 1
    banks = [(_decode_block(cc.arrange_tc_bank(_t(w_ana), "analysis",
                                               tier).words, k, nn),
              _decode_block(cc.arrange_tc_bank(_t(w_syn), "synthesis",
                                               tier).words, k, nn))
             for k in range(C)]
    Qa = banks[0][0].shape[1]
    out = np.full((B, T_out, M), np.nan, np.float32)
    WL = M * (n_sub - 1) + Qa
    for b in range(B):
        for t0 in range(0, T_out, Tt):
            p = M * (t0 - syn_pad[0]) - pad[0] + np.arange(WL)
            win = np.where((p >= 0) & (p < T), x[b, 0, np.clip(p, 0, T - 1)],
                           0.0).astype(np.float32)
            tau = t0 - syn_pad[0] + np.arange(n_sub)
            inside = (tau >= 0) & (tau < T_ana)
            own = []
            for k in range(C):
                sub = _gemm(win, M, n_sub, banks[k][0], tier).astype(
                    np.float32)
                sub[~inside] = 0.0
                arr = np.full(M * n_sub, np.nan, np.float32)
                i = (np.arange(n_sub)[:, None] * M + 8 * nn * k
                     + np.arange(8 * nn)[None]).ravel()
                arr[8 * _swizzle(i >> 3, swz) + (i & 7)] = sub.ravel()
                own.append(arr)
            tiles = _gather_tile(own, M, n_sub, C, swz)
            i = np.arange(M * n_sub)
            for k in range(C):
                full = tiles[k][8 * _swizzle(i >> 3, swz) + (i & 7)]
                assert np.isfinite(full).all()  # every chunk gathered
                full = full.reshape(n_sub, M)
                if mid is not None:
                    j = t0 + np.arange(n_sub)
                    ok = j < mid.shape[-1]
                    full[ok] = mid[b][:, j[ok]].T
                y = _gemm(full.reshape(-1), M, Tt, banks[k][1], tier) * M
                n_out = min(Tt, T_out - t0)
                out[b, t0:t0 + n_out, 8 * nn * k:8 * nn * (k + 1)] = \
                    y[:n_out]
    return out


@pytest.mark.parametrize("nn", [1, 2])
@pytest.mark.parametrize("M", [32, 64])
@pytest.mark.parametrize("tier", TIERS)
def test_cluster_blocks_stage_their_bank_slices(M, tier, nn):
    """Each block's staged slice of both arranged banks (a channel block,
    nn = 2, or half of one) is its 8 nn columns of the banks' B matrices
    (``_tc_b_matrix``), split into the tier's halves, zero past the
    reduction; and the plan gives a block a whole channel block exactly
    where that slice fits (M = 32 at both tiers, M = 64 at default)."""
    hkf, hki = _banks(M)
    for w, kind in ((hkf, "analysis"), (hki, "synthesis")):
        Bm = cc._tc_b_matrix(_t(w), kind).double().numpy()
        halves = _split(Bm.astype(np.float32))[:2 if tier == "bf16x3" else 1]
        words = cc.arrange_tc_bank(_t(w), kind, tier).words
        for k in range(M // (8 * nn)):
            got = _decode_block(words, k, nn)
            Q = Bm.shape[0]
            for h, want in enumerate(halves):
                np.testing.assert_array_equal(
                    got[h, :Q], want[:, 8 * nn * k:8 * nn * (k + 1)])
                assert (got[h, Q:] == 0).all()
    g = cc._rt_tc_geom(M, hkf.shape[-1], hki.shape[-1], tier)
    assert g["bNN"] == (1 if (M, tier) == (64, "bf16x3") else 2)
    assert g["C"] == M // (8 * g["bNN"])


CLUSTER_SHAPES = [  # (B, T_sub, n_sms): host blocks, a persistent plan
    (1, 96, 132), (3, 41, 132), (1, 1100, 4)]


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("M", [32, 64])
@pytest.mark.parametrize("B,T_sub,n_sms", CLUSTER_SHAPES)
def test_cluster_model_over_arranged_banks_is_plain_k3t(M, tier, B, T_sub,
                                                        n_sms):
    hkf, hki = _banks(M)
    Ka, Ks = hkf.shape[-1], hki.shape[-1]
    pad, syn_pad = (Ka // 2, Ka // 2 - 3), (Ks // 2, Ks // 2 + 1)
    x = _rand(M * T_sub + B, B, 1, M * T_sub + 5)
    want = cc.roundtrip_conv_plain(_t(x), _t(hkf), _t(hki), M, syn_pad,
                                   tier, pad).numpy()
    plan = cc.launch_plan("roundtrip", B, M, M, Ka, Ks, want.shape[1],
                          n_sms=n_sms, precision=tier)
    assert plan[6] in (M // 8, M // 16) and plan[0] % plan[6] == 0
    assert (plan[4] > 64) == (n_sms == 4)  # the persistent plan there
    mid = cc.analysis_conv_plain(_t(x), _t(hkf), M, True, pad,
                                 tier).numpy()
    mid[:, 1::2, ::2] *= -1  # undo reverse_half: the kernel's masks cancel
    mid_p = np.pad(mid, ((0, 0), (0, 0), syn_pad))
    got = model_k3t_cluster(x, hkf, hki, M, syn_pad, pad, tier, plan, mid_p)
    np.testing.assert_allclose(got, want, **TOL)
    if tier == "bf16x3":  # the model's own sub-bands, split again
        got = model_k3t_cluster(x, hkf, hki, M, syn_pad, pad, tier, plan)
        np.testing.assert_allclose(got, want, **TOL)
