"""The streaming path's three conv kernels, their plain versions and gates.

Each public function here is the wrapper of one hand-written Hopper kernel
at each precision tier: at ``"highest"`` (full f32) the CUDA-core kernels of
``pqmf_tpu_torch/csrc/cached_conv.cu``, at ``"bf16x3"`` and ``"default"``
the tensor-core kernels K1t/K2t/K3t of ``csrc/cached_conv_tc.cu`` (both
built into one library and bound by ``_build``):

- K1 :func:`strided_analysis_conv` replaces
  ``pqmf_tpu/kernels/cached_conv.py:strided_analysis_conv``;
- K2 :func:`dense_synthesis_conv` replaces
  ``pqmf_tpu/kernels/cached_conv.py:dense_synthesis_conv``;
- K3 :func:`fused_roundtrip_conv` replaces
  ``pqmf_tpu/kernels/cached_conv.py:fused_roundtrip_conv``.

All three compute VALID convolutions with f32 inputs and outputs, so
offline (centered), causal and streaming modes share them; each takes its
zero pad as an argument and applies it in-kernel. At the tiers K1t, K2t
and K3t read their banks arranged (:func:`arrange_tc_bank`), built once
where the weights are installed. What bounds each kernel on the H100 and what its
design does about it is written at the top of each CUDA source: K1-K3 are
f32 FMA on the CUDA cores, bound by arithmetic and shared-memory
bandwidth, with several outputs per thread in registers; K1t-K3t are
``mma.sync`` on the tensor cores over operands split to bf16 once as they
are staged in shared memory. The launch plans (grid, tile, shared memory) are mirrored here by
:func:`launch_plan`, so the CPU tests can reason about them.

A wrapper checks its call in Python, on static shapes, and then calls its
operator (``torch.ops.pqmf_tpu_torch.analysis_conv``, ``synthesis_conv``,
``roundtrip_conv``), so an eager call and a ``torch.export`` program run one
route. The operator's CPU impl is the kernel's plain PyTorch version
(``*_plain``, on ``ops.filterbank._conv1d`` at the same tier), taken only
for CPU tensors; its CUDA impl launches the kernel of its tier or raises;
no shape or tier falls back to the plain version or to another tier's
kernel there. Every launch adds one to :data:`LAUNCHES`, whatever the
tier; its fake impl gives the output's shape to a trace.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from pqmf_tpu_torch.ops import filterbank as fb

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "strided_analysis_conv",
    "dense_synthesis_conv",
    "fused_roundtrip_conv",
    "analysis_conv_plain",
    "synthesis_conv_plain",
    "roundtrip_conv_plain",
    "supports",
    "fused_roundtrip_supported",
    "TcBank",
    "arrange_tc_bank",
    "smem_bytes",
    "launch_plan",
    "max_clusters",
    "OPS",
]

# kernel launches since the last reset_launches(), by kernel
LAUNCHES = {"analysis": 0, "synthesis": 0, "roundtrip": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# gates and launch plans, mirroring pqmf_smem_bytes and pqmf_launch_plan in
# the CUDA source (the card check compares the two); pure functions of their
# integer arguments, cached: the wrappers ask the gates on every call
# ---------------------------------------------------------------------------

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
N_SMS = 132          # SMs of an H100 SXM; the C side asks the card
_THREADS = 256               # kThreads: K3
_WEIGHT_BYTES = 64 * 1024    # kWeightBytes
_NT = 8                      # kNT
_SYN_THREADS = 128           # kSynThreads
_SYN_MAX_STEPS = 256         # kSynMaxSteps
_SYN_FILL = 128              # kSynFill
_ANA_WINDOW = 4096           # kAnaWindow
_ANA_GROUPS = 2              # kAnaGroups
_SMEM_PER_SM = 233472        # kSmemPerSm
_SPLIT_MAX_BANDS = 16        # kSplitMaxBands
_RT_BANDS = (2, 4, 8, 16, 32, 64)  # K3's (and K3t's) compiled band counts
# K3 from M = 32 (roundtrip_cluster_kernel): a thread-block cluster of M/8
# blocks a tile, each with 8 bands of both banks
_RTC_MIN_BANDS = 32          # kRtcMinBands
_RTC_BLOCK_BANDS = 8         # kRtcBlockBands
_RTC_THREADS = 256           # kRtcThreads
_RTC_SUB = 256               # kRtcSub; its call-size choice is K3t's below
_RTC_NB, _RTC_NT = 2, 8      # kRtcNB, kRtcNT: whole files' thread tiles
_RTC_SMALL_NB, _RTC_SMALL_NT = 1, 4  # kRtcSmallNB, kRtcSmallNT: host blocks
_RTC_MAX_CLUSTER = 8         # kRtcMaxCluster: the portable cluster size
# the tensor-core tier kernels (csrc/cached_conv_tc.cu)
_PASSES = {"bf16x3": 3, "default": 1}  # mma passes a k-step
_TC_THREADS = 128            # kTcThreads: K1t/K2t
_TC_WARPS = _TC_THREADS // 32
_TC_BANK_BYTES = 144 * 1024  # kTcBankBytes
_TC_FILL_WARPS = 8           # kTcFillWarps
_TC_PERSIST_M16 = 16         # kTcPersistM16
_TC_SHAPES = ((2, 1), (1, 1), (1, 2), (1, 4))  # kTcShapes: (MT, WK)
_RT_TC_THREADS = 256         # kRtTcThreads: K3t
_RT_TC_WARPS = _RT_TC_THREADS // 32
_RT_TC_SUB = 256             # kRtTcSub
_RT_TC_CLUSTER_BANDS = 32    # kRtTcClusterBands: from M = 32 a cluster a tile
_RT_TC_BLOCK_NN = 2          # kRtTcBlockNN: n8 tiles a cluster's block ...
_RT_TC_MIN_PERSIST = 96      # kRtTcMinPersist: ... beside this whole-file tile
# K3t's and K3's (from M = 32) choice of tile by the call's size
# (csrc/rt_plan.h)
_RT_TC_PERSIST_M16 = 16      # kRtPersistM16
_RT_TC_FILL_DIV = 4          # kRtFillDiv
_RT_TC_SMALL = (16, 32, 64)  # kRtSmall: small calls' tiles


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round4(n: int) -> int:
    return (n + 3) & ~3


def _round8(n: int) -> int:
    return (n + 7) & ~7


def _round16(n: int) -> int:
    return (n + 15) & ~15


def _round64(n: int) -> int:
    return (n + 63) & ~63


def _tc_win(g: dict, R: int) -> dict:
    """The window of a K1t/K2t tile of R rows (``tc_win``): nT steps of S
    elements (WL, split into halves) and its raw copy (K2t: Mb rows of XR
    steps, band-major as the input)."""
    nT = R - 1 + _cdiv(g["Qp"], g["S"])
    XR = _round8(nT) + 4 if g["kind"] == 2 else 0
    WL = _round64(g["S"] * nT)  # whole groups of 8 swizzled chunks
    return {"nT": nT, "WL": WL, "XR": XR,
            "raw": g["S"] * XR if g["kind"] == 2 else WL}


def _tc_rest_bytes(g: dict, MT: int, WK: int) -> int:
    """Shared memory of a K1t/K2t plan besides the staged bank: the raw
    window, its split halves and the reduction slices' partial sums."""
    WM = _TC_WARPS // WK
    w = _tc_win(g, 16 * MT * WM)
    return 4 * w["raw"] + 4 * w["WL"] + 16 * (WK - 1) * WM * 32 * MT * g["NN"]


def _tc_geom(kind: int, S: int, Q: int, N: int) -> dict:
    """K1t (kind 1) / K2t (kind 2) for a conv of stride S whose reduction
    runs over Q terms into N output channels: the reduction padded to Qp
    (n_k k-steps), NN n8 tiles a channel block, n_cb blocks, the arranged
    bank of one block (both halves) and whether a block stages it."""
    Qp = _round16(Q)
    NN = 2 if N > 8 else 1
    g = {"kind": kind, "S": S, "Qp": Qp, "n_k": Qp // 16, "NN": NN,
         "n_cb": _cdiv(N, 8 * NN), "bank": 2 * (Qp // 16) * 32 * 4 * NN * 2}
    rest = max(_tc_rest_bytes(g, mt, wk) for mt, wk in _TC_SHAPES)
    g["stage"] = (g["bank"] <= _TC_BANK_BYTES
                  and g["bank"] + rest <= SMEM_LIMIT)
    g["gate"] = (g["bank"] if g["stage"] else 0) + rest
    return g


def _tc_plan(kind: int, B: int, S: int, Q: int, N: int, T_out: int,
             n_sms: int) -> tuple:
    g = _tc_geom(kind, S, Q, N)
    m16 = B * _cdiv(T_out, 16) * g["n_cb"]
    persist = m16 >= n_sms * _TC_PERSIST_M16
    MT, WK = (2, 1) if persist else (1, 1)
    while (not persist and WK < _TC_WARPS and 2 * WK <= g["n_k"]
           and m16 * WK < n_sms * _TC_FILL_WARPS):
        WK *= 2
    R = 16 * MT * (_TC_WARPS // WK)
    tiles = B * _cdiv(T_out, R)
    # staged where a block walks many tiles or the card holds every block
    stage = g["stage"] and (persist or tiles * g["n_cb"] <= n_sms)
    smem = (g["bank"] if stage else 0) + _tc_rest_bytes(g, MT, WK)
    per_sm = max(1, min(2048 // _TC_THREADS, _SMEM_PER_SM // (smem + 1024)))
    gx = min(tiles, max(1, n_sms * per_sm // g["n_cb"])) if persist \
        else tiles
    return (gx, g["n_cb"], 1, _TC_THREADS, R, WK, 8 * g["NN"], smem)


def _rt_tc_wk(items: int, n_k: int) -> int:
    """Warps a K3t phase's reduction of n_k k-steps is split over, for
    ``items`` m16 groups (``rt_tc_wk``)."""
    wk = 1
    while 2 * wk * items <= _RT_TC_WARPS and 2 * wk <= n_k:
        wk *= 2
    return wk


def _rt_tc_tile(g: dict, Tt: int, persist: bool) -> dict:
    """A K3t tile of Tt output steps (``rt_tc_tile``): n_sub sub-band steps
    (analysis rows), MT m16 tiles x the block's channels a warp item, each
    phase's reduction split WKa / WKs ways, the split window (WL elements,
    raw f32 and bf16 halves), the split sub-band tile (SL elements a half;
    0 where it takes the window's place: the analysis is one item a warp)
    and the bytes of all that and the slices' partial sums."""
    MT = 2 if persist else 1
    r = 16 * MT
    n_sub = _cdiv(Tt - 1 + g["rows_s"], r) * r
    WL = _round64(g["M"] * (n_sub - 1) + 16 * g["n_ka"])
    ga, gs = n_sub // r, Tt // r  # warp items: one channel block a block
    WKa, WKs = _rt_tc_wk(ga, g["n_ka"]), _rt_tc_wk(gs, g["n_ks"])
    SL = 0 if ga * WKa <= _RT_TC_WARPS else _round64(g["M"] * n_sub)
    red = max((WKa - 1) * ga, (WKs - 1) * gs) * 32 * MT * g["bNN"] * 4
    return {"Tt": Tt, "n_sub": n_sub, "MT": MT, "WKa": WKa, "WKs": WKs,
            "WL": WL, "SL": SL, "rest": 8 * WL + 4 * SL + 4 * red}


def _rt_tc_persist_Tt(g: dict) -> int:
    """The whole-file tile's output steps (``rt_tc_persist_steps``): 256
    sub-band steps (more where an output reads more), as many output steps
    of them as are whole m16 pairs; in a cluster the largest such tile that
    fits beside the block's bank slice."""
    n_sub = _cdiv(max(_RT_TC_SUB, 32 + g["rows_s"] - 1), 32) * 32
    Tt = (n_sub - g["rows_s"] + 1) // 32 * 32
    while (g["C"] > 1 and Tt > 32
           and g["bank"] + _rt_tc_tile(g, Tt, True)["rest"] > SMEM_LIMIT):
        Tt -= 32
    return Tt


def _rt_tc_gate(g: dict) -> int:
    rest = max(_rt_tc_tile(g, Tt, persist)["rest"] for Tt, persist in
               [(_rt_tc_persist_Tt(g), True)]
               + [(t, False) for t in _RT_TC_SMALL])
    return (g["bank"] if g["stage"] else 0) + rest


@functools.lru_cache(maxsize=64)
def _rt_tc_geom(M: int, Ka: int, Ks: int, precision: str = "bf16x3") -> dict:
    """K3t for M bands and banks of Ka / Ks taps at ``precision``
    (``rt_tc_geom``): both arranged banks' k-steps, channel blocks (2 and 4
    at M = 32, 64), the sub-band rows one output step reads, the blocks a
    cluster (C = 1 up to M = 16; from M = 32, M / (8 bNN) blocks of bNN n8
    tiles: a whole channel block where its slice of both banks fits beside
    a whole-file tile of 96 steps and every host-block tile, else half of
    one), the bytes of the banks one block stages (up to M = 16 both banks,
    both halves, where one channel block fits beside the largest tile of
    any plan, else each warp reads its fragments from L2; from M = 32 its
    channels of both, the hi half only at "default"), the whole-file
    tile's output steps (in a cluster the largest that fits beside the
    bank) and the shared-memory gate."""
    n_ka, n_ks = _round16(Ka) // 16, _round16(M * Ks) // 16
    NN = 2 if M > 8 else 1
    n_cb = _cdiv(M, 8 * NN)
    halves = 1 if M >= _RT_TC_CLUSTER_BANDS and precision == "default" \
        else 2
    g = {"M": M, "n_ka": n_ka, "n_ks": n_ks, "NN": NN, "n_cb": n_cb,
         "rows_s": _cdiv(16 * n_ks, M)}
    if M < _RT_TC_CLUSTER_BANDS:
        # staged where the banks fit beside the largest tile (the gate of
        # an unstaged bank is the tiles' bytes alone)
        g.update(C=1, bNN=NN,
                 bank=2 * (n_ka + n_ks) * n_cb * 32 * 4 * NN * 2,
                 stage=False)
        g["stage"] = n_cb == 1 and g["bank"] + _rt_tc_gate(g) <= SMEM_LIMIT
    else:
        bNN = _RT_TC_BLOCK_NN
        while True:
            g.update(C=M // (8 * bNN), bNN=bNN,
                     bank=2 * halves * (n_ka + n_ks) * 32 * 4 * bNN,
                     stage=True)
            if bNN == 1 or (_rt_tc_persist_Tt(g) >= _RT_TC_MIN_PERSIST
                            and _rt_tc_gate(g) <= SMEM_LIMIT):
                break
            bNN //= 2
    g["persist_Tt"] = _rt_tc_persist_Tt(g)
    g["gate"] = _rt_tc_gate(g)
    return g


def _rt_tile_choice(B: int, T_out: int, n_sms: int,
                    cluster: int = 1) -> tuple:
    """(whole file, small call's tile) of K3t and of K3 from M = 32
    (``rt_call_tile``, ``csrc/rt_plan.h``): a whole file from n_sms * 16 m16
    output tiles on; a smaller call one tile a cluster of ``cluster``
    blocks, of 64, 32 or 16 output steps, the largest that gives n_sms / 4
    blocks."""
    if B * _cdiv(T_out, 16) >= n_sms * _RT_TC_PERSIST_M16:
        return True, 0
    Tt = _RT_TC_SMALL[-1]
    while (Tt > _RT_TC_SMALL[0]
           and B * _cdiv(T_out, Tt) * cluster < n_sms // _RT_TC_FILL_DIV):
        Tt //= 2
    return False, Tt


def _rt_tc_plan(B: int, M: int, Ka: int, Ks: int, T_out: int, n_sms: int,
                precision: str = "bf16x3",
                max_clusters: int | None = None) -> tuple:
    g = _rt_tc_geom(M, Ka, Ks, precision)
    C = g["C"]
    persist, Tt = _rt_tile_choice(B, T_out, n_sms, C)
    if persist:
        Tt = g["persist_Tt"]
    t = _rt_tc_tile(g, Tt, persist)
    n_tiles = B * _cdiv(T_out, Tt)
    stage = g["stage"] and (persist or n_tiles <= n_sms or C > 1)
    smem = (g["bank"] if stage else 0) + t["rest"]
    if C > 1:
        if max_clusters is None:
            max_clusters = n_sms // C
        gx = (min(n_tiles, max(0, max_clusters)) if persist else n_tiles) * C
    else:
        per_sm = max(1, min(2048 // _RT_TC_THREADS,
                            _SMEM_PER_SM // (smem + 1024)))
        gx = min(n_tiles, n_sms * per_sm) if persist else n_tiles
    return (gx, 1, 1, _RT_TC_THREADS, Tt, t["n_sub"], C, smem)


def _analysis_band_groups(M: int, Mb: int, J: int) -> int:
    return max(1, min(_cdiv(Mb, 4), _ANA_GROUPS,
                      _WEIGHT_BYTES // (16 * M * J)))


def _analysis_max_steps(M: int) -> int:
    return max(_NT, min(_SYN_MAX_STEPS, _ANA_WINDOW // M))


def _analysis_plan_smem(M: int, J: int, CB: int, Tt: int, red: int) -> int:
    return 4 * (M * J * CB + M * _round4(Tt + J + 4) + red)


def _split_plan(B: int, M: int, n_groups: int, split_sum: int, T_out: int,
                max_steps: int, n_sms: int) -> tuple:
    """The choice K1 and K2 share: (NT, MS, SG) for a call of ``n_groups``
    groups of 4 output channels whose sum runs over ``split_sum`` input
    channels (K1's phases, K2's bands). MS == 1 leaves SG to the caller."""
    fill = n_sms * _SYN_FILL
    nt, ms = _NT, 1
    items = B * _cdiv(T_out, nt) * n_groups
    while (ms < 16 and 2 * ms <= split_sum
           and split_sum <= _SPLIT_MAX_BANDS and items * ms < fill):
        ms *= 2
    if items * ms < fill:
        nt = 4
    sg = 1
    if ms > 1:
        while (2 * sg * ms <= _SYN_THREADS and 2 * sg * nt <= max_steps
               and B * _cdiv(T_out, 2 * sg * nt) * n_groups >= n_sms):
            sg *= 2
    return nt, ms, sg


def _synthesis_phase_groups(M: int, Mb: int, K: int) -> int:
    return max(1, min(_cdiv(M, 4), 2, _WEIGHT_BYTES // (16 * Mb * K)))


def _synthesis_plan_smem(Mb: int, K: int, CG: int, Tt: int, red: int) -> int:
    return 4 * (Mb * K * CG + Mb * _round4(Tt + K + 4) + red)


def _rtc_tile(M: int, Ka: int, Ks: int, Tt: int) -> dict:
    """A tile of K3 at M >= 32 (``rtc_tile``; Tt = 0: a whole file's) for
    each of the C = M/8 blocks of its cluster: thread tiles of NB bands x NT
    steps (2 x 8 on whole files, 1 x 4 on host blocks), one per thread in
    each phase, in whole warps; Tt output steps of n_sub sub-band steps;
    the block's analysis bank [M][PS] (PS = 8 mod 32), its synthesis bank
    [M][Ks][8], its own sub-band rows [8][SP] and the window [M][XR], which
    the whole sub-band tile [M][SP] takes over after the analysis."""
    MB = _RTC_BLOCK_BANDS
    J = _cdiv(Ka, M)
    if Tt == 0:
        NB, NT, n_sub = _RTC_NB, _RTC_NT, _RTC_SUB
        Tt = max(0, (n_sub - Ks + 1) // NT * NT)
    else:
        NB, NT = _RTC_SMALL_NB, _RTC_SMALL_NT
        n_sub = _cdiv(Tt + Ks - 1, NT) * NT
    XR, SP = _round4(n_sub + J + 4), n_sub + 8
    PS = J * MB + ((MB - J * MB) & 31)
    return {"C": M // MB, "NB": NB, "NT": NT, "n_sub": n_sub, "Tt": Tt,
            "threads": -(-(MB // NB * (n_sub // NT)) // 32) * 32,  # warps
            "XR": XR, "SP": SP, "PS": PS,
            "smem": 4 * (M * PS + M * Ks * MB + MB * SP + M * XR)}


def _rtc_fits(M: int, Ka: int, Ks: int) -> bool:
    """Whether every tile a plan of K3 at M >= 32 can take launches
    (``rtc_fits``): whole clusters of at most 8 blocks (the portable size),
    whole-file tiles of output steps, at most 256 threads, and their shared
    memory within a block's."""
    if M % _RTC_BLOCK_BANDS or M // _RTC_BLOCK_BANDS > _RTC_MAX_CLUSTER:
        return False
    tiles = [_rtc_tile(M, Ka, Ks, Tt) for Tt in (0,) + _RT_TC_SMALL]
    return (tiles[0]["Tt"] > 0
            and all(t["threads"] <= _RTC_THREADS for t in tiles)
            and max(t["smem"] for t in tiles) <= SMEM_LIMIT)


def _rtc_plan(B: int, M: int, Ka: int, Ks: int, T_out: int, n_sms: int,
              max_clusters: int | None) -> tuple:
    """K3's plan at M >= 32 (``rtc_choice``, ``roundtrip_plan``): whole
    files as many persistent clusters as the card holds at once
    (``max_clusters``), smaller calls one tile a cluster
    (``_rt_tile_choice``, counting blocks); the cluster size in the
    seventh entry."""
    C = M // _RTC_BLOCK_BANDS
    persist, Tt = _rt_tile_choice(B, T_out, n_sms, C)
    t = _rtc_tile(M, Ka, Ks, Tt)
    n_tiles = B * _cdiv(T_out, t["Tt"]) if t["Tt"] > 0 else 0
    if max_clusters is None:
        max_clusters = n_sms // C
    gx = (min(n_tiles, max(0, max_clusters)) if persist else n_tiles) * C
    return (gx, 1, 1, t["threads"], t["Tt"], t["n_sub"], C, t["smem"])


def _roundtrip_geom(M: int, Ka: int, Ks: int) -> dict:
    """K3's tile up to M = 16: NB bands a thread tile, n_sub sub-band steps
    (one analysis thread tile per thread) of which Tt are output steps, J
    taps per phase of the analysis bank."""
    nb = M if M < 4 else 4
    bg = max(1, M // nb)
    n_sub = _THREADS * _NT // bg
    Tt = max(0, (n_sub - Ks + 1) // _NT * _NT)
    J = _cdiv(Ka, M)
    XR, SP = _round4(n_sub + J + 4), n_sub + 8
    return {"n_sub": n_sub, "Tt": Tt,
            "smem": 4 * (M * J * M + M * Ks * M + M * SP + 2 * M * XR)}


@functools.lru_cache(maxsize=256)
def smem_bytes(which: str, M: int, Mb: int, Ka: int, Ks: int,
               precision: str = "highest") -> int:
    """Shared memory one block of kernel ``which`` ("analysis",
    "synthesis", "roundtrip") at ``precision`` may use — for K2 the most of
    any of its launch plans; Ka/Ks are the analysis/synthesis kernel
    lengths (the other one is ignored)."""
    if fb.check_precision(precision) != "highest":
        if which == "analysis":
            return _tc_geom(1, M, Ka, Mb)["gate"]
        if which == "synthesis":
            return _tc_geom(2, Mb, Mb * Ks, M)["gate"]
        if which == "roundtrip":
            return _rt_tc_geom(M, Ka, Ks, precision)["gate"]
        raise ValueError(f"unknown kernel {which!r}")
    if which == "analysis":
        J = _cdiv(Ka, M)
        return _analysis_plan_smem(M, J, 4 * _analysis_band_groups(M, Mb, J),
                                   _analysis_max_steps(M),
                                   _SYN_THREADS * _NT * 4)
    if which == "synthesis":
        return _synthesis_plan_smem(
            Mb, Ks, 4 * _synthesis_phase_groups(M, Mb, Ks), _SYN_MAX_STEPS,
            _SYN_THREADS * _NT * 4)
    if which == "roundtrip":
        if M >= _RTC_MIN_BANDS:
            return max(_rtc_tile(M, Ka, Ks, Tt)["smem"]
                       for Tt in (0,) + _RT_TC_SMALL)
        return _roundtrip_geom(M, Ka, Ks)["smem"]
    raise ValueError(f"unknown kernel {which!r}")


@functools.lru_cache(maxsize=256)
def launch_plan(which: str, B: int, M: int, Mb: int, Ka: int, Ks: int,
                T_out: int, n_sms: int = N_SMS,
                precision: str = "highest",
                max_clusters: int | None = None) -> tuple:
    """The launch of kernel ``which`` at ``precision`` for a call of
    ``T_out`` output steps on a card of ``n_sms`` SMs, as the CUDA source
    plans it: (grid x, y, z, threads, output steps a tile, K1/K2's steps a
    thread tile / K3's sub-band steps a tile, K1's phase split / K2's band
    split / K3's blocks a cluster (1: no cluster), shared memory bytes). At
    the tiers the sixth entry is K1t/K2t's reduction split WK (K3t's
    sub-band steps a tile), the seventh their output channels a block
    (K3t: its blocks a cluster). ``max_clusters``: the whole-file clusters
    of K3/K3t at M >= 32 the card holds at once, as the card answers
    (:func:`max_clusters`); where none is given, n_sms // C.

    The tier kernels K1t/K2t run blocks of 4 warps over a channel block of
    16 (or 8) output channels. A call of fewer than 16 m16 tiles an SM
    (one host block) splits the reduction over WK = 1, 2 or 4 warps, until
    the card holds 8 warps an SM, and runs one tile of 16 * 4/WK output
    steps a block; a larger call (a whole file) runs as many persistent
    blocks as fit, each staging its arranged bank chunk once and walking
    tiles of 128 steps (4 warps x 2 m16 tiles). A small call of more
    blocks than SMs, and a bank chunk past 144 KB, read the bank from
    global memory (L2) instead of staging it. K3t runs blocks of 8 warps:
    a whole file (from 16 m16 output tiles an SM) as many persistent
    blocks as fit (2 an SM at M = 16), each staging both arranged banks
    once and walking tiles of 256 sub-band steps (224 output steps at
    M = 16, Ks = 33; more sub-band steps where an output reads more); a
    smaller call one tile a block, of 64, 32 or 16 output steps, the
    largest that gives n_sms / 4 blocks (32 blocks of 16 steps at
    [1,1,8704]), each phase's reduction split over the warps its tiles
    leave idle.

    K2 takes thread tiles of 4 phases x NT steps. It splits the band sum
    over up to 16 threads (for banks of at most 16 bands: a longer split
    sum rounds too far from the plain conv's order) until the card holds
    128 threads an SM, then halves NT, and grows its blocks (<= 128
    threads, <= 256 steps) while there are still as many blocks as SMs. A
    call that needs no split takes tiles of up to 8 phases and runs as
    many blocks as fit on the card at once, each walking its tiles. K1 is
    K2's plan with its M phases (J = ceil(K/M) taps each) for K2's input
    bands and its bands for K2's phases; its tiles hold at most 4096/M
    steps. Up to M = 16 K3 runs one persistent block an SM over tiles of
    n_sub sub-band steps. At M = 32 and 64 K3 and K3t run one thread-block
    cluster of C = M/8 blocks a tile, each block with 8 bands (channels)
    of both banks staged once a launch: K3 whole files as many persistent
    clusters as the card holds, tiles of 256 sub-band steps in thread
    tiles of 2 bands x 8 steps, host blocks one cluster a tile of 16-64
    output steps in thread tiles of 1 x 4 (the tile choice counts the
    cluster's blocks); K3t the same split over blocks of a whole channel
    block (16 channels, C = M/16) where that slice of both banks fits (all
    but M = 64 at bf16x3, which takes blocks of 8), 8 warps a block, the
    largest whole-file tile that fits beside the bank slices of the
    tier."""
    if fb.check_precision(precision) != "highest":
        if which == "analysis":
            return _tc_plan(1, B, M, Ka, Mb, T_out, n_sms)
        if which == "synthesis":
            return _tc_plan(2, B, Mb, Mb * Ks, M, T_out, n_sms)
        if which == "roundtrip":
            return _rt_tc_plan(B, M, Ka, Ks, T_out, n_sms, precision,
                               max_clusters)
        raise ValueError(f"unknown kernel {which!r}")
    if which == "analysis":
        J = _cdiv(Ka, M)
        n_bg = _cdiv(Mb, 4)
        max_steps = _analysis_max_steps(M)
        nt, ms, sg = _split_plan(B, M, n_bg, M, T_out, max_steps, n_sms)
        pg = 1
        if ms == 1:
            pg = _analysis_band_groups(M, Mb, J)
            sg = max(1, min(max_steps // nt, _SYN_THREADS // pg))
        threads = sg * pg * ms
        smem = _analysis_plan_smem(M, J, 4 * pg, nt * sg,
                                   threads * nt * 4 if ms > 1 else 0)
        tiles = B * _cdiv(T_out, nt * sg)
        gy = _cdiv(n_bg, pg)
        per_sm = max(1, min(2048 // threads, _SMEM_PER_SM // (smem + 1024)))
        gx = min(tiles, max(1, n_sms * per_sm // gy)) if ms == 1 else tiles
        return (gx, gy, 1, threads, nt * sg, nt, ms, smem)
    if which == "synthesis":
        n_pg = _cdiv(M, 4)
        nt, ms, sg = _split_plan(B, M, n_pg, Mb, T_out, _SYN_MAX_STEPS,
                                 n_sms)
        pg = 1
        if ms == 1:
            pg = _synthesis_phase_groups(M, Mb, Ks)
            sg = max(1, min(_SYN_MAX_STEPS // nt, _SYN_THREADS // pg))
        threads = sg * pg * ms
        smem = _synthesis_plan_smem(Mb, Ks, 4 * pg, nt * sg,
                                    threads * nt * 4 if ms > 1 else 0)
        tiles = B * _cdiv(T_out, nt * sg)
        per_sm = max(1, min(2048 // threads, _SMEM_PER_SM // (smem + 1024)))
        gx = min(tiles, n_sms * per_sm) if ms == 1 else tiles
        return (gx, _cdiv(n_pg, pg), 1, threads, nt * sg, nt, ms, smem)
    if which == "roundtrip":
        if M >= _RTC_MIN_BANDS:
            return _rtc_plan(B, M, Ka, Ks, T_out, n_sms, max_clusters)
        g = _roundtrip_geom(M, Ka, Ks)
        n_tiles = B * _cdiv(T_out, g["Tt"]) if g["Tt"] > 0 else 0
        return (min(n_tiles, n_sms), 1, 1, _THREADS, g["Tt"], g["n_sub"], 1,
                g["smem"])
    raise ValueError(f"unknown kernel {which!r}")


def max_clusters(M: int, Ka: int, Ks: int,
                 precision: str = "highest") -> int:
    """The thread-block clusters of K3's (K3t's at a tier) whole-file tile
    at M = 32 or 64 that the current card holds at once, as the card
    answers (``cudaOccupancyMaxActiveClusters``: a cluster lives inside
    one GPC, so this is not n_sms / C); what a whole-file launch takes and
    what :func:`launch_plan` needs to mirror it. Raises where the card
    refuses the question."""
    import ctypes

    from pqmf_tpu_torch.kernels import _build

    lib = _build.load()
    n = ctypes.c_int(0)
    if fb.check_precision(precision) == "highest":
        err = lib.pqmf_rt_max_clusters(M, Ka, Ks, ctypes.byref(n))
    else:
        err = lib.pqmf_tc_rt_max_clusters(M, Ka, Ks, _PASSES[precision],
                                          ctypes.byref(n))
    if err:
        raise RuntimeError(f"cluster occupancy of M={M}, Ka={Ka}, Ks={Ks} "
                           f"[{precision}]: "
                           f"{lib.pqmf_error_string(err).decode()} ({err})")
    return n.value


@functools.lru_cache(maxsize=256)
def supports(n_band: int, analysis_taps: int, synthesis_taps: int,
             precision: str = "highest") -> bool:
    """Whether K1 and K2 (K1t and K2t at a tier) take a full bank of this
    geometry: they stage a chunk of the bank (at least one band or phase)
    and their input window in one block's shared memory. Any band count
    whose banks fit is admitted; the TPU's 128-lane halo limit does not
    apply here. The tiers take every geometry ``"highest"`` takes (K1t and
    K2t read a bank too large for a block from global memory), so their
    gate is the f32 kernels' gate and the fit of their own."""
    M = n_band
    if not (M >= 1
            and smem_bytes("analysis", M, M, analysis_taps, 0) <= SMEM_LIMIT
            and smem_bytes("synthesis", M, M, 0, synthesis_taps)
            <= SMEM_LIMIT):
        return False
    return precision == "highest" or (
        smem_bytes("analysis", M, M, analysis_taps, 0, precision)
        <= SMEM_LIMIT
        and smem_bytes("synthesis", M, M, 0, synthesis_taps, precision)
        <= SMEM_LIMIT)


@functools.lru_cache(maxsize=256)
def fused_roundtrip_supported(M: int, analysis_taps: int,
                              synthesis_taps: int,
                              precision: str = "highest") -> bool:
    """Whether K3 (K3t at a tier) takes this geometry: a band count it is
    compiled for (2, 4, 8, 16, 32, 64) whose tile fits in one block's
    shared memory — up to M = 16 both banks, the double-buffered input
    window and the sub-band tile; at M = 32 and 64, in a cluster of M/8
    blocks, one block's 8 bands of both banks, the window and the
    sub-band tile. True for every committed bank,
    designed or fine-tuned. A tier takes the same geometries, where its own
    tile fits, so a round trip routes alike at every tier. The JAX gate
    also refuses M = 2 and 4 at the streaming and offline synthesis pads:
    there a 128-lane group (128 / M steps) does not divide the left pad, a
    TPU layout constraint that K3 does not have."""
    if M not in _RT_BANDS:
        return False
    if M >= _RTC_MIN_BANDS:
        fits = _rtc_fits(M, analysis_taps, synthesis_taps)
    else:
        fits = (_roundtrip_geom(M, analysis_taps, synthesis_taps)["Tt"] > 0
                and smem_bytes("roundtrip", M, M, analysis_taps,
                               synthesis_taps) <= SMEM_LIMIT)
    if not fits:
        return False
    return precision == "highest" or smem_bytes(
        "roundtrip", M, M, analysis_taps, synthesis_taps,
        precision) <= SMEM_LIMIT


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def analysis_conv_plain(x, w, M: int, fuse_mask: bool = True,
                        pad=(0, 0), precision: str = "highest"):
    """Plain K1 (K1t at a tier): ``reverse_half(conv1d(pad(x, pad), w,
    stride=M))`` at ``precision`` -> [B, Mb, T_out]."""
    y = fb._conv1d(x, w, stride=M, padding=tuple(int(p) for p in pad),
                   precision=precision)
    return fb.reverse_half(y) if fuse_mask else y


def synthesis_conv_plain(x, w, fuse_mask: bool = True, x_offset: int = 0,
                         precision: str = "highest", pad=(0, 0)):
    """Plain K2 (K2t at a tier): sign mask on the input (parity from
    ``x_offset``, the position of x[..., 0] in the unpadded signal), zero
    pad ``pad`` = (left, right), conv at ``precision``, ``*M``, band flip,
    time-major [B, T_out, M]."""
    M = w.shape[0]
    if fuse_mask:
        x = fb.reverse_half(x, offset=x_offset)
    y = fb._conv1d(x, w, padding=tuple(int(p) for p in pad),
                   precision=precision) * M
    return torch.flip(y, dims=(1,)).transpose(1, 2).contiguous()


def roundtrip_conv_plain(x, w_ana, w_syn, M: int, syn_pad,
                         precision: str = "highest", pad=(0, 0)):
    """Plain K3 (K3t at a tier): plain K1 with the analysis pad ``pad``,
    zero pad ``syn_pad``, plain K2 — with both sign masks, the synthesis
    mask's parity taken from the sub-band signal. At a tier the f32
    sub-bands are split again for the synthesis, as JAX's fused kernel
    splits its f32 ring."""
    sub = analysis_conv_plain(x, w_ana, M, fuse_mask=True, pad=pad,
                              precision=precision)
    sub = torch.nn.functional.pad(sub, tuple(syn_pad))
    return synthesis_conv_plain(sub, w_syn, fuse_mask=True,
                                x_offset=-syn_pad[0], precision=precision)


# ---------------------------------------------------------------------------
# the tier kernels' bank, arranged once when the weights are installed
# ---------------------------------------------------------------------------


class TcBank(NamedTuple):
    """A bank as K1t/K2t read it (:func:`arrange_tc_bank`): ``words`` bf16
    [halves, n_cb, n_k, 32, 4*NN] and what it was built for."""

    words: torch.Tensor
    kind: str
    precision: str
    w_shape: tuple


@functools.lru_cache(maxsize=64)
def _tc_fragment_index(Qp: int, Np: int, NN: int):
    """(q, c) of every element of the arranged bank: lane (g, tq) of k-step
    ks in channel block cb holds, for n8 tile nn and the mma's fragments
    j = b0, b1, the pair B[16ks + 2tq + 8j + e, cb*8NN + 8nn + g], e = 0, 1
    (the lower k in the lower half of the 32-bit word)."""
    n_cb, n_k = Np // (8 * NN), Qp // 16
    cb, ks, lane, nn, j, e = np.ix_(np.arange(n_cb), np.arange(n_k),
                                    np.arange(32), np.arange(NN),
                                    np.arange(2), np.arange(2))
    q = 16 * ks + 2 * (lane % 4) + 8 * j + e
    c = cb * 8 * NN + 8 * nn + lane // 4
    full, shape = (n_cb, n_k, 32, NN, 2, 2), (n_cb, n_k, 32, 4 * NN)
    return (np.broadcast_to(q, full).reshape(shape).copy(),
            np.broadcast_to(c, full).reshape(shape).copy())


def _tc_b_matrix(w: torch.Tensor, kind: str) -> torch.Tensor:
    """The B operand of K1t / K2t's GEMM, f32 [Q, N]: ``"analysis"`` (w
    [Mb, 1, K]) B[q, c] = w[c, 0, q]; ``"synthesis"`` (w [M, Mb, K])
    B[k*Mb + m, c] = w[M-1-c, m, k], the band flip and the time-major
    window's column order."""
    if kind == "analysis":
        return w[:, 0, :].t()
    if kind == "synthesis":
        M, Mb, K = w.shape
        return w.flip(0).permute(2, 1, 0).reshape(K * Mb, M)
    raise ValueError(f"unknown kernel {kind!r}")


def arrange_tc_bank(w: torch.Tensor, kind: str, precision: str) -> TcBank:
    """The bank of K1t (``kind="analysis"``) or K2t (``"synthesis"``) at a
    tier, as the kernel reads it: B (:func:`_tc_b_matrix`) zero-padded to
    [Qp, n_cb*8*NN], split into bf16 hi (and lo at ``"bf16x3"``) to nearest
    even (``ops.filterbank.split_bf16``, JAX's ``_split_bf16``), each laid
    out in the order of the mma's B fragments (:func:`_tc_fragment_index`),
    so a lane loads a k-step's fragments as one 16-byte word. On the bank's
    device; a few small launches. Built when weights are installed
    (``StreamingPQMF``, ``PQMF``) and passed to the wrappers as ``bank=``."""
    if fb.check_precision(precision) == "highest":
        raise ValueError("the arranged bank is for the tiers 'bf16x3' and "
                         "'default'")
    Bm = _tc_b_matrix(w, kind)
    Q, N = Bm.shape
    NN = 2 if N > 8 else 1
    Qp, Np = _round16(Q), _cdiv(N, 8 * NN) * 8 * NN
    Bp = torch.zeros((Qp, Np), dtype=torch.float32, device=w.device)
    Bp[:Q, :N] = Bm
    hi, lo = fb.split_bf16(Bp)
    qi, ci = (torch.as_tensor(a, device=w.device)
              for a in _tc_fragment_index(Qp, Np, NN))
    halves = (hi, lo) if precision == "bf16x3" else (hi,)
    words = torch.stack([h[qi, ci] for h in halves]).to(torch.bfloat16)
    return TcBank(words.contiguous(), kind, precision, tuple(w.shape))


def _tc_words_shape(w_shape, kind: str, precision: str) -> tuple:
    """The shape of ``arrange_tc_bank(w, kind, precision).words`` for a
    bank ``w`` of ``w_shape``."""
    K = w_shape[-1]
    Q = K if kind == "analysis" else K * w_shape[1]
    N = w_shape[0]
    NN = 2 if N > 8 else 1
    return (2 if precision == "bf16x3" else 1, _cdiv(N, 8 * NN),
            _round16(Q) // 16, 32, 4 * NN)


def _tc_bank(bank, w, kind: str, precision: str) -> TcBank:
    """``bank`` checked against the call, or the call's bank arranged now."""
    if bank is None:
        return arrange_tc_bank(w, kind, precision)
    if (bank.kind, bank.precision, bank.w_shape) != (kind, precision,
                                                     tuple(w.shape)):
        raise ValueError(
            f"the arranged bank is for {bank.kind} at {bank.precision} of "
            f"{bank.w_shape}; this call is {kind} at {precision} of "
            f"{tuple(w.shape)}")
    if bank.words.device != w.device or not bank.words.is_contiguous():
        raise ValueError(f"the arranged bank is on {bank.words.device}, "
                         f"expected {w.device}, contiguous")
    return bank


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check(name, t, ndim, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_operands(x, weights, banks, precision) -> None:
    """The operands as a kernel reads them, checked by the operator itself:
    an exported program calls it without the public function's checks, and
    the CUDA impl takes raw pointers. ``weights`` and ``banks`` are
    ``(name, tensor)`` and ``(name, words, w, kind)`` tuples. Every tensor
    is contiguous on x's device, x and the weights f32 with 3 dims; at a
    tier a bank given is the bf16 arrangement of its weights, and a launch
    on the card needs one."""
    if precision != "highest" and precision not in _PASSES:
        raise ValueError(f"unknown precision {precision!r}")
    dev = x.device
    for name, t in (("x", x),) + tuple(weights):
        if t.dtype != torch.float32 or t.ndim != 3:
            raise ValueError(f"{name} must be float32 with 3 dims, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}, got "
                             f"{'' if t.is_contiguous() else 'strided, '}"
                             f"{t.device}")
    for name, words, w, kind in banks:
        if precision == "highest" or (words is None and dev.type != "cuda"):
            continue
        want = _tc_words_shape(tuple(w.shape), kind, precision)
        if (words is None or words.dtype != torch.bfloat16
                or tuple(words.shape) != want or words.device != dev
                or not words.is_contiguous()):
            raise ValueError(
                f"{name} must be the contiguous bf16 {want} arrangement of "
                f"its bank on {dev}, got " + (
                    "none" if words is None else
                    f"{words.dtype} {tuple(words.shape)} on {words.device}"))


def _launch(fn, *args):
    """Call a C entry on the current stream of the inputs' card and raise
    on a non-zero cudaError_t."""
    from pqmf_tpu_torch.kernels import _build

    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, fn)(*args, stream)
    if err:
        raise RuntimeError(
            f"{fn} failed: {lib.pqmf_error_string(err).decode()} ({err})")


# ---------------------------------------------------------------------------
# the kernels as operators of the ``pqmf_tpu_torch`` namespace: the CUDA
# impl launches the kernel of the call's tier, the CPU impl runs the plain
# version and the fake impl gives the output's shape, so ``torch.export``
# traces the wrappers and a reloaded program launches the same kernels.
# No autograd is registered: training differentiates the plain ops
# (``ops.filterbank``), never these.
# ---------------------------------------------------------------------------

_LIB = torch.library.Library("pqmf_tpu_torch", "DEF")
_LIB.define("analysis_conv(Tensor x, Tensor w, Tensor? bank, int M, "
            "bool fuse_mask, int pad_l, int pad_r, str mxu_precision) "
            "-> Tensor")
_LIB.define("synthesis_conv(Tensor x, Tensor w, Tensor? bank, "
            "bool fuse_mask, int x_offset, int pad_l, int pad_r, "
            "str mxu_precision) -> Tensor")
_LIB.define("roundtrip_conv(Tensor x, Tensor w_ana, Tensor w_syn, "
            "Tensor? bank_ana, Tensor? bank_syn, int M, int pad_l, "
            "int pad_r, int syn_pad_l, int syn_pad_r, str mxu_precision) "
            "-> Tensor")
OPS = torch.ops.pqmf_tpu_torch


def _analysis_shape(x, w, M, pad_l, pad_r):
    return (x.shape[0], w.shape[0], (pad_l + x.shape[-1] + pad_r
                                     - w.shape[-1]) // M + 1)


def _synthesis_shape(x, w, pad_l, pad_r):
    return (x.shape[0], pad_l + x.shape[-1] + pad_r - w.shape[-1] + 1,
            w.shape[0])


def _roundtrip_shape(x, w_ana, w_syn, M, pad_l, pad_r, syn_pad_l,
                     syn_pad_r):
    T_ana = (pad_l + x.shape[-1] + pad_r - w_ana.shape[-1]) // M + 1
    return (x.shape[0], syn_pad_l + T_ana + syn_pad_r - w_syn.shape[-1] + 1,
            M)


def _analysis_operands(x, w, bank, mxu_precision):
    _check_operands(x, (("w", w),), (("bank", bank, w, "analysis"),),
                    mxu_precision)
    if x.shape[1] != 1 or w.shape[1] != 1:
        raise ValueError(f"analysis is mono: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")


def _synthesis_operands(x, w, bank, mxu_precision):
    _check_operands(x, (("w", w),), (("bank", bank, w, "synthesis"),),
                    mxu_precision)
    if x.shape[1] != w.shape[1]:
        raise ValueError(f"band dims disagree: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")


def _roundtrip_operands(x, w_ana, w_syn, bank_ana, bank_syn, M,
                        mxu_precision):
    _check_operands(x, (("w_ana", w_ana), ("w_syn", w_syn)),
                    (("bank_ana", bank_ana, w_ana, "analysis"),
                     ("bank_syn", bank_syn, w_syn, "synthesis")),
                    mxu_precision)
    if (x.shape[1] != 1 or tuple(w_ana.shape[:2]) != (M, 1)
            or tuple(w_syn.shape[:2]) != (M, M)):
        raise ValueError("the round trip is mono and full-bank: x "
                         f"{tuple(x.shape)}, w_ana {tuple(w_ana.shape)}, "
                         f"w_syn {tuple(w_syn.shape)}, M={M}")


def _analysis_cuda(x, w, bank, M, fuse_mask, pad_l, pad_r, mxu_precision):
    _analysis_operands(x, w, bank, mxu_precision)
    B, _, T = x.shape
    Mb, _, K = w.shape
    out = torch.empty(_analysis_shape(x, w, M, pad_l, pad_r),
                      dtype=torch.float32, device=x.device)
    args = (out.data_ptr(), B, T, M, Mb, K, out.shape[-1], pad_l,
            int(fuse_mask))
    with torch.cuda.device(x.device):
        if mxu_precision == "highest":
            _launch("pqmf_analysis_conv", x.data_ptr(), w.data_ptr(), *args)
        else:
            _launch("pqmf_tc_analysis_conv", x.data_ptr(), bank.data_ptr(),
                    *args, _PASSES[mxu_precision])
    LAUNCHES["analysis"] += 1
    return out


def _synthesis_cuda(x, w, bank, fuse_mask, x_offset, pad_l, pad_r,
                    mxu_precision):
    _synthesis_operands(x, w, bank, mxu_precision)
    B, Mb, T = x.shape
    M, _, K = w.shape
    out = torch.empty(_synthesis_shape(x, w, pad_l, pad_r),
                      dtype=torch.float32, device=x.device)
    args = (out.data_ptr(), B, Mb, T, M, K, out.shape[1], pad_l,
            int(fuse_mask), int(x_offset))
    with torch.cuda.device(x.device):
        if mxu_precision == "highest":
            _launch("pqmf_synthesis_conv", x.data_ptr(), w.data_ptr(), *args)
        else:
            _launch("pqmf_tc_synthesis_conv", x.data_ptr(), bank.data_ptr(),
                    *args, _PASSES[mxu_precision])
    LAUNCHES["synthesis"] += 1
    return out


def _roundtrip_cuda(x, w_ana, w_syn, bank_ana, bank_syn, M, pad_l, pad_r,
                    syn_pad_l, syn_pad_r, mxu_precision):
    _roundtrip_operands(x, w_ana, w_syn, bank_ana, bank_syn, M, mxu_precision)
    B, _, T = x.shape
    Ka, Ks = w_ana.shape[-1], w_syn.shape[-1]
    T_ana = (pad_l + T + pad_r - Ka) // M + 1
    out = torch.empty(_roundtrip_shape(x, w_ana, w_syn, M, pad_l, pad_r,
                                       syn_pad_l, syn_pad_r),
                      dtype=torch.float32, device=x.device)
    args = (out.data_ptr(), B, T, M, Ka, Ks, T_ana, out.shape[1], pad_l,
            syn_pad_l)
    with torch.cuda.device(x.device):
        if mxu_precision == "highest":
            _launch("pqmf_roundtrip_conv", x.data_ptr(), w_ana.data_ptr(),
                    w_syn.data_ptr(), *args)
        else:
            _launch("pqmf_tc_roundtrip_conv", x.data_ptr(),
                    bank_ana.data_ptr(), bank_syn.data_ptr(), *args,
                    _PASSES[mxu_precision])
    LAUNCHES["roundtrip"] += 1
    return out


def _analysis_cpu(x, w, bank, M, fuse_mask, pad_l, pad_r, mxu_precision):
    _analysis_operands(x, w, bank, mxu_precision)
    return analysis_conv_plain(x, w, M, fuse_mask, (pad_l, pad_r),
                               mxu_precision)


def _synthesis_cpu(x, w, bank, fuse_mask, x_offset, pad_l, pad_r,
                   mxu_precision):
    _synthesis_operands(x, w, bank, mxu_precision)
    return synthesis_conv_plain(x, w, fuse_mask, x_offset, mxu_precision,
                                (pad_l, pad_r))


def _roundtrip_cpu(x, w_ana, w_syn, bank_ana, bank_syn, M, pad_l, pad_r,
                   syn_pad_l, syn_pad_r, mxu_precision):
    _roundtrip_operands(x, w_ana, w_syn, bank_ana, bank_syn, M, mxu_precision)
    return roundtrip_conv_plain(x, w_ana, w_syn, M, (syn_pad_l, syn_pad_r),
                                mxu_precision, (pad_l, pad_r))


for _name, _cuda, _cpu in [("analysis_conv", _analysis_cuda, _analysis_cpu),
                           ("synthesis_conv", _synthesis_cuda,
                            _synthesis_cpu),
                           ("roundtrip_conv", _roundtrip_cuda,
                            _roundtrip_cpu)]:
    _LIB.impl(_name, _cuda, "CUDA")
    _LIB.impl(_name, _cpu, "CPU")


@torch.library.register_fake("pqmf_tpu_torch::analysis_conv", lib=_LIB)
def _analysis_fake(x, w, bank, M, fuse_mask, pad_l, pad_r, mxu_precision):
    return x.new_empty(_analysis_shape(x, w, M, pad_l, pad_r))


@torch.library.register_fake("pqmf_tpu_torch::synthesis_conv", lib=_LIB)
def _synthesis_fake(x, w, bank, fuse_mask, x_offset, pad_l, pad_r,
                    mxu_precision):
    return x.new_empty(_synthesis_shape(x, w, pad_l, pad_r))


@torch.library.register_fake("pqmf_tpu_torch::roundtrip_conv", lib=_LIB)
def _roundtrip_fake(x, w_ana, w_syn, bank_ana, bank_syn, M, pad_l, pad_r,
                    syn_pad_l, syn_pad_r, mxu_precision):
    return x.new_empty(_roundtrip_shape(x, w_ana, w_syn, M, pad_l, pad_r,
                                        syn_pad_l, syn_pad_r))


def strided_analysis_conv(x, w, M: int, fuse_mask: bool = True,
                          pad=(0, 0), mxu_precision: str = "highest",
                          bank: TcBank | None = None):
    """K1 — valid stride-M conv of a mono signal zero-padded by ``pad`` =
    (left, right) samples, plus the fused ``reverse_half`` on the output.
    The kernel applies the pad while it copies its input window, so the
    padded signal is never written.

    x: [B, 1, T]; w: [Mb, 1, K]. Returns [B, Mb, T_out] with
    ``T_out = (left + T + right - K) // M + 1``. ``mxu_precision`` "highest"
    launches K1, "bf16x3" / "default" K1t, which reads ``bank`` =
    ``arrange_tc_bank(w, "analysis", mxu_precision)`` where the caller keeps
    one (else it is arranged for the call). Every check runs here, on
    static shapes; the call itself is the operator
    ``pqmf_tpu_torch::analysis_conv``."""
    fb.check_precision(mxu_precision)
    dev = x.device if isinstance(x, torch.Tensor) else None
    _check("x", x, 3, dev)
    _check("w", w, 3, dev)
    B, C, T = x.shape
    Mb, Cw, K = w.shape
    if C != 1 or Cw != 1:
        raise ValueError(f"analysis is mono: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if fuse_mask and Mb % 2:
        raise ValueError("band shards must be even-sized (sign-mask parity)")
    pad_l, pad_r = (int(p) for p in pad)
    if pad_l < 0 or pad_r < 0:
        raise ValueError(f"pad must be non-negative, got {pad}")
    T_out = (pad_l + T + pad_r - K) // M + 1
    if B < 1 or T_out < 1:
        raise ValueError(f"empty analysis output: B={B}, T={T}, pad={pad}, "
                         f"K={K}")
    if dev.type == "cuda":
        if (smem_bytes("analysis", M, Mb, K, 0) > SMEM_LIMIT
                or smem_bytes("analysis", M, Mb, K, 0, mxu_precision)
                > SMEM_LIMIT):
            raise ValueError(f"analysis kernel length {K} exceeds the "
                             "kernel's shared memory; gate with supports()")
        if mxu_precision != "highest":
            bank = _tc_bank(bank, w, "analysis", mxu_precision)
    else:  # the plain version reads no arranged bank
        bank = None
    return OPS.analysis_conv.default(
        x, w, None if bank is None else bank.words, M, bool(fuse_mask),
        pad_l, pad_r, mxu_precision)


def dense_synthesis_conv(x, w, fuse_mask: bool = True, x_offset: int = 0,
                         mxu_precision: str = "highest", pad=(0, 0),
                         bank: TcBank | None = None):
    """K2 — valid stride-1 M->M conv of sub-bands zero-padded by ``pad`` =
    (left, right) steps, with the synthesis post-amble fused: optional
    ``reverse_half`` on the input (``x_offset`` = index of x[..., 0] in the
    unpadded signal), ``*M`` gain, band flip, and time-major output so the
    phase interleave is a free reshape. The kernel applies the pad while it
    copies its input window, so the padded sub-bands are never written.

    x: [B, Mb, T]; w: [M, Mb, K]. Returns [B, T_out, M] with
    ``T_out = left + T + right - K + 1``. ``mxu_precision`` "highest" launches
    K2, "bf16x3" / "default" K2t, which reads ``bank`` =
    ``arrange_tc_bank(w, "synthesis", mxu_precision)`` where the caller keeps
    one (else it is arranged for the call). Every check runs here; the
    call itself is the operator ``pqmf_tpu_torch::synthesis_conv``."""
    fb.check_precision(mxu_precision)
    dev = x.device if isinstance(x, torch.Tensor) else None
    _check("x", x, 3, dev)
    _check("w", w, 3, dev)
    B, Mb, T = x.shape
    M, Mw, K = w.shape
    if Mw != Mb:
        raise ValueError(f"band dims disagree: x has {Mb}, bank has {Mw}")
    if fuse_mask and Mb % 2:
        raise ValueError("band shards must be even-sized (sign-mask parity)")
    pad_l, pad_r = (int(p) for p in pad)
    if pad_l < 0 or pad_r < 0:
        raise ValueError(f"pad must be non-negative, got {pad}")
    T_out = pad_l + T + pad_r - K + 1
    if B < 1 or T_out < 1:
        raise ValueError(f"empty synthesis output: B={B}, T={T}, pad={pad}, "
                         f"K={K}")
    if dev.type == "cuda":
        if (smem_bytes("synthesis", M, Mb, 0, K) > SMEM_LIMIT
                or smem_bytes("synthesis", M, Mb, 0, K, mxu_precision)
                > SMEM_LIMIT):
            raise ValueError(f"synthesis bank [{M}, {Mb}, {K}] exceeds the "
                             "kernel's shared memory; gate with supports()")
        if mxu_precision != "highest":
            bank = _tc_bank(bank, w, "synthesis", mxu_precision)
    else:  # the plain version reads no arranged bank
        bank = None
    return OPS.synthesis_conv.default(
        x, w, None if bank is None else bank.words, bool(fuse_mask),
        int(x_offset), pad_l, pad_r, mxu_precision)


def fused_roundtrip_conv(x, w_ana, w_syn, M: int, syn_pad,
                         mxu_precision: str = "highest", pad=(0, 0),
                         banks=None):
    """K3 — zero pad ``pad`` -> analysis -> zero pad ``syn_pad`` ->
    synthesis in one kernel; the sub-band intermediate stays in shared
    memory and the two ``reverse_half`` masks cancel, so neither is
    applied. The kernel applies both pads while it copies its windows, so
    no padded signal is written.

    x: [B, 1, T]; w_ana: [M, 1, Ka]; w_syn: [M, M, Ks]; pad = (left,
    right) of the analysis input and syn_pad of the sub-bands, both >= 0.
    Returns [B, T_out, M] with ``T_ana = (left + T + right - Ka) // M + 1``
    and ``T_out = syn_left + T_ana + syn_right - Ks + 1``, equal to
    :func:`roundtrip_conv_plain`. ``mxu_precision`` "highest" launches K3,
    "bf16x3" / "default" K3t, which reads ``banks`` =
    ``(arrange_tc_bank(w_ana, "analysis", tier), arrange_tc_bank(w_syn,
    "synthesis", tier))`` where the caller keeps them (else they are
    arranged for the call). Every check runs here; the call itself is the
    operator ``pqmf_tpu_torch::roundtrip_conv``."""
    fb.check_precision(mxu_precision)
    dev = x.device if isinstance(x, torch.Tensor) else None
    _check("x", x, 3, dev)
    _check("w_ana", w_ana, 3, dev)
    _check("w_syn", w_syn, 3, dev)
    B, C, T = x.shape
    Ka, Ks = w_ana.shape[-1], w_syn.shape[-1]
    if (C != 1 or tuple(w_ana.shape[:2]) != (M, 1)
            or tuple(w_syn.shape[:2]) != (M, M)):
        raise ValueError("fused round trip is mono and full-bank only: x "
                         f"{tuple(x.shape)}, w_ana {tuple(w_ana.shape)}, "
                         f"w_syn {tuple(w_syn.shape)}, M={M}")
    pad_l, pad_r = (int(p) for p in syn_pad)
    pa_l, pa_r = (int(p) for p in pad)
    if min(pad_l, pad_r, pa_l, pa_r) < 0:
        raise ValueError(f"pads must be non-negative, got pad={pad}, "
                         f"syn_pad={syn_pad}")
    T_ana = (pa_l + T + pa_r - Ka) // M + 1
    T_out = pad_l + T_ana + pad_r - Ks + 1
    if B < 1 or T_ana < 1 or T_out < 1:
        raise ValueError(f"empty round trip: B={B}, T={T}, pad={pad}")
    if banks is not None:  # a kept pair is checked on every device
        if mxu_precision == "highest":
            raise ValueError("arranged banks are for the tiers 'bf16x3' "
                             "and 'default'")
        ba, bs = banks
        banks = (_tc_bank(ba, w_ana, "analysis", mxu_precision),
                 _tc_bank(bs, w_syn, "synthesis", mxu_precision))
    if dev.type == "cuda":
        if not fused_roundtrip_supported(M, Ka, Ks, mxu_precision):
            raise ValueError(f"fused round trip of M={M}, Ka={Ka}, Ks={Ks} "
                             "exceeds the kernel's shared memory; gate with "
                             "fused_roundtrip_supported()")
        if mxu_precision != "highest" and banks is None:
            banks = (arrange_tc_bank(w_ana, "analysis", mxu_precision),
                     arrange_tc_bank(w_syn, "synthesis", mxu_precision))
    words = (None, None) if banks is None else (banks[0].words,
                                                banks[1].words)
    return OPS.roundtrip_conv.default(x, w_ana, w_syn, *words, M, pa_l, pa_r,
                                      pad_l, pad_r, mxu_precision)
