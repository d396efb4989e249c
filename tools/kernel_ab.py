#!/usr/bin/env python3
"""A/B of edited copies of the PyTorch port's CUDA sources, on one card.

    python3 tools/kernel_ab.py [--rounds 2] [--variants as_is,tc_]
                               [--shapes K1t,K2t]

Run from the root of a checkout on a machine with an NVIDIA card and
``nvcc``. Each variant is the sources of ``pqmf_tpu_torch/csrc``
(``cached_conv.cu``, the f32 kernels; ``cached_conv_tc.cu``, the tiers;
``middle.cu``, the pitch shifter's middle) and the header ``rt_plan.h``
with a few text edits (``VARIANTS``: the
sources as they are, and each design choice of K1/K2/K3 or of K1t/K2t
undone); every edit must match its file exactly once. All variants are built at once, each into its own
library loaded with ctypes; each is checked against the plain versions,
then the device time of its kernels (``torch.profiler``) is taken in turns
at K1 [1,1,8704], K1 [16,1,8704], K1 at K4's 60 s shape [1,1,2646000]
with its in-kernel pad (256, 240), K2 [1,16,544], K2 [16,16,544], K2 at
K5's 60 s shape [1,16,165375] with its in-kernel pad (15, 16), K3 at 60 s
[1,1,2646512], K1t/K2t at the same K1/K2 shapes at "bf16x3" and
"default" (reading their arranged banks), and K3t at [1,1,8704],
[16,1,8704] and 60 s [1,1,2646512] at both tiers (reading both arranged
banks), and K3/K3t at M = 32 and 64 (the designed banks) at host blocks of
B = 1 and 16 and on 60 s at each tier. ``--variants`` and ``--shapes``
take comma-separated prefixes to run a subset. Prints the card's name and
power limit, then one line per variant and shape: microseconds per call,
one per round.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

_TAPS = "#pragma unroll 8\n  for (; q + 4 <= nq; q += 4) {"
_GROUPS = "min_i(min_i(cdiv(M, 4), 2), kWeightBytes"
_K1_SPLIT = "split_choice(B, n_bg, M, T_out"
_K1_NT = ("const int NT = c.NT, MS = c.MS;\n  int SG = c.SG, PG = 1;\n"
          "  if (MS == 1) {\n    PG = analysis_band_groups")
_K1_GX = ("p.gx = MS == 1 ? min_i(tiles, max_i(1, n_sms * per_sm / p.gy))"
          " : tiles;")
_K1_G4 = ("kAnaGroups = 2;", "kAnaGroups = 4;")
_K1_G1 = ("kAnaGroups = 2;", "kAnaGroups = 1;")
_K1_W8K = ("kAnaWindow = 4096;", "kAnaWindow = 8192;")

_TC_LD = "const int LD = S % 8 == 0 ? 0 : S % 2 == 0 ? 1 : 2;"

# name -> [(file of csrc/, text in that file, its replacement)]: the
# sources and headers of kernels/_build.py, by file name
_F32, _TC, _RT_PLAN = "cached_conv.cu", "cached_conv_tc.cu", "rt_plan.h"
VARIANTS = {
    "as_is": [],
    "tap_loop_unroll_4": [(_F32, _TAPS,
                           _TAPS.replace("unroll 8", "unroll 4"))],
    "tap_loop_unroll_2": [(_F32, _TAPS,
                           _TAPS.replace("unroll 8", "unroll 2"))],
    "k2_phase_groups_4": [(_F32, _GROUPS,
                           _GROUPS.replace("4), 2)", "4), 4)"))],
    "k2_phase_groups_1": [(_F32, _GROUPS,
                           _GROUPS.replace("4), 2)", "4), 1)"))],
    "k2_fill_256": [(_F32, "kSynFill = 128;", "kSynFill = 256;")],
    "k2_max_steps_512": [(_F32, "kSynMaxSteps = 256;", "kSynMaxSteps = 512;")],
    "k1_no_split": [(_F32, _K1_SPLIT, _K1_SPLIT.replace(" M,", " 1,"))],
    "k1_split_max_4": [(_F32, _K1_SPLIT,
                        _K1_SPLIT.replace(" M,", " min_i(M, 8),"))],
    "k1_nt_4": [(_F32, _K1_NT, _K1_NT.replace("NT = c.NT", "NT = 4"))],
    "k1_one_tile_a_block": [(_F32, _K1_GX, "p.gx = tiles;")],
    "k1_balanced_grid": [(_F32, _K1_GX, "p.gx = MS == 1 ? cdiv(tiles, cdiv("
                          "tiles, max_i(1, n_sms * per_sm / p.gy))) : "
                          "tiles;")],
    "k1_divide": [(_F32, "fuse_mask, log2_exact(M));", "fuse_mask, -1);")],
    "k1_window_8192": [(_F32, *_K1_W8K)],
    "k1_copy_whole_window": [(_F32, "e < M * (Tt + J - 1); e += blockDim.x",
                              "e < M * XR; e += blockDim.x")],
    "k1_groups_4": [(_F32, *_K1_G4)],
    "k1_groups_1": [(_F32, *_K1_G1)],
    # K1t/K2t: each design choice undone
    "tc_no_swizzle": [(_TC, "a.swz = LD == 0 && log2_exact(S) >= 3 ? "
                          "min_i(S / 8, 8) - 1 : 0;", "a.swz = 0;")],
    "tc_stage_always": [(_TC, "p.stage = g.stage && (c.persist || (long long)"
                            "tiles * p.gy <= n_sms);", "p.stage = g.stage;")],
    "tc_no_ldmatrix": [(_TC, _TC_LD,
                        "const int LD = S % 2 == 0 ? 1 : 2;")],
    "tc_bank_global": [(_TC, "g.stage = g.bank_bytes <= kTcBankBytes &&",
                        "g.stage = false && g.bank_bytes <= kTcBankBytes "
                        "&&")],
    "tc_fill_16": [(_TC, "kTcFillWarps = 8;", "kTcFillWarps = 16;")],
    "tc_no_split_k": [(_TC, "while (wk < kTcWarps && 2 * wk <= g.n_k",
                       "while (false && 2 * wk <= g.n_k")],
    "tc_persist_m16_64": [(_TC, "kTcPersistM16 = 16;",
                           "kTcPersistM16 = 64;")],
    # K3t: each design choice undone or moved
    "rt_no_swizzle": [(_TC, "a.swz = LD == 0 ? min_i(M / 8, 8) - 1 : 0;",
                       "a.swz = 0;")],
    "rt_stage_never": [(_TC, "g.stage = g.n_cb == 1 && g.bank_bytes",
                        "g.stage = false && g.bank_bytes")],
    "rt_stage_always": [(_TC, "p.stage = g.stage && (persist || n_tiles <= "
                            "n_sms || g.C > 1);", "p.stage = g.stage;")],
    "rt_fill_div_8": [(_RT_PLAN, "kRtFillDiv = 4;", "kRtFillDiv = 8;")],
    "rt_fill_div_1": [(_RT_PLAN, "kRtFillDiv = 4;", "kRtFillDiv = 1;")],
    "rt_sub_512": [(_TC, "kRtTcSub = 256;", "kRtTcSub = 512;")],
    "rt_sub_128": [(_TC, "kRtTcSub = 256;", "kRtTcSub = 128;")],
    "rt_no_split_k": [(_TC, "while (2 * wk * items <= kRtTcWarps",
                       "while (false && 2 * wk * items <= kRtTcWarps")],
    # K3 at M = 32/64 (the cluster kernel): its thread tiles moved
    "rtc_whole_4x8": [(_F32, "constexpr int kRtcNB = 2;",
                       "constexpr int kRtcNB = 4;")],
    "rtc_whole_2x4": [(_F32, "constexpr int kRtcNT = 8;",
                       "constexpr int kRtcNT = 4;")],
    "rtc_small_2x4": [(_F32, "constexpr int kRtcSmallNB = 1;",
                       "constexpr int kRtcSmallNB = 2;")],
    # K3t at M = 32/64: every block of the cluster one n8 tile
    "rt_block_nn_1": [(_TC, "constexpr int kRtTcBlockNN = 2;",
                       "constexpr int kRtTcBlockNN = 1;")],
}


def _build_all(out: Path, names) -> dict:
    from pqmf_tpu_torch.kernels import _build

    srcs = {src.name: src.read_text()
            for src in _build.SOURCES + _build.HEADERS}
    nvcc = _build._find_nvcc()
    procs = {}
    for name in names:
        texts = dict(srcs)
        for which, old, new in VARIANTS[name]:
            if texts[which].count(old) != 1:
                raise SystemExit(f"{name}: {old!r} is not once in {which}")
            texts[which] = texts[which].replace(old, new)
        (out / name).mkdir(exist_ok=True)
        for file, text in texts.items():
            (out / name / file).write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o",
             str(out / f"{name}.so"),
             *(str(out / name / s.name) for s in _build.SOURCES)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and " 0 bytes spill stores" not in ln]
        print(f"{name}: built, spills {spills or 'none'}")
        libs[name] = _build._bind(ctypes.CDLL(str(out / f"{name}.so")))
    return libs


def _pick(names, prefixes):
    if not prefixes:
        return list(names)
    want = prefixes.split(",")
    return [n for n in names if any(n.startswith(w) for w in want)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--variants", default="",
                   help="comma-separated prefixes of variant names")
    p.add_argument("--shapes", default="",
                   help="comma-separated prefixes of shapes, e.g. K1,K2 [1")
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from pqmf_tpu_torch import StreamingPQMF
    from pqmf_tpu_torch.kernels import cached_conv as cc
    from pqmf_tpu_torch.kernels import polyphase as pk
    from pqmf_tpu_torch.ops import filterbank as fb

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    names = _pick(VARIANTS, args.variants)
    with tempfile.TemporaryDirectory(prefix="kernel_ab_") as tmp:
        libs = _build_all(Path(tmp), names)
        dev = torch.device("cuda")
        pq = StreamingPQMF(100, 16, device="cpu")
        wa, ws = pq.hkf.to(dev), pq.hki.to(dev)
        w2 = pk.analysis_weights(torch.tensor(
            fb.build_filterbank(100, 16)["hk_poly"])).to(dev)
        Ka, Ks = wa.shape[-1], ws.shape[-1]
        g = torch.Generator().manual_seed(0)
        hi = torch.tensor(fb.build_filterbank(100, 16)["hk_ipoly"]).to(dev)
        T60 = 60 * 44100
        # the round trip's banks by M (the designed ones)
        rt = {16: (wa, ws)}
        for M in (32, 64):
            sp = StreamingPQMF(100, M, device="cpu")
            rt[M] = (sp.hkf.to(dev), sp.hki.to(dev))
        # shape -> (input shape, bank, pad, tier); the round trip's M
        shapes, rt_m = {}, {}
        for tier in ("highest", "bf16x3", "default"):
            k1, k2 = ("K1", "K2") if tier == "highest" else ("K1t", "K2t")
            sfx = "" if tier == "highest" else f" {tier}"
            shapes.update({
                f"{k1} [1,1,8704]{sfx}": ((1, 1, 8704), wa, (0, 0), tier),
                f"{k1} [16,1,8704]{sfx}": ((16, 1, 8704), wa, (0, 0), tier),
                f"{k1} [1,1,2646000]{sfx}": ((1, 1, T60), w2, (256, 240),
                                             tier),
                f"{k2} [1,16,544]{sfx}": ((1, 16, 544), ws, (0, 0), tier),
                f"{k2} [16,16,544]{sfx}": ((16, 16, 544), ws, (0, 0), tier),
                f"{k2} [1,16,165375]{sfx}": ((1, 16, T60 // 16), hi,
                                             (15, 16), tier)})
        shapes["K3 [1,1,2646512]"] = ((1, 1, T60 + Ka - 1), None, None,
                                      "highest")
        for tier in ("bf16x3", "default"):
            for B, T in [(1, 8704), (16, 8704), (1, T60 + Ka - 1)]:
                shapes[f"K3t [{B},1,{T}] {tier}"] = ((B, 1, T), None, None,
                                                    tier)
        # K3/K3t at M = 32 and 64: host blocks of B = 1 and 16, 60 s
        for M in (32, 64):
            ka = rt[M][0].shape[-1]
            for tier in ("highest", "bf16x3", "default"):
                k3 = "K3" if tier == "highest" else "K3t"
                sfx = "" if tier == "highest" else f" {tier}"
                for B, T in [(1, 8192 + ka - 1), (16, 8192 + ka - 1),
                             (1, T60 + ka - 1)]:
                    key = f"{k3} M={M} [{B},1,{T}]{sfx}"
                    shapes[key] = ((B, 1, T), None, None, tier)
                    rt_m[key] = M
        shapes = {k: shapes[k] for k in _pick(shapes, args.shapes)}
        xs = {k: torch.randn(*v[0], generator=g).to(dev)
              for k, v in shapes.items()}
        banks = {}
        rt_banks = {(M, t): (cc.arrange_tc_bank(rt[M][0], "analysis",
                                                t).words,
                             cc.arrange_tc_bank(rt[M][1], "synthesis",
                                                t).words)
                    for M in rt for t in ("bf16x3", "default")}
        for k, (_, w, _, tier) in shapes.items():
            if tier != "highest" and not k.startswith("K3"):
                kind = "analysis" if k.startswith("K1") else "synthesis"
                banks[k] = cc.arrange_tc_bank(w, kind, tier).words
        passes = {"bf16x3": 3, "default": 1}
        stream = torch.cuda.current_stream().cuda_stream

        def call(lib, what, x):
            B, C, T = x.shape
            _, w, pad, tier = shapes[what]
            if what.startswith("K1"):
                K = w.shape[-1]
                t_out = (pad[0] + T + pad[1] - K) // 16 + 1
                out = torch.empty(B, 16, t_out, device=dev)
                tail = (out.data_ptr(), B, T, 16, 16, K, t_out, pad[0], 1)
                if tier == "highest":
                    err = lib.pqmf_analysis_conv(x.data_ptr(), w.data_ptr(),
                                                 *tail, stream)
                else:
                    err = lib.pqmf_tc_analysis_conv(
                        x.data_ptr(), banks[what].data_ptr(), *tail,
                        passes[tier], stream)
            elif what.startswith("K2"):
                K = w.shape[-1]
                t_out = pad[0] + T + pad[1] - K + 1
                out = torch.empty(B, t_out, 16, device=dev)
                tail = (out.data_ptr(), B, 16, T, 16, K, t_out, pad[0], 1,
                        -16 if pad == (0, 0) else 0)
                if tier == "highest":
                    err = lib.pqmf_synthesis_conv(x.data_ptr(), w.data_ptr(),
                                                  *tail, stream)
                else:
                    err = lib.pqmf_tc_synthesis_conv(
                        x.data_ptr(), banks[what].data_ptr(), *tail,
                        passes[tier], stream)
            else:  # syn_pad (16, 16): T_out = T_ana
                M = rt_m.get(what, 16)
                r_a, r_s = rt[M]
                ka, ks = r_a.shape[-1], r_s.shape[-1]
                t_ana = (T - ka) // M + 1
                out = torch.empty(B, t_ana, M, device=dev)
                tail = (out.data_ptr(), B, T, M, ka, ks, t_ana, t_ana, 0,
                        ks // 2)
                if tier == "highest":
                    err = lib.pqmf_roundtrip_conv(
                        x.data_ptr(), r_a.data_ptr(), r_s.data_ptr(), *tail,
                        stream)
                else:
                    err = lib.pqmf_tc_roundtrip_conv(
                        x.data_ptr(), rt_banks[M, tier][0].data_ptr(),
                        rt_banks[M, tier][1].data_ptr(), *tail, passes[tier],
                        stream)
            if err:
                raise SystemExit(f"launch failed: {err}")
            return out

        for what, x in xs.items():
            tol = dict(atol=2e-5, rtol=1e-4)
            _, w, pad, tier = shapes[what]
            if what.startswith("K1"):
                ref = cc.analysis_conv_plain(x, w, 16, True, pad, tier)
            elif what.startswith("K2"):
                ref = cc.synthesis_conv_plain(
                    x, w, True, -16 if pad == (0, 0) else 0, tier, pad)
            elif tier == "highest":
                M = rt_m.get(what, 16)
                ref = cc.roundtrip_conv_plain(x, *rt[M], M, (16, 16))
                if M == 16:  # M >= 32: K1's and K2's order, their bar
                    tol = dict(atol=1e-5, rtol=0.0)
            else:  # K3t; at "default" within one flip of a split mid
                M = rt_m.get(what, 16)
                r_a, r_s = rt[M]
                ref = cc.roundtrip_conv_plain(x, r_a, r_s, M, (16, 16), tier)
                sub = cc.strided_analysis_conv(x, r_a, M)
                flip = 2.0 ** (torch.floor(torch.log2(sub.abs().max()))
                               .item() - 7) * r_s.abs().sum(dim=(1, 2)) \
                    .max().item() * M
                tol = dict(atol=2e-5 + (flip if tier == "default" else 0.0),
                           rtol=1e-4)
            for name, lib in libs.items():
                got = call(lib, what, x)
                torch.testing.assert_close(got, ref, **tol,
                                           msg=lambda m: f"{name} {what}")
                print(f"  {name:20s} {what:28s} max|err| "
                      f"{(got - ref).abs().max().item():.3g}")
        def device_us(fn, n):
            """Device time per call of ``fn``; a trace that lost its device
            events is taken again."""
            for _ in range(3):
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(n):
                        fn()
                    torch.cuda.synchronize()
                total = sum(getattr(e, "self_device_time_total", 0.0)
                            for e in prof.key_averages()
                            if "_kernel" in e.key)
                if total > 0:
                    return total / n
            raise SystemExit("the profiler recorded no device time")

        us = {}
        for r in range(args.rounds):
            for name in (names if r % 2 == 0 else names[::-1]):
                for what, x in xs.items():
                    n = 10 if x.numel() > 10 ** 6 else 50
                    us.setdefault((name, what), []).append(
                        device_us(lambda: call(libs[name], what, x), n))
        print(f"device us per call on {card} (torch.profiler), by round:")
        for name in names:
            for what in xs:
                vals = ", ".join(f"{v:.2f}" for v in us[(name, what)])
                print(f"  {name:20s} {what:28s} {vals}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
