#!/usr/bin/env python3
"""A/B of edited copies of the PyTorch port's CUDA source, on one card.

    python3 tools/kernel_ab.py [--rounds 2]

Run from the root of a checkout on a machine with an NVIDIA card and
``nvcc``. Each variant is ``pqmf_tpu_torch/csrc/cached_conv.cu`` with a
few text edits (``VARIANTS``: the source as it is, and each design choice
of its K2/K3 undone). All variants are built at once, each into its own
library loaded with ctypes; each is checked against the plain versions,
then the device time of its kernels (``torch.profiler``) is taken in turns
at K2 [1,16,544], K2 [16,16,544], K2 at K5's 60 s shape [1,16,165407] and
K3 at 60 s [1,1,2646512]. Prints the card's name and power limit, then
one line per variant and shape: microseconds per call, one per round.
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

# name -> [(text in the source, its replacement)]
VARIANTS = {
    "as_is": [],
    "tap_loop_unroll_4": [(_TAPS, _TAPS.replace("unroll 8", "unroll 4"))],
    "tap_loop_unroll_2": [(_TAPS, _TAPS.replace("unroll 8", "unroll 2"))],
    "k2_phase_groups_4": [(_GROUPS, _GROUPS.replace("4), 2)", "4), 4)"))],
    "k2_phase_groups_1": [(_GROUPS, _GROUPS.replace("4), 2)", "4), 1)"))],
    "k2_fill_256": [("kSynFill = 128;", "kSynFill = 256;")],
    "k2_max_steps_512": [("kSynMaxSteps = 256;", "kSynMaxSteps = 512;")],
}


def _build_all(out: Path) -> dict:
    from pqmf_tpu_torch.kernels import _build

    src = _build.SOURCE.read_text()
    nvcc = _build._find_nvcc()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
             str(out / f"{name}.cu")],
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from pqmf_tpu_torch import StreamingPQMF
    from pqmf_tpu_torch.kernels import cached_conv as cc

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    with tempfile.TemporaryDirectory(prefix="kernel_ab_") as tmp:
        libs = _build_all(Path(tmp))
        dev = torch.device("cuda")
        pq = StreamingPQMF(100, 16, device="cpu")
        wa, ws = pq.hkf.to(dev), pq.hki.to(dev)
        Ka, Ks = wa.shape[-1], ws.shape[-1]
        g = torch.Generator().manual_seed(0)
        shapes = {"K2 [1,16,544]": (1, 16, 544),
                  "K2 [16,16,544]": (16, 16, 544),
                  "K2 [1,16,165407]": (1, 16, 165407),
                  "K3 [1,1,2646512]": (1, 1, 60 * 44100 + Ka - 1)}
        xs = {k: torch.randn(*v, generator=g).to(dev)
              for k, v in shapes.items()}
        stream = torch.cuda.current_stream().cuda_stream

        def call(lib, what, x):
            B, _, Tpad = x.shape
            if what.startswith("K2"):
                out = torch.empty(B, Tpad - Ks + 1, 16, device=dev)
                err = lib.pqmf_synthesis_conv(
                    x.data_ptr(), ws.data_ptr(), out.data_ptr(), B, 16,
                    Tpad, 16, Ks, Tpad - Ks + 1, 1, -16, stream)
            else:
                t_ana = (Tpad - Ka) // 16 + 1
                out = torch.empty(B, t_ana, 16, device=dev)
                err = lib.pqmf_roundtrip_conv(
                    x.data_ptr(), wa.data_ptr(), ws.data_ptr(),
                    out.data_ptr(), B, Tpad, 16, Ka, Ks, t_ana, t_ana,
                    Ks // 2, stream)
            if err:
                raise SystemExit(f"launch failed: {err}")
            return out

        for what, x in xs.items():
            if what.startswith("K2"):
                ref = cc.synthesis_conv_plain(x, ws, True, -16)
                tol = dict(atol=2e-5, rtol=1e-4)
            else:
                ref = cc.roundtrip_conv_plain(x, wa, ws, 16, (16, 16))
                tol = dict(atol=1e-5, rtol=0.0)
            for name, lib in libs.items():
                torch.testing.assert_close(call(lib, what, x), ref, **tol,
                                           msg=lambda m: f"{name} {what}")
        us = {}
        names = list(libs)
        for r in range(args.rounds):
            for name in (names if r % 2 == 0 else names[::-1]):
                for what, x in xs.items():
                    n = 10 if x.numel() > 10 ** 6 else 50
                    for _ in range(3):
                        call(libs[name], what, x)
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        for _ in range(n):
                            call(libs[name], what, x)
                        torch.cuda.synchronize()
                    total = sum(
                        getattr(e, "self_device_time_total", 0.0)
                        for e in prof.key_averages()
                        if "_kernel" in e.key)
                    us.setdefault((name, what), []).append(total / n)
        print(f"device us per call on {card} (torch.profiler), by round:")
        for name in names:
            for what in xs:
                vals = ", ".join(f"{v:.2f}" for v in us[(name, what)])
                print(f"  {name:20s} {what:18s} {vals}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
