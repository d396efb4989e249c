"""Run one cell of ``BENCHMARK.json`` once on this machine's card and print
one JSON line.

    python3 benchmark/run.py --workload pvoc16.streams --seed 7 \
        --seconds 10 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled slice after the window (the Chrome trace
under ``benchmark/traces/<cell>/``). Every run checks the window's answers
against the plain reference and prints each compared number beside its
limit, last on standard error and last in the JSON line (``check``). It
exits non-zero, printing no result, without as many CUDA devices as the
cell asks for, or when JAX or the JAX package was loaded.

Caches stay inside the checkout: the port's kernel build in
``pqmf_tpu_torch/_build/`` (keyed by the sources' digest), CUDA's JIT cache
in ``benchmark/.cache/``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
os.environ.setdefault("CUDA_CACHE_PATH", str(REPO / "benchmark" / ".cache"
                                             / "nv"))
sys.path.insert(0, str(REPO))


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card in use."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    chips = harness.load_cell(args.workload)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), "cuda", t_start=T_START)
    found = sorted(set(result.pop("forbidden_modules"))
                   | set(harness.forbidden_modules()))
    if found:
        print("run.py: JAX or the JAX package was loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    card = card_line()
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(),
                        "count": chips, **result["device"]}
    check = result.pop("check")
    result["card"] = card
    result["check"] = check
    print(f"card: {card}", file=sys.stderr)
    for name, c in check.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
