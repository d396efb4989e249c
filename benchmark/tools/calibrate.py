"""Readings for the limits of a cell's check, in one process.

For each of ``--seeds`` seeds the cell's program (built once) runs as a
run does, at the cell's own size and load: a fresh state, a fresh pool
from the seed, the warm-up, a window of ``--seconds``, the same sample of
answers; every kept answer is checked against the reference. The first
``--control`` seeds' answers are then checked with the control in the
program's place: the reference computed at TF32. Prints one JSON line a
seed and a summary: for each number of the check, the program's worst
reading over the seeds (the lower reading of its limit) and the control's
best (the upper).

    python3 benchmark/tools/calibrate.py --workload pvoc16.streams \
        --seeds 12 --control 3 --seconds 2
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import harness  # noqa: E402


def quantiles(values):
    v = sorted(values)
    return {q: harness.percentile(v, q) for q in (50, 90, 99, 100)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, default=3_000_000_019)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--traffic", default="{}",
                    help="JSON of traffic keys to override (a CPU rehearsal)")
    args = ap.parse_args(argv)

    spec = harness.load_cell(args.workload)
    config, system = spec["config"], spec["system"]
    traffic = {**spec["traffic"], **json.loads(args.traffic)}
    device = harness.device_of(args.device)
    prog = system.build(config, traffic, device)
    program, control = [], []
    for i in range(args.seeds):
        seed = args.first + 7919 * i
        t0 = time.perf_counter()
        prog.reset()
        pool = harness.make_pool(prog, config, traffic, seed, device)
        g = harness.warm_up(prog, pool, traffic, device)
        lat, _, kept = harness.measure(prog, pool, g, args.seconds, traffic,
                                       seed, device)
        check, failed, answers = harness.judge(system, config, pool, kept,
                                               device)
        line = {"seed": seed, "calls": len(lat), "answers": len(answers),
                "failed": failed, "check": check,
                "quantiles": quantiles([a["rel_err"] for a in answers])}
        program.append({n: c["value"] for n, c in check.items()})
        if i < args.control:
            c, cf, _ = harness.judge(system, config, pool, kept, device,
                                     tf32=True)
            line["control"] = {"check": c, "failed": cf}
            control.append({n: v["value"] for n, v in c.items()})
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    names = list(program[0])
    print(json.dumps({
        "workload": args.workload,
        "program_worst": {n: max(p[n] for p in program) for n in names},
        "control_best": {n: min(c[n] for c in control) for n in names}
        if control else None,
        "program_readings": program, "control_readings": control}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
