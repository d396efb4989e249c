"""One run of one cell: load, warm up, measure, trace, check, report.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``; its configuration in the file the manifest names;
its traffic in ``traffic/<traffic>.json``; the traffic's loop in
``traffic/<loop>.py`` (the traffic's ``loop``, ``closed`` by default); the
program for the traffic's ``mode`` in ``systems/<system>.<mode>.py``
(``system`` from the configuration); each metric's reader in
``end_to_end/<metric>.py`` or ``metrics/<metric>.py``, or, where a cell's
metric has no file of its own, the reader of its family (the name up to
its first dot). Adding a cell, a mix, a loop, a mode or a metric adds
files and entries and edits none of this.

A run (``run``):

1. set-up: import the port, build the cell's program (``system.build``),
   make the input pool from the seed (``audio.rows``), and call the
   program ``warmup`` times, so every graph is captured and every kernel
   built before the clock starts; ``setup_s`` ends here;
2. the window: the traffic's loop (``traffic/closed.py``: calls back to
   back) drives the program for ``seconds``, each call on the next pool
   item, its latency on the host clock; a sample of the calls' answers,
   drawn from the seed (``Reservoir``), and the last call's are kept;
3. with ``trace``: a profiled slice of ``trace_calls`` more calls
   (``tracing.profile``), read by the cell's per-layer metrics;
4. the program is dropped, and the plain reference recomputes every kept
   answer (``system.check``); each number is held to its limit in the
   configuration's ``check``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import random
import statistics
import sys
import time
from pathlib import Path

import torch

from benchmark import audio, tracing

ROOT = Path(__file__).resolve().parent           # benchmark/
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pqmf_tpu")

__all__ = ["load_cell", "reader", "measure", "run", "forbidden_modules",
           "percentile", "Reservoir"]


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path):
    """The module in ``path`` (names may hold dots, as metric names do)."""
    name = "benchmark._cell_" + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(folder: str, name: str):
    """The reader of metric ``name`` in ``folder``: ``<name>.py``, or its
    family's ``<name up to the first dot>.py`` where it has none."""
    path = ROOT / folder / f"{name}.py"
    if not path.is_file():
        path = ROOT / folder / f"{name.split('.')[0]}.py"
    return _module(path)


def manifest() -> dict:
    return _load_json(REPO / "BENCHMARK.json")


def load_cell(name: str) -> dict:
    """The cell ``name``: its manifest entry, configuration, traffic, the
    adapter of its system, and its metrics (end-to-end and per-layer)."""
    bench = manifest()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = _load_json(REPO / cfg_entry["file"])
    traffic = _load_json(ROOT / "traffic" / f"{cell['traffic']}.json")
    mode = f"{config['system']}.{traffic['mode']}"

    def mine(metric):
        return "workloads" not in metric or name in metric["workloads"]

    return {
        "cell": cell, "config": config, "traffic": traffic,
        "system": _module(ROOT / "systems" / f"{mode}.py"),
        "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
        "per_layer": [m for m in bench["per_layer"] if mine(m)],
    }


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of all ``values``, linear between
    order statistics (NumPy's default)."""
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length,
    drawn from ``seed`` (Algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k, self.items, self.seen = k, [], 0
        self.rng = random.Random(seed)

    def offer(self, item):
        if self.seen < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1
        self.last = item

    def answers(self) -> list:
        """The sample and the last item offered, in call order."""
        items = self.items + [self.last] if self.seen else []
        return sorted({id(o): o for o in items}.values(), key=lambda o: o[0])


class Window:
    """What the end-to-end readers see of the window: the calls, their
    latencies (s), the window's and the set-up's seconds, and the audio a
    call (rows x block samples at sample_rate)."""

    def __init__(self, **fields):
        self.__dict__.update(fields)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_of(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def block_size(config: dict, traffic: dict) -> int:
    """Samples a row a call: the traffic's ``block``, where
    ``"m_buffer_size"`` (the default) is the configuration's buffer."""
    block = traffic.get("block", "m_buffer_size")
    return int(config["m_buffer_size"] if block == "m_buffer_size" else block)


def make_pool(prog, config: dict, traffic: dict, seed: int, device) -> list:
    return audio.pool(prog.rows, prog.block, int(traffic["pool"]), seed,
                      int(config["sample_rate"]), device,
                      traffic["placement"], traffic.get("audio"))


def warm_up(prog, pool: list, traffic: dict, device) -> int:
    """The warm-up: a fixed number of calls (the first captures the graphs
    and builds the kernels; the rest bring the card's clocks and the host's
    caches to their steady state), then the objects made so far are frozen
    out of the garbage collector's passes. Returns the number of calls made
    since the program's state was made."""
    n = int(traffic["warmup"])
    for g in range(n):
        prog.call(pool[g % len(pool)])
    _sync(device)
    gc.collect()
    gc.freeze()
    return n


def measure(prog, pool: list, g: int, seconds: float, traffic: dict,
            seed: int, device) -> tuple:
    """The window: the traffic's loop (``traffic/<loop>.py``'s ``measure``)
    drives the program from call ``g`` on for ``seconds``. Returns
    (latencies [s], window seconds, kept answers: a sample of
    ``traffic["sample"]`` (call index, outputs) drawn from ``seed``, and
    the last, in call order)."""
    loop = traffic.get("loop", "closed")
    loop = _module(ROOT / "traffic" / f"{loop}.py")
    kept = Reservoir(int(traffic["sample"]), seed)
    latencies, t0 = loop.measure(prog, pool, g, seconds, traffic, kept)
    _sync(device)
    window_s = time.perf_counter() - t0
    return latencies, window_s, kept.answers()


def judge(system, config: dict, pool: list, kept: list, device,
          tf32: bool = False) -> tuple:
    """(check, failed, answers). Every kept answer's numbers come from
    ``system.check``; each number of the configuration's ``check`` is a
    percentile of one of them over the answers (100: the worst), held to
    its limit. ``failed``: the answers past a limit, in a run that is not
    correct (0 in one that is)."""
    numbers = config["check"]["numbers"]
    answers = system.check(config, pool, kept, device, tf32=tf32)
    check = {name: {"value": percentile([a[n["of"]] for a in answers],
                                        n["percentile"]),
                    "limit": n["limit"]}
             for name, n in numbers.items()}
    ok = bool(answers) and all(c["value"] <= c["limit"]
                               for c in check.values())
    failed = 0 if ok else sum(
        any(not a[n["of"]] <= n["limit"] for n in numbers.values())
        for a in answers)
    return check, failed, answers


def run(workload: str, seed: int, seconds: float, trace: bool,
        device="cuda", t_start: float | None = None,
        traffic_update=None) -> dict:
    """One run of ``workload``; returns the result's fields (the JSON line
    without ``device``'s card fields, which ``run.py`` adds)."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_cell(workload)
    config, traffic = spec["config"], dict(spec["traffic"])
    traffic.update(traffic_update or {})
    system = spec["system"]
    device = device_of(device)

    # -- set-up ---------------------------------------------------------
    marks = [("start", time.perf_counter())]
    prog = system.build(config, traffic, device)
    marks.append(("build", time.perf_counter()))
    pool = make_pool(prog, config, traffic, seed, device)
    marks.append(("pool", time.perf_counter()))
    g = warm_up(prog, pool, traffic, device)
    marks.append(("warmup", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    phases = {"imports": marks[0][1] - t_start, **{
        name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])}}

    # -- the window -----------------------------------------------------
    latencies, window_s, kept = measure(prog, pool, g, seconds, traffic,
                                        seed, device)
    calls = len(latencies)
    mem_peak = (torch.cuda.max_memory_reserved(device)
                if device.type == "cuda" else 0)

    window = Window(calls=calls, latencies=latencies, window_s=window_s,
                    setup_s=setup_s, rows=prog.rows, block=prog.block,
                    sample_rate=float(config["sample_rate"]))
    metrics = {}
    traced = None
    if trace:
        traced = tracing.profile(prog, pool, g + calls,
                                 int(traffic["trace_calls"]), device,
                                 ROOT / "traces" / workload)
        traced.context = {"config": config, "traffic": traffic,
                          "rows": prog.rows, "block": prog.block,
                          "window": window}
        for m in spec["per_layer"]:
            value = reader("metrics", m["name"]).read(traced)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            value = reader("end_to_end", m["name"]).read(window)
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # -- the check, after the program is gone ----------------------------
    rows = prog.rows
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    found = forbidden_modules()
    check, failed, answers = judge(system, config, pool, kept, device)
    result = {
        "correct": bool(answers) and all(c["value"] <= c["limit"]
                                         for c in check.values()),
        "attempted": calls * rows,
        "failed": failed,
        "metrics": metrics,
        "device": {"memory_peak_bytes": int(mem_peak)},
        "forbidden_modules": found,
        "setup_phases_s": phases,
        "window": {"calls": calls, "seconds": window_s,
                   "latency_ms_median_halves": [
                       statistics.median(h) * 1e3 for h in (
                           latencies[:calls // 2], latencies[calls // 2:])
                       if h]},
    }
    if traced is not None:
        result["device"].update(busy_s=traced.busy_s,
                                window_s=traced.window_s)
        result["breakdown"] = traced.breakdown()
    result["check"] = check
    return result
