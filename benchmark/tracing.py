"""The traced slice: ``torch.profiler`` over a bounded run of calls after
the window, read back from its Chrome trace.

``profile`` runs ``warm`` calls and then ``n`` calls inside one
``bench.slice`` annotation, each call in a ``bench.call`` annotation,
under ``torch.profiler`` (CPU and CUDA activities), and writes the trace
to ``<out>/trace.json``. ``Traced`` holds what the per-layer metrics read:

- ``window_s``: the slice's length (its annotation, on the profiler's
  host clock); ``calls``: calls in it;
- ``busy_s``: seconds in which an operation ran on the device (the union
  of the kernels', copies' and sets' intervals, clipped to the slice);
- ``ops``: every device operation in the slice as (name, category,
  seconds), category ``kernel``, ``memcpy`` (with its direction in the
  name) or ``memset``;
- ``gaps``: the idle intervals between device operations, each named by
  what the host was doing in it (``breakdown``).

The busy time follows ``chip_smoke.py``'s ``_profile`` (device rows of a
steady slice of calls), as a union of intervals so that overlapping copies
and kernels count once; the idle share's wall time is the untraced
window's (``metrics.idle_share``).
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from pathlib import Path

import torch

__all__ = ["Traced", "profile", "read_trace"]

DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "memcpy",
               "gpu_memset": "memset"}
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


class Traced:
    def __init__(self, calls: int, window_s: float, ops: list, busy: list,
                 host: list, t0: float, t1: float):
        self.calls = calls
        self.window_s = window_s
        self.ops = ops              # [(name, category, seconds)]
        self._busy = busy           # merged device intervals, us
        self._host = sorted(host)   # [(ts, end, name)] host events, us
        self._starts = [h[0] for h in self._host]
        self._t0, self._t1 = t0, t1
        self.busy_s = sum(b - a for a, b in busy) / 1e6
        self.context = {}

    def seconds(self, category: str, exclude=()) -> float:
        """Summed seconds of the device operations of ``category`` whose
        names contain none of ``exclude``."""
        return sum(s for n, c, s in self.ops
                   if c == category and not any(e in n for e in exclude))

    def count(self, category: str) -> int:
        return sum(1 for _, c, _ in self.ops if c == category)

    def gaps(self) -> list:
        """[(seconds, what the host was doing)] of every idle interval of
        the device within the slice."""
        edges = [self._t0] + [x for ab in self._busy for x in ab] + [self._t1]
        out = []
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                out.append(((b - a) / 1e6, self._host_at((a + b) / 2)))
        return out

    def _host_at(self, t: float) -> str:
        """The innermost host event around ``t`` (of nested events, the
        latest to start that still holds it), else the harness's own
        Python between calls."""
        i = bisect.bisect_right(self._starts, t)
        for a, b, name in reversed(self._host[max(0, i - 512):i]):
            if b >= t:
                return name
        return "host: between program calls"

    def breakdown(self, top: int = 10) -> dict:
        by_op = defaultdict(float)
        for n, _, s in self.ops:
            by_op[n] += s
        by_gap = defaultdict(float)
        for s, name in self.gaps():
            by_gap[name] += s
        return {
            "device_ops": [[n, s] for n, s in sorted(
                by_op.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[n, s] for n, s in sorted(
                by_gap.items(), key=lambda kv: -kv[1])[:top]],
        }


def _short(name: str, width: int = 96) -> str:
    name = name.removeprefix("void ")
    return name if len(name) <= width else name[:width - 3] + "..."


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read_trace(path: Path, calls: int) -> Traced:
    """A ``Traced`` of the ``bench.slice`` annotation of the Chrome trace
    at ``path``."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    slices = [e for e in events if e.get("name") == "bench.slice"
              and e.get("cat") == "user_annotation"]
    if len(slices) != 1:
        raise RuntimeError(f"expected one bench.slice span, found "
                           f"{len(slices)}")
    t0 = float(slices[0]["ts"])
    t1 = t0 + float(slices[0]["dur"])
    ops, spans, host = [], [], []
    for e in events:
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            a, b = max(a, t0), min(b, t1)
            if b > a:
                ops.append((_short(e["name"]), DEVICE_CATS[cat],
                            (b - a) / 1e6))
                spans.append((a, b))
        elif cat in HOST_CATS and e["name"] not in ("bench.slice",
                                                    "bench.call"):
            if b > t0 and a < t1:
                host.append((a, b, "host: " + _short(e["name"], 64)))
    return Traced(calls, (t1 - t0) / 1e6, ops, _merge(spans), host, t0, t1)


def profile(prog, pool: list, g: int, n: int, device, out: Path,
            warm: int = 5) -> Traced:
    """Profile ``n`` calls of ``prog`` (after ``warm`` unannotated ones)
    on the pool items from call ``g`` on; the trace goes to
    ``out/trace.json``."""
    from torch.profiler import ProfilerActivity, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(warm):
            prog.call(pool[(g + i) % len(pool)])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        with record_function("bench.slice"):
            for i in range(warm, warm + n):
                with record_function("bench.call"):
                    prog.call(pool[(g + i) % len(pool)])
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    path = out / "trace.json"
    prof.export_chrome_trace(str(path))
    return read_trace(path, n)
