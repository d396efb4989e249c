"""Profiling and timing helpers.

Counterpart of ``pqmf_tpu/utils/profiling.py``: :func:`trace` records a
``torch.profiler`` trace, :func:`dispatch_floor_ms` is the time of one
launch, and :func:`chained_ms` times chains of ``n`` and ``2n``
applications and differences them, so a constant overhead (the first
launch, the final synchronize) cancels. On the card they time with CUDA
events; on a CPU tensor :func:`chained_ms` uses the host clock.

:func:`span` marks a stretch of the port's host code (its entries, a host
block's handover, a graph's replay) in a running profiler's trace, beside
the device's kernels and copies on the same clock. It records only while
a ``torch.profiler`` records; otherwise it costs a gate check.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "span", "chained_ms", "dispatch_floor_ms"]

_OFF = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context that records ``name`` as a ``record_function`` event while
    a ``torch.profiler`` records (:func:`trace`, or any profiler of the
    caller), and the one shared no-op otherwise, also while
    ``torch.compile`` or ``torch.export`` traces: a span never enters a
    traced or exported program. The profiler keeps the events and writes
    them with its trace."""
    if torch.compiler.is_compiling() or not _profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block's CPU and CUDA activity with ``torch.profiler``
    and write a Chrome trace (``trace.json``) into ``log_dir``; yields the
    profiler (``key_averages()`` sums device time by kernel)."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def dispatch_floor_ms(repeats: int = 100) -> float:
    """Milliseconds per launch of a one-element kernel on the card, by CUDA
    events over ``repeats`` back-to-back launches: the floor every launch
    of the eager port sits on."""
    v = torch.zeros(1, device="cuda")
    for _ in range(3):
        v.add_(1.0)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(repeats):
        v.add_(1.0)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / repeats


def _chain_seconds(fn, x, k: int) -> float:
    """Seconds for ``k`` applications of ``fn`` from ``x``, on the device's
    clock (CUDA events) for a CUDA tensor, else the host's."""
    if x.is_cuda:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        v = x
        for _ in range(k):
            v = fn(v)
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3
    t0 = time.perf_counter()
    v = x
    for _ in range(k):
        v = fn(v)
    return time.perf_counter() - t0


def chained_ms(fn, x: torch.Tensor, n: int = 50, repeats: int = 3) -> float:
    """Milliseconds per application of shape-preserving ``fn``: the best of
    ``repeats`` chains of ``n`` and of ``2n`` applications, differenced,
    over ``n``. NaN when the ``2n`` chain measured no slower than the ``n``
    chain (a window too noisy for a valid difference)."""
    _chain_seconds(fn, x, n)  # warm-up: first-use builds and caches
    best_n = best_2n = float("inf")
    for _ in range(repeats):
        best_n = min(best_n, _chain_seconds(fn, x, n))
        best_2n = min(best_2n, _chain_seconds(fn, x, 2 * n))
    if best_2n <= best_n:
        return float("nan")
    return (best_2n - best_n) / n * 1e3
