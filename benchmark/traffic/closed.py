"""The closed loop: each call is made as soon as the one before it has
returned, for ``seconds``; the last call is the first to return after the
window's end. A call's latency runs from its start to its return.

A loop module (``traffic/<loop>.py``, named by a traffic file's ``loop``)
has ``measure(prog, pool, g, seconds, traffic, kept)``: it calls
``prog.call`` on pool item ``g % len(pool)`` for call ``g`` onward, offers
every call's ``(g, outputs)`` to ``kept`` (``harness.Reservoir``), and
returns (every call's latency in seconds, the window's start on
``time.perf_counter``)."""

from __future__ import annotations

import time


def measure(prog, pool: list, g: int, seconds: float, traffic: dict, kept):
    latencies = []
    t0 = time.perf_counter()
    t_end = t0 + seconds
    while True:
        t_call = time.perf_counter()
        out = prog.call(pool[g % len(pool)])
        t_done = time.perf_counter()
        latencies.append(t_done - t_call)
        kept.offer((g, out))
        g += 1
        if t_done >= t_end:
            return latencies, t0
