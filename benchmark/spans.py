"""The program's own spans in a traced slice.

``pqmf_tpu_torch`` marks its entries, a host block's handover and a graph's
replay with ``record_function`` events (``utils.profiling.span``, named
``pqmf.<...>``) while a profiler records. They land in the slice's Chrome
trace beside the device's operations, and ``tracing.Traced`` keeps them
among its host events as ``host: <name>``. This module gives, clipped to
the slice (``bench.slice``):

- ``union(t, match)``: the merged intervals of the spans whose names
  ``match`` accepts;
- ``seconds(intervals)``: their length;
- ``self_seconds(t, match)``: those spans' seconds less the part that
  other program spans inside them cover (their children), i.e. the time
  the matched layer's own code held the host.

A version of the program without these spans gives empty unions; the
readers then report nothing.
"""

from __future__ import annotations

from benchmark import tracing

__all__ = ["PREFIX", "union", "seconds", "self_seconds"]

PREFIX = "pqmf."
HOST = "host: "


def _name(host_name: str) -> str | None:
    """The program span's name of a ``Traced`` host event's name, else
    None."""
    if not host_name.startswith(HOST + PREFIX):
        return None
    return host_name[len(HOST):]


def union(t, match) -> list:
    """Merged [start, end] intervals (us, the trace's clock) of the program
    spans whose names ``match(name)`` accepts, clipped to the slice."""
    out = []
    for a, b, host_name in t._host:
        name = _name(host_name)
        if name is None or not match(name):
            continue
        a, b = max(a, t._t0), min(b, t._t1)
        if b > a:
            out.append((a, b))
    return tracing._merge(out)


def seconds(intervals) -> float:
    return sum(b - a for a, b in intervals) / 1e6


def _minus(keep: list, cut: list) -> list:
    """The parts of merged intervals ``keep`` outside merged ``cut``."""
    out, j = [], 0
    for a, b in keep:
        while j < len(cut) and cut[j][1] <= a:
            j += 1
        k = j
        while k < len(cut) and cut[k][0] < b:
            if cut[k][0] > a:
                out.append([a, cut[k][0]])
            a = max(a, cut[k][1])
            k += 1
        if b > a:
            out.append([a, b])
    return out


def self_seconds(t, match) -> float | None:
    """Seconds of the spans ``match`` accepts less every other program
    span's inside them; None when the slice holds no such span."""
    mine = union(t, match)
    if not mine:
        return None
    others = union(t, lambda n: not match(n))
    return seconds(_minus(mine, others))

