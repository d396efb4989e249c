"""The PQMF bank used bare: what its modes share. Each traffic mode is a
file of its own, ``filterbank.<mode>.py``, with ``build`` and ``check``
against ``reference.bank``: ``files`` (offline round trips of clips on the
card) and ``live`` (``PQMFWrapper``'s host blocks)."""

from __future__ import annotations

import math


def rel(y, r) -> float:
    """||y - r|| / ||r|| over one answer; infinite when their sizes
    differ."""
    if y.numel() != r.numel():
        return math.inf
    return float((y.reshape(-1) - r.reshape(-1)).norm() / r.norm())
