"""The fast-serving tier's ``streams`` mode: ``pitch_shifter.streams``'s
program (``rows`` streams, one ``pitchshift_streams`` call a step on a
host block, each stream's tail carried, the output back on the host) at
the configuration's precision, checked against the tier's reference."""

from __future__ import annotations

from benchmark import harness
from benchmark.systems.pitch_shifter_fast import check  # noqa: F401

Program = harness._module(
    harness.ROOT / "systems" / "pitch_shifter.streams.py").Program


def build(config: dict, traffic: dict, device):
    return Program(config, traffic, device)
