"""The flagship's ``streams`` mode: ``rows`` independent streams, one
``pitchshift_streams`` call a step on a [rows, block] host block, each
stream's crossfade tail carried, the output copied back to the host."""

from __future__ import annotations

from benchmark import harness
from benchmark.systems import pitch_shifter
from benchmark.systems.pitch_shifter import check  # noqa: F401


class Program:
    def __init__(self, config: dict, traffic: dict, device):
        self.rows = int(traffic["rows"])
        self.block = harness.block_size(config, traffic)
        self.w = pitch_shifter.wrapper(config, device)
        self.reset()

    def reset(self):
        """A fresh state: every stream's first block comes next."""
        self.state = self.w.init_streams(self.rows)

    def call(self, x):
        self.state, y = self.w.pitchshift_streams(self.state, x.numpy())
        return (y.cpu(),)


def build(config: dict, traffic: dict, device) -> Program:
    return Program(config, traffic, device)
