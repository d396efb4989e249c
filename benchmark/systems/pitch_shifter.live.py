"""The flagship's ``live`` mode: one stream, one ``pitchshift_fn`` call (a
graph replay) a [1, block] host block, the state carried, the output
copied back to the host."""

from __future__ import annotations

from benchmark import harness
from benchmark.systems import pitch_shifter
from benchmark.systems.pitch_shifter import check  # noqa: F401


class Program:
    def __init__(self, config: dict, traffic: dict, device):
        self.rows = int(traffic["rows"])
        if self.rows != 1:
            raise ValueError("a live stream has one row")
        self.block = harness.block_size(config, traffic)
        self.w = pitch_shifter.wrapper(config, device)
        self.reset()

    def reset(self):
        """A fresh state: the stream's first block comes next."""
        self.state = self.w.init_state()

    def call(self, x):
        self.state, y = self.w.pitchshift_fn(self.state, x.numpy())
        return (y.cpu(),)


def build(config: dict, traffic: dict, device) -> Program:
    return Program(config, traffic, device)
