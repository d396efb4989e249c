"""A run, its look for a card skipped, driven on the CPU at a small size
with the timed path broken underneath: ``correct`` must come out false for
each fault a cell can have, and true without one.

The faults: a step that returns its state unchanged (the flagship's
carried tails); half of the batch left out, its rows filled from the rest
(the streams, the clips); an answer altered where it is produced (one
sample of every output); one stream wrong in every step (the last stream
slot given the first's output); a few calls wrong (one live block in ten
given the output of the block before it; every live call is kept here). One card, so no exchange between chips."""

from __future__ import annotations

import pytest

from benchmark import harness

SMALL = {"pvoc16.streams": {"rows": 4, "pool": 3, "warmup": 3},
         "pqmf16.files": {"rows": 2, "seconds_of_audio": 1, "warmup": 3},
         "pvoc16.live": {"pool": 4, "warmup": 3, "sample": 1000},
         "pqmf16.live": {"pool": 4, "warmup": 3, "sample": 1000}}


def run(cell):
    return harness.run(cell, 2**31 + 99, 0.3, False, "cpu",
                       traffic_update=SMALL[cell])


def unchanged_state(monkeypatch):
    from pqmf_tpu_torch.pipelines import PQMFPitchShiftWrapper as W

    for name in ("_pitchshift_streams_eager", "_pitchshift_fn_eager"):
        body = getattr(W, name)

        def broken(self, state, x, *a, _body=body):
            _, y = _body(self, state, x, *a)
            return state, y

        monkeypatch.setattr(W, name, broken)


def half_batch(monkeypatch):
    import torch

    from pqmf_tpu_torch import PQMF
    from pqmf_tpu_torch.pipelines import PQMFPitchShiftWrapper as W

    body = W._pitchshift_streams_eager

    def streams(self, states, x):
        h = x.shape[0] // 2
        new, y = body(self, {"prev_tail": states["prev_tail"][:h]}, x[:h])
        rep = lambda t: torch.cat([t, t[:x.shape[0] - h]])  # noqa: E731
        return {"prev_tail": rep(new["prev_tail"])}, rep(y)

    roundtrip = PQMF.roundtrip

    def files(self, x):
        y = roundtrip(self, x[:x.shape[0] // 2])
        return torch.cat([y, y[:x.shape[0] - y.shape[0]]])

    monkeypatch.setattr(W, "_pitchshift_streams_eager", streams)
    monkeypatch.setattr(PQMF, "roundtrip", files)


def altered_answer(monkeypatch):
    from pqmf_tpu_torch import PQMF
    from pqmf_tpu_torch.pipelines import PQMFPitchShiftWrapper as W
    from pqmf_tpu_torch.pipelines import PQMFWrapper

    def bump(y):
        y = y.clone()
        y[..., 0] += 1e-3
        return y

    for name in ("_pitchshift_streams_eager", "_pitchshift_fn_eager"):
        body = getattr(W, name)

        def broken(self, *a, _body=body):
            state, y = _body(self, *a)
            return state, bump(y)

        monkeypatch.setattr(W, name, broken)
    roundtrip = PQMF.roundtrip
    monkeypatch.setattr(PQMF, "roundtrip",
                        lambda self, x: bump(roundtrip(self, x)))
    process = PQMFWrapper.process
    monkeypatch.setattr(PQMFWrapper, "process",
                        lambda self, x: tuple(map(bump, process(self, x))))


def one_stream(monkeypatch):
    from pqmf_tpu_torch.pipelines import PQMFPitchShiftWrapper as W

    body = W._pitchshift_streams_eager

    def streams(self, states, x):
        new, y = body(self, states, x)
        y = y.clone()
        y[-1] = y[0]
        return new, y

    monkeypatch.setattr(W, "_pitchshift_streams_eager", streams)


def few_calls(monkeypatch):
    from pqmf_tpu_torch.pipelines import PQMFPitchShiftWrapper as W

    body = W._pitchshift_fn_eager
    seen = []

    def live(self, state, x, *a):
        new, y = body(self, state, x, *a)
        seen.append(y.clone())
        if len(seen) % 10 == 4:  # the window's first call (after 3 warm-up)
            y = seen[-2]
        return new, y

    monkeypatch.setattr(W, "_pitchshift_fn_eager", live)


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_answer": altered_answer, "one_stream": one_stream,
          "few_calls": few_calls}
CASES = [("pvoc16.streams", "unchanged_state"),
         ("pvoc16.streams", "half_batch"),
         ("pvoc16.streams", "altered_answer"),
         ("pvoc16.streams", "one_stream"),
         ("pvoc16.live", "unchanged_state"),
         ("pvoc16.live", "few_calls"),
         ("pvoc16.live", "altered_answer"),
         ("pqmf16.files", "half_batch"),
         ("pqmf16.files", "altered_answer"),
         ("pqmf16.live", "altered_answer")]


@pytest.mark.parametrize("cell", list(SMALL))
def test_sound_run_is_correct(cell):
    r = run(cell)
    assert r["correct"] and r["failed"] == 0, r["check"]
    assert r["attempted"] == r["window"]["calls"] * SMALL[cell].get("rows", 1)


# the number each fault has to fail where the others may pass
CAUGHT_BY = {("pvoc16.streams", "one_stream"): "stream_rel_err_max",
             ("pvoc16.live", "few_calls"): "rel_err_p95"}


@pytest.mark.parametrize("cell, fault", CASES)
def test_fault_is_caught(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    r = run(cell)
    assert not r["correct"], r["check"]
    assert r["failed"] > 0
    if (cell, fault) in CAUGHT_BY:
        c = r["check"][CAUGHT_BY[cell, fault]]
        assert c["value"] > c["limit"], r["check"]
