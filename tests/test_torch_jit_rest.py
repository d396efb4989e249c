"""The rest of the JAX package's compiled programs as CUDA graphs, on the
CPU through the stand-in capture of ``tests/test_torch_graphs.py``: the
train step (``jax.jit(step)``), the reloaded artifact program
(``exp.call``) and ``scan_blocks`` (``lax.scan``), and the graph runner's
rule for a program called inside another capture.

On the card ``tests/test_torch_cuda.py`` holds each graph bit for bit
against its eager body. Here the stand-in's "graph" runs the body again
over the static buffers; for the train step, whose body updates ``hk`` and
Adam's moments in place, the capture puts the state back as it found it (a
real capture runs nothing), so every step is taken once. Through the
stand-in each entry equals its eager body exactly, and ``scan_blocks``
equals the JAX package's ``lax.scan`` at the streaming tests' bar.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_graphs import StandIn

import pqmf_tpu_torch.export as tex
from pqmf_tpu.streaming import StreamingPQMF as JStreamingPQMF
from pqmf_tpu.streaming import scan_blocks as j_scan_blocks
from pqmf_tpu_torch import (PQMFPitchShiftWrapper, PQMFPitchShiftWrapperTA,
                            PQMFWrapper, StreamingPQMF, graphs)
from pqmf_tpu_torch.kernels import cached_conv as cc
from pqmf_tpu_torch.parallel import training as tt
from pqmf_tpu_torch.streaming import scan_blocks

CPU = torch.device("cpu")
SHIFTS4 = [1, -1, 3, -3]


class InPlaceStandIn(StandIn):
    """The stand-in capture for bodies that update tensors in place: the
    capture runs the body (to have its outputs) and then puts back every
    tensor of the registered train states, as a real capture, which runs
    nothing, leaves them."""

    def __init__(self):
        super().__init__()
        self.states = []

    def __call__(self, fn, args, device):
        saved = [[t.detach().clone() for t in _tensors(s)]
                 for s in self.states]
        try:
            return super().__call__(fn, args, device)
        finally:
            with torch.no_grad():
                for s, kept in zip(self.states, saved):
                    for t, k in zip(_tensors(s), kept):
                        t.copy_(k)


def _tensors(state):
    moments = state.optimizer.state.get(state.hk, {})
    return [state.hk, *(moments[k] for k in sorted(moments))]


@pytest.fixture
def stand_in(monkeypatch):
    cap = InPlaceStandIn()
    monkeypatch.setattr(graphs, "_graphed", lambda device: True)
    monkeypatch.setattr(graphs, "_capture", cap)
    monkeypatch.setattr(graphs, "_capturing", lambda: cap.capturing)
    return cap


def _noise(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape)
            .astype(np.float32))


def _hk(atten=70, M=4):
    return StreamingPQMF(atten, M, device="cpu").params["hk"]


# ---------------------------------------------------------------------------
# the rule: a program inside another capture runs its body
# ---------------------------------------------------------------------------


def test_a_program_inside_a_capture_runs_its_body(stand_in):
    """A program called while a capture runs records nothing: its body
    runs (into the outer graph on the card), no capture of its own is
    taken, and ``graphs.call`` caches no entry."""
    log, cache = [], {}

    def body(x):
        log.append("body")
        return x + 1.0

    inner = graphs.Program(body, CPU)
    key = ("body", 1, 4, "highest", CPU, 0)
    stand_in.capturing = True
    y = inner(torch.zeros(4))
    inner(torch.ones(4))
    z = graphs.call(cache, key, body, torch.ones(4))
    stand_in.capturing = False
    assert log == ["body"] * 3 and stand_in.events == []
    assert inner._replay is None and inner.launches is None and cache == {}
    torch.testing.assert_close(y, torch.ones(4), rtol=0, atol=0)
    torch.testing.assert_close(z, 2 * torch.ones(4), rtol=0, atol=0)
    # outside a capture the same program captures on its first call
    inner(torch.zeros(4))
    assert stand_in.events == ["capture"] and inner._replay is not None


def test_nested_launches_count_in_the_outer_program(stand_in):
    """The outer capture records the inner body's launches: a replay of
    the outer program adds them, the inner program adds none."""
    cc.reset_launches()

    def inner_body(x):
        cc.LAUNCHES["analysis"] += 1
        return x * 2.0

    inner = graphs.Program(inner_body, CPU)
    outer = graphs.Program(lambda x: inner(inner(x)), CPU)
    outer(torch.ones(3))       # eager: inner eager, then inner captured
    assert stand_in.events == ["capture", "replay", "capture"]
    assert outer.launches[0]["analysis"] == 2
    before = dict(cc.LAUNCHES)
    got = outer(torch.ones(3))
    assert cc.LAUNCHES["analysis"] - before["analysis"] == 2
    assert stand_in.events[-1] == "replay"
    torch.testing.assert_close(got, 4 * torch.ones(3), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _lr_spy(state, seen):
    """Record the lr each optimizer step reads (the stand-in's replay runs
    the body, so the step the graph would replay is seen)."""
    real = state.optimizer.step

    def step(*args, **kwargs):
        seen.append(float(state.optimizer.param_groups[0]["lr"]))
        return real(*args, **kwargs)

    state.optimizer.step = step


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_graphed_train_step_replays_equal_the_eager_step(stand_in, remat,
                                                         schedule):
    """Five steps of the fine-tune loss: the graphed step (one capture,
    four replays) equals the eager step bit for bit in every loss and in
    hk and Adam's moments, and each replay reads the schedule's lr of its
    own count, written before it."""
    steps = 5
    rate = (tt.cosine_decay_schedule(1e-3, steps) if schedule == "cosine"
            else 1e-3)
    init, step = tt.make_train_step(tt.adam(rate), remat=remat,
                                    loss_fn=tt.make_finetune_loss(4, 64),
                                    device="cpu")
    sg, se = init(_hk()), init(_hk())
    stand_in.states.append(sg)
    seen = []
    _lr_spy(sg, seen)
    xs = [torch.from_numpy(_noise((2, 1, 512), 10 + i)) for i in range(steps)]
    for x in xs:
        _, lg = step(sg, x)
        _, le = step.eager(se, x)
        assert torch.equal(lg, le)
        assert torch.equal(sg.hk, se.hk)
    assert stand_in.events == ["capture"] + ["replay"] * (steps - 1)
    (key,) = sg._graphs
    assert key[:4] == ((2, 1, 512), torch.float32, "highest", remat)
    assert callable(key[4])  # the step's loss
    assert se._graphs == {} and sg.count == se.count == steps
    a, b = sg.optimizer.state[sg.hk], se.optimizer.state[se.hk]
    for k in ("exp_avg", "exp_avg_sq"):
        assert torch.equal(a[k], b[k]), k
    # the eager first call, the capture, then one read a replay
    want = [tt.cosine_decay_schedule(1e-3, steps)(i) if schedule == "cosine"
            else 1e-3 for i in range(steps)]
    assert seen[0] == seen[1] == want[0] and seen[2:] == want[1:]


def test_each_train_state_and_geometry_gets_its_own_graph(stand_in,
                                                          tmp_path):
    """A graph holds one state's hk and moments: a new state, and a state
    that ``load_train_state`` makes, capture their own; a new batch shape
    is another key. The loaded state's graphed steps equal eager steps
    from the same checkpoint."""
    init, step = tt.make_train_step(
        tt.adam(tt.cosine_decay_schedule(1e-3, 8)), device="cpu")
    xs = [torch.from_numpy(_noise((2, 1, 256), 20 + i)) for i in range(4)]
    a = init(_hk())
    stand_in.states.append(a)
    for x in xs[:2]:
        step(a, x)
    assert len(a._graphs) == 1
    step(a, torch.from_numpy(_noise((3, 1, 256), 30)))
    assert len(a._graphs) == 2
    b = init(_hk())
    assert b._graphs == {}
    stand_in.states.append(b)
    step(b, xs[0])
    assert len(b._graphs) == 1
    assert next(iter(b._graphs.values())) not in a._graphs.values()

    path = tt.save_train_state(a, str(tmp_path / "a.npz"))
    c, ce = tt.load_train_state(a, path), tt.load_train_state(a, path)
    assert c._graphs == {} and c.count == 3
    stand_in.states.append(c)
    for x in xs[2:]:
        _, lc = step(c, x)
        _, le = step.eager(ce, x)
        assert torch.equal(lc, le) and torch.equal(c.hk, ce.hk)
    assert len(c._graphs) == 1
    assert stand_in.events.count("capture") == 4


def test_cpu_train_step_caches_nothing():
    """On the CPU the step runs its body: no graph, the plain Adam with a
    float lr (``tests/test_torch_training.py`` holds it against optax)."""
    init, step = tt.make_train_step(
        tt.adam(tt.cosine_decay_schedule(1e-3, 4)), device="cpu")
    state = init(_hk())
    for i in range(2):
        step(state, torch.from_numpy(_noise((2, 1, 256), 40 + i)))
    group = state.optimizer.param_groups[0]
    assert state._graphs == {} and isinstance(group["lr"], float)
    assert not group["capturable"]


# ---------------------------------------------------------------------------
# the reloaded artifact program
# ---------------------------------------------------------------------------

M, T = 8, 1024
KINDS = ("flagship", "ta", "plain")


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    root = tmp_path_factory.mktemp("jit_aot")
    out = {}
    for kind in KINDS:
        w = {"flagship": lambda: PQMFPitchShiftWrapper(
                100, M, T, 44100, [0, 4, -5, -12, 3, -7, 2, -3],
                device="cpu"),
             "ta": lambda: PQMFPitchShiftWrapperTA(
                100, M, T, 44100, [0, -3, 5, 12, -7, 2, 1, -1],
                device="cpu"),
             "plain": lambda: PQMFWrapper(100, M, T, device="cpu")}[kind]()
        out[kind] = tex.save_artifact(w, str(root / kind),
                                      with_stablehlo=True)
    return out


def _program_args(kind, x, tail):
    return (tail, x[0]) if kind == "flagship" else (x,)


@pytest.mark.parametrize("kind", KINDS)
def test_loaded_program_replays_equal_the_module(stand_in, saved, kind):
    """Three blocks (the flagship's tail carried): one capture, then
    replays, each equal to ``program.eager`` (``ep.module()`` after the same
    checks) bit for bit; one graph for the one geometry."""
    program = tex.load_stablehlo(saved[kind], device="cpu")
    tail_g = tail_e = torch.zeros((M, 32))
    for i in range(3):
        x = torch.from_numpy(_noise((1, 1, T), 50 + i) * 0.3)
        got = program(*_program_args(kind, x, tail_g))
        want = program.eager(*_program_args(kind, x, tail_e))
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, e in zip(got, want):
            assert torch.equal(g, e)
        if kind == "flagship":
            tail_g, tail_e = got[0], want[0]
    assert stand_in.events == ["capture", "replay", "replay"]
    with pytest.raises(ValueError, match="float64"):
        program(*_program_args(kind, torch.zeros((1, 1, T),
                                                 dtype=torch.float64),
                               tail_g.double() if kind == "flagship"
                               else None))


# ---------------------------------------------------------------------------
# scan_blocks
# ---------------------------------------------------------------------------


def test_scan_blocks_graph_equals_the_loop_and_jax(stand_in):
    """``scan_blocks`` over ``StreamingPQMF.process_block``: one graph a
    stream geometry, cached on the PQMF (key: step, n_blocks, block shape,
    dtype, state tree and shapes, device, weights_version); the replays
    equal the loop bit for bit and the JAX package's ``lax.scan`` at the
    streaming tests' bar; a new bank evicts the graph."""
    jp, tp = JStreamingPQMF(100, 16), StreamingPQMF(100, 16, device="cpu")
    n_blocks, B = 4, 2048
    xs = [_noise((n_blocks, 1, 1, B), 60 + i) for i in range(2)]
    for x in xs:
        ts, tys = scan_blocks(tp.process_block, tp.init_state(), x)
        state, loop = tp.init_state(), []
        for b in x:
            state, y = tp.process_block(state, b)
            loop.append(y)
        assert torch.equal(tys, torch.stack(loop))
        for k in ("analysis", "synthesis"):
            assert torch.equal(ts[k], state[k]), k
        js, jys = j_scan_blocks(lambda s, b: jp.process_block(s, b),
                                jp.init_state(), jnp.asarray(x))
        np.testing.assert_allclose(tys.numpy(), np.asarray(jys), atol=2e-5,
                                   rtol=1e-4)
    assert stand_in.events == ["capture", "replay"]
    (key,) = tp._graphs
    assert key[:5] == ("scan_blocks", "process_block", n_blocks, (1, 1, B),
                       torch.float32)
    assert key[-2:] == (CPU, 0)
    assert key[6] == tuple((tuple(t.shape), t.dtype)
                           for t in tp.init_state().values())
    tp.set_weights(tp.params)
    scan_blocks(tp.process_block, tp.init_state(), xs[0])
    assert [k[-1] for k in tp._graphs] == [1]


def test_scan_blocks_over_the_graphed_pitchshift_fn(stand_in):
    """Over the flagship's ``pitchshift_fn``, itself a graph: the eager
    first run replays the step's own graph, the scan's capture runs the
    step's eager body (no capture of its own), and the scan's replays equal
    a loop of the eager body bit for bit."""
    w = PQMFPitchShiftWrapper(70, 4, 512, shifts_in_semitones=SHIFTS4,
                              device="cpu")
    x = _noise((3, 1, 512), 70) * 0.3
    s0 = w.init_state()
    got = [scan_blocks(w.pitchshift_fn, s0, x) for _ in range(2)]
    # the step: capture + 2 replays in the eager run; then the scan's
    # capture (the step's body inside) and one scan replay
    assert stand_in.events == ["capture", "replay", "replay", "capture",
                               "replay"]
    assert len(w._graphs) == 2
    state, loop = s0, []
    for b in x:
        state, y = w._pitchshift_fn_eager(state, torch.from_numpy(b))
        loop.append(y)
    for ts, tys in got:
        assert torch.equal(tys, torch.stack(loop))
        assert torch.equal(ts["prev_tail"], state["prev_tail"])


def test_scan_blocks_loops_any_other_callable(stand_in):
    """A function that is no bound method of a versioned owner runs the
    loop, one step at a time: nothing is captured."""
    tp = StreamingPQMF(100, 16, device="cpu")
    x = _noise((2, 1, 1, 512), 80)
    _, a = scan_blocks(lambda s, b: tp.process_block(s, b), tp.init_state(),
                       x)
    assert stand_in.events == [] and tp._graphs == {}
    _, b = scan_blocks(tp.process_block, tp.init_state(), x)
    assert torch.equal(a, b) and stand_in.events == ["capture"]
    count, ys = scan_blocks(lambda n, blk: (n + 1, torch.as_tensor(blk) * 2),
                            0, x)
    assert count == 2 and torch.equal(ys, torch.from_numpy(x) * 2)
    assert stand_in.events == ["capture"]


def test_train_determinism_tool_needs_a_card():
    """``tools/train_determinism.py`` measures on the card only: without
    one it exits 1 and prints no reading."""
    import os
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tool runs there")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "tools/train_determinism.py"],
                         cwd=root, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 1 and res.stdout == ""
    assert "no CUDA device" in res.stderr
