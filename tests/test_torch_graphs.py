"""The graph runner (``pqmf_tpu_torch/graphs.py``) on the CPU, through a
stand-in capture.

On the card every graphed entry (``pitchshift_fn``, ``pitchshift_streams``,
the TA ``pitchshifter``, ``stream_ola``, ``PQMFWrapper.process``) captures its eager body once per
key and replays it; ``tests/test_torch_cuda.py`` holds the graphs bit for
bit against the eager bodies there. Here the tests patch in a stand-in for
the capture, whose "graph" runs the body again over the static buffers and
writes the static outputs in place, as a replay does, and hold the runner's
contract with it: the key fields, the eager first call, no output aliased
by a later call, the launch counts of captures and replays, eviction on
``weights_version``, a failed capture raising, and a dropped wrapper
collected. Through the stand-in every entry equals its eager body exactly.
"""

import ctypes
import gc
import io
import re
import shutil
import subprocess
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from pqmf_tpu_torch import (PQMFPitchShiftWrapper, PQMFPitchShiftWrapperTA,
                            PQMFWrapper, graphs, stream_ola)
from pqmf_tpu_torch import export as ex
from pqmf_tpu_torch.kernels import cached_conv as cc
from pqmf_tpu_torch.kernels import polyphase as pk
from pqmf_tpu_torch.ops import filterbank as fb
from pqmf_tpu_torch.streaming import kernels_from_params

CPU = torch.device("cpu")
SHIFTS4 = [1, -1, 3, -3]
TA_SHIFTS8 = [12, -12, 0, 24, -24, 12, -12, 7]  # small resample ratios


def _audio(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(
        np.float32)


def _counts():
    return dict(cc.LAUNCHES), dict(pk.LAUNCHES)


def _restore(counts):
    cc.LAUNCHES.update(counts[0])
    pk.LAUNCHES.update(counts[1])


class StandIn:
    """A capture for the CPU: records the body, and its replay, given the
    call's argument leaves and its fresh output tensors, runs the body
    again on those arguments and writes the result into those outputs, as
    a replay's re-pointed copy nodes do. A real replay touches no Python
    counter, so neither does this one's body. While the body runs in
    either, ``graphs._capturing()`` is true (a program it calls runs its
    body into this one, as it would into a real capture). ``fail`` makes
    the capture raise."""

    def __init__(self):
        self.events = []
        self.fail = False
        self.capturing = False

    def inside(self, fn, args):
        self.capturing = True
        try:
            return fn(*args)
        finally:
            self.capturing = False

    def __call__(self, fn, args, device):
        self.events.append("capture")
        if self.fail:
            raise RuntimeError("capture refused")
        out = self.inside(fn, args)

        def replay(leaves, outs):
            self.events.append("replay")
            counts = _counts()
            new = self.inside(fn, leaves)
            _restore(counts)
            tensors = [t for t in torch.utils._pytree.tree_leaves(new)
                       if isinstance(t, torch.Tensor)]
            assert len(tensors) == len(outs)
            for o, n in zip(outs, tensors):
                o.copy_(n)

        return replay, out, {"capture_ms": 0.0, "instantiate_ms": 0.0,
                             "pool_bytes": 0, "output_bytes": 0}


@pytest.fixture
def stand_in(monkeypatch):
    cap = StandIn()
    monkeypatch.setattr(graphs, "_graphed", lambda device: True)
    monkeypatch.setattr(graphs, "_capture", cap)
    monkeypatch.setattr(graphs, "_capturing", lambda: cap.capturing)
    return cap


@pytest.fixture
def flagship():
    return PQMFPitchShiftWrapper(70, 4, 512, shifts_in_semitones=SHIFTS4,
                                 device="cpu")


def _scaled_bank(pqmf):
    """The installed bank with hk halved, as set_weights takes it."""
    hk = np.asarray(pqmf.params["hk"]) * 0.5
    params = fb.params_from_hk(hk, h=np.asarray(pqmf.params["h"]))
    return (params, *kernels_from_params(params))


# ---------------------------------------------------------------------------
# the runner, on a body that counts launches of its own
# ---------------------------------------------------------------------------


def _body(log):
    def body(state, x):
        log.append("body")
        cc.LAUNCHES["analysis"] += 1
        pk.LAUNCHES["roundtrip"] += 2
        return {"s": state["s"] + x}, x * 2.0
    return body


def test_first_call_runs_eagerly_then_captures(stand_in):
    log, cache = [], {}
    key = ("body", 1, 4, "highest", CPU, 0)
    x = torch.arange(4.0)
    s1, y1 = graphs.call(cache, key, _body(log), {"s": torch.zeros(4)}, x)
    # the eager run, then the capture (the stand-in runs the body in it)
    assert log == ["body", "body"] and stand_in.events == ["capture"]
    prog = cache[key]
    assert y1 is not prog._static_out[1] and s1 is not prog._static_out[0]
    torch.testing.assert_close(y1, x * 2.0, rtol=0, atol=0)
    s2, y2 = graphs.call(cache, key, _body(log), s1, x)
    assert stand_in.events == ["capture", "replay"]
    torch.testing.assert_close(s2["s"], 2 * x, rtol=0, atol=0)


def test_replays_add_the_captured_launches(stand_in):
    cc.reset_launches()
    pk.reset_launches()
    cache, key, log = {}, ("body", 1, 4, "highest", CPU, 0), []
    state, x = {"s": torch.zeros(4)}, torch.ones(4)
    state, _ = graphs.call(cache, key, _body(log), state, x)
    # the eager run counts; the capture adds nothing
    assert (cc.LAUNCHES["analysis"], pk.LAUNCHES["roundtrip"]) == (1, 2)
    assert cache[key].launches == [
        {"analysis": 1, "synthesis": 0, "roundtrip": 0},
        {"analysis": 0, "synthesis": 0, "roundtrip": 2},
        {"frame": 0, "spectral": 0, "resynth": 0}]
    for n in range(2, 5):
        state, _ = graphs.call(cache, key, _body(log), state, x)
        assert (cc.LAUNCHES["analysis"], pk.LAUNCHES["roundtrip"]) == (n,
                                                                      2 * n)
    torch.testing.assert_close(state["s"], 4 * x, rtol=0, atol=0)


def test_a_failed_capture_raises(stand_in):
    """On the card a capture that fails raises: the eager result of the
    same call is not returned in its place, and the launch counters keep
    only the eager run's launches."""
    stand_in.fail = True
    cc.reset_launches()
    pk.reset_launches()
    cache, key = {}, ("body", 1, 4, "highest", CPU, 0)
    for n in (1, 2):
        with pytest.raises(RuntimeError, match="capture refused"):
            graphs.call(cache, key, _body([]), {"s": torch.zeros(4)},
                        torch.ones(4))
        assert cc.LAUNCHES["analysis"] == n
    assert cache[key]._replay is None


def test_a_failed_capture_raises_from_the_wrapper(stand_in, flagship):
    stand_in.fail = True
    x = _audio((1, 512), 1)
    with pytest.raises(RuntimeError, match="capture refused"):
        flagship.pitchshift_fn(flagship.init_state(), x)
    with pytest.raises(RuntimeError, match="capture refused"):
        stream_ola(flagship, x, 256)


def test_a_replay_refuses_other_arguments(stand_in):
    cache, key = {}, ("body", 1, 4, "highest", CPU, 0)
    state, x = {"s": torch.zeros(4)}, torch.ones(4)
    for _ in range(2):
        graphs.call(cache, key, _body([]), state, x)
    for bad_state, bad_x in [({"s": torch.zeros(4, dtype=torch.float64)}, x),
                             ({"s": torch.zeros(5)}, x),
                             ({"t": torch.zeros(4)}, x),
                             (state, np.ones(4, np.float32))]:
        with pytest.raises(ValueError, match="differ"):
            graphs.call(cache, key, _body([]), bad_state, bad_x)


def test_cpu_runs_the_body_and_caches_nothing(flagship):
    x = _audio((1, 512), 2)
    flagship.pitchshift_fn(flagship.init_state(), x)
    flagship.pitchshift_streams(flagship.init_streams(2), _audio((2, 512), 3))
    assert flagship._graphs == {}
    stream_ola(flagship, x, 256)
    (run,) = flagship._stream_ola_fns.values()
    assert isinstance(run, graphs.Program) and run._replay is None


# ---------------------------------------------------------------------------
# the wrappers' entries
# ---------------------------------------------------------------------------


def test_entry_keys(stand_in, flagship):
    """(entry, B, T, precision, device, weights_version): what the JAX
    package makes static, and the bank's version."""
    s = flagship.init_state()
    flagship.pitchshift_fn(s, _audio((1, 512), 4))
    flagship.pitchshift_fn(s, _audio((3, 1, 512), 5))
    flagship.pitchshift_fn(s, _audio((1, 1024), 6))
    flagship.pitchshift_streams(flagship.init_streams(2), _audio((2, 512), 7))
    assert set(flagship._graphs) == {
        ("pitchshift_fn", 1, 512, "highest", CPU, 0),
        ("pitchshift_fn", 3, 512, "highest", CPU, 0),
        ("pitchshift_fn", 1, 1024, "highest", CPU, 0),
        ("pitchshift_streams", 2, 512, "highest", CPU, 0)}
    assert stand_in.events == ["capture"] * 4
    ta = PQMFPitchShiftWrapperTA(100, 8, 2048, precision="bf16x3",
                                 shifts_in_semitones=TA_SHIFTS8, device="cpu")
    ta.pitchshifter(_audio((2, 1, 2048), 8))
    assert set(ta._graphs) == {("pitchshifter", 2, 2048, "bf16x3", CPU, 0)}


@pytest.mark.parametrize("B", [1, 3])
def test_pitchshift_fn_replays_equal_the_eager_body(stand_in, flagship, B):
    """Four carried blocks: the replays equal the eager body bit for bit,
    and no later call changes a tensor an earlier one returned (the
    caller's old states included)."""
    blocks = [_audio((B, 1, 512) if B > 1 else (1, 512), 10 + i)
              for i in range(4)]
    se = sg = flagship.init_state()
    kept = []
    for blk in blocks:
        se, ye = flagship._pitchshift_fn_eager(se, torch.from_numpy(blk))
        sg, yg = flagship.pitchshift_fn(sg, blk)
        torch.testing.assert_close(yg, ye, rtol=0, atol=0)
        torch.testing.assert_close(sg["prev_tail"], se["prev_tail"], rtol=0,
                                   atol=0)
        kept.append((sg, yg, sg["prev_tail"].clone(), yg.clone()))
    assert stand_in.events == ["capture"] + ["replay"] * 3
    for state, y, tail, y_copy in kept:
        torch.testing.assert_close(state["prev_tail"], tail, rtol=0, atol=0)
        torch.testing.assert_close(y, y_copy, rtol=0, atol=0)


def test_pitchshift_facade_carries_state_through_replays(stand_in, flagship):
    eager = PQMFPitchShiftWrapper(70, 4, 512, shifts_in_semitones=SHIFTS4,
                                  device="cpu")
    state = eager.init_state()
    for i in range(3):
        blk = _audio((1, 512), 20 + i)
        state, want = eager._pitchshift_fn_eager(state, torch.from_numpy(blk))
        torch.testing.assert_close(flagship.pitchshift(blk), want, rtol=0,
                                   atol=0)


def test_pitchshift_streams_replays_equal_the_eager_body(stand_in, flagship):
    se = sg = flagship.init_streams(3)
    for i in range(3):
        x = torch.from_numpy(_audio((3, 512), 30 + i))
        se, ye = flagship._pitchshift_streams_eager(se, x)
        sg, yg = flagship.pitchshift_streams(sg, x)
        torch.testing.assert_close(yg, ye, rtol=0, atol=0)
        torch.testing.assert_close(sg["prev_tail"], se["prev_tail"], rtol=0,
                                   atol=0)


@pytest.mark.parametrize("B", [1, 2])
def test_ta_pitchshifter_replays_equal_the_eager_body(stand_in, B):
    ta = PQMFPitchShiftWrapperTA(100, 8, 2048, shifts_in_semitones=TA_SHIFTS8,
                                 device="cpu")
    outs = []
    for i in range(3):
        x = torch.from_numpy(_audio((B, 1, 2048), 40 + i))
        y = ta.pitchshifter(x)
        torch.testing.assert_close(y, ta._pitchshifter_eager(x), rtol=0,
                                   atol=0)
        outs.append((y, y.clone()))
    assert all(torch.equal(a, b) for a, b in outs)


def test_set_weights_evicts_the_old_graphs(stand_in, flagship):
    x = _audio((1, 512), 50)
    s = flagship.init_state()
    flagship.pitchshift_fn(s, x)
    flagship.pitchshift_streams(flagship.init_streams(2), _audio((2, 512), 51))
    old = flagship.pitchshift_fn(s, x)[1]
    assert len(flagship._graphs) == 2
    bank = _scaled_bank(flagship.pqmf)
    flagship.pqmf.set_weights(*bank)
    new = flagship.pitchshift_fn(s, x)[1]
    assert list(flagship._graphs) == [
        ("pitchshift_fn", 1, 512, "highest", CPU, 1)]
    fresh = PQMFPitchShiftWrapper(70, 4, 512, shifts_in_semitones=SHIFTS4,
                                  device="cpu")
    fresh.pqmf.set_weights(*bank)
    torch.testing.assert_close(new, fresh.pitchshift_fn(s, x)[1], rtol=0,
                               atol=0)
    assert not torch.allclose(new, old)


@pytest.mark.parametrize("C", [1, 2])
def test_stream_ola_replays_equal_the_eager_harness(stand_in, flagship, C):
    x = _audio((C, 1500), 60 + C)
    first = stream_ola(flagship, x, 256)
    (run,) = flagship._stream_ola_fns.values()
    second = stream_ola(flagship, x, 256)
    third = stream_ola(flagship, _audio((C, 1500), 70), 256)
    assert stand_in.events == ["capture", "replay", "replay"]
    eager = run.fn(torch.from_numpy(x))
    for a, b in zip(first + second, eager + eager):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(third[0], second[0])
    # the one graph carries every block's launches: none on the CPU
    assert all(v == 0 for c in run.launches for v in c.values())


def test_dropped_wrapper_is_collected(stand_in):
    """Programs and their graphs live on the wrapper; the wrapper -> cache
    -> program -> body -> wrapper cycle is ordinary garbage."""
    w = PQMFPitchShiftWrapper(70, 4, 256, shifts_in_semitones=[1, -1, 2, -2],
                              device="cpu")
    x = _audio((1, 1000), 80)
    stream_ola(w, x, 256)
    stream_ola(w, x, 256)
    w.pitchshift_fn(w.init_state(), x[:, :256])
    assert len(w._stream_ola_fns) == 1
    ref = weakref.ref(w)
    del w
    gc.collect()
    assert ref() is None


# ---------------------------------------------------------------------------
# the plain wrapper's process
# ---------------------------------------------------------------------------


@pytest.fixture
def bank():
    return PQMFWrapper(70, 4, 512, device="cpu")


def test_cpu_process_is_the_eager_round_trip(bank):
    """On the CPU ``process`` runs its body and caches nothing: it is
    (inverse(forward(x)), forward(x)) bit for bit."""
    x = _audio((1, 512), 90)
    rec, sub = bank.process(x)
    want = bank.forward(x)
    torch.testing.assert_close(sub, want, rtol=0, atol=0)
    torch.testing.assert_close(rec, bank.inverse(want), rtol=0, atol=0)
    assert bank._graphs == {}


@pytest.mark.parametrize("B", [1, 3])
def test_process_replays_equal_the_eager_body(stand_in, bank, B):
    """Four blocks: the first runs the body and captures it, the others
    replay; each equals the eager body bit for bit, and no later call
    changes what an earlier one returned."""
    kept = []
    for i in range(4):
        blk = _audio((B, 1, 512) if B > 1 else (1, 512), 91 + i)
        got = bank.process(blk)
        want = bank._process_eager(torch.from_numpy(blk))
        for g, e in zip(got, want):
            torch.testing.assert_close(g, e, rtol=0, atol=0)
        kept.append([(g, g.clone()) for g in got])
    assert stand_in.events == ["capture"] + ["replay"] * 3
    assert list(bank._graphs) == [("process", B, 512, "highest", CPU, 0)]
    assert all(torch.equal(g, c) for pairs in kept for g, c in pairs)


def test_process_keys_and_set_weights(stand_in, bank):
    """A graph per (B, T, precision, device, weights_version); a new bank
    evicts the old graphs, and the next call equals a fresh wrapper's on
    that bank."""
    x = _audio((1, 512), 100)
    bank.process(_audio((1, 1024), 101))
    old = bank.process(x)
    assert set(bank._graphs) == {("process", 1, 1024, "highest", CPU, 0),
                                 ("process", 1, 512, "highest", CPU, 0)}
    params = _scaled_bank(bank.pqmf)
    bank.pqmf.set_weights(*params)
    new = bank.process(x)
    assert list(bank._graphs) == [("process", 1, 512, "highest", CPU, 1)]
    fresh = PQMFWrapper(70, 4, 512, device="cpu")
    fresh.pqmf.set_weights(*params)
    for n, f, o in zip(new, fresh.process(x), old):
        torch.testing.assert_close(n, f, rtol=0, atol=0)
        assert not torch.allclose(n, o)
    tier = PQMFWrapper(70, 4, 512, precision="bf16x3", device="cpu")
    tier.process(x)
    assert list(tier._graphs) == [("process", 1, 512, "bf16x3", CPU, 0)]


@pytest.mark.parametrize("shape", [(2, 512), (1, 2, 512), (1, 1, 510),
                                   (1, 1, 32768)])
def test_process_refuses_a_bad_block_before_any_graph(stand_in, bank,
                                                      shape):
    """A block of the wrong shape, a length that does not divide into the
    bands or one past ``max_buffer_size`` raises ``forward``'s
    ``ValueError`` from ``process``, and nothing is run or captured."""
    x = np.zeros(shape, np.float32)
    with pytest.raises(ValueError) as want:
        bank.forward(x)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        bank.process(x)
    assert stand_in.events == [] and bank._graphs == {}


def test_export_traces_the_eager_process_node_for_node(bank):
    """The exported plain program is the eager body's (a trace of the
    graphed method would try a capture), node for node the program that
    ``inverse(forward(x))``, the body ``process`` ran before it was
    graphed, exports to."""
    module, args = ex._step_of(bank, 512)
    assert module.fn == bank._process_eager

    def old(x):
        sub = bank.forward(x)
        return bank.inverse(sub), sub

    def targets(ep):
        return [str(n.target) for n in ep.graph.nodes]

    got = torch.export.load(io.BytesIO(ex.export_stablehlo(bank, 512)))
    want = torch.export.export(ex._Step(old), args)
    assert targets(got) == targets(want)
    assert targets(got).count("pqmf_tpu_torch.analysis_conv.default") == 1
    assert targets(got).count("pqmf_tpu_torch.synthesis_conv.default") == 1


# ---------------------------------------------------------------------------
# a replay's copies in and out (``graphs.IO``)
# ---------------------------------------------------------------------------


def _reset_io():
    graphs.IO.update(bound=0, dispatched=0)


def test_a_strided_argument_is_made_contiguous_first(stand_in, flagship):
    """An argument a 1-D copy cannot read (a strided block) is made
    contiguous by a copy of its own, counted once in ``IO["dispatched"]``,
    and bound like the others; the replay equals the eager body bit for
    bit."""
    wide = torch.from_numpy(_audio((1, 1024), 110))
    state, _ = flagship.pitchshift_fn(flagship.init_state(),
                                      wide[:, :512].contiguous())
    x = wide[:, ::2]
    assert not x.is_contiguous()
    _reset_io()
    sg, yg = flagship.pitchshift_fn(state, x)
    assert graphs.IO == {"bound": 4, "dispatched": 1}
    assert stand_in.events == ["capture", "replay"]
    se, ye = flagship._pitchshift_fn_eager(state, x)
    torch.testing.assert_close(yg, ye, rtol=0, atol=0)
    torch.testing.assert_close(sg["prev_tail"], se["prev_tail"], rtol=0,
                               atol=0)


@pytest.mark.parametrize("entry,leaves", [("pitchshift_fn", 4),
                                          ("process", 3)])
def test_a_replay_binds_every_leaf(stand_in, flagship, bank, entry, leaves):
    """The flagship's block (the tail and x in, the tail and y out) and the
    bank's (x in, the round trip and the sub-bands out): every tensor leaf
    of every replay is carried by a copy node, none dispatched."""
    state = flagship.init_state()

    def block(i):
        nonlocal state
        x = _audio((1, 512), 120 + i)
        if entry == "process":
            return bank.process(x)
        state, y = flagship.pitchshift_fn(state, x)
        return y

    block(0)  # the eager call and the capture
    _reset_io()
    for i in range(1, 4):
        block(i)
    assert graphs.IO == {"bound": 3 * leaves, "dispatched": 0}
    (prog,) = (bank if entry == "process" else flagship)._graphs.values()
    assert prog._bound == leaves


def test_a_zero_element_leaf_replays(stand_in):
    """A leaf of no elements has no copy node: an empty argument and empty
    outputs replay (each output a fresh empty tensor), and only the other
    leaves are bound."""
    def body(x, empty):
        return x * 2.0, empty + 1.0, x[:0]

    cache, key, e = {}, ("body", 1, 4, "highest", CPU, 0), torch.zeros(0, 3)
    _reset_io()
    kept = []
    for i in range(3):
        x = torch.arange(4.0) + i
        y, z, w = graphs.call(cache, key, body, x, e)
        torch.testing.assert_close(y, x * 2.0, rtol=0, atol=0)
        assert z.shape == (0, 3) and w.shape == (0,)
        kept.append(z)
    assert stand_in.events == ["capture", "replay", "replay"]
    assert graphs.IO == {"bound": 4, "dispatched": 0}  # x in, y out
    assert kept[1] is not kept[2]


# ---------------------------------------------------------------------------
# csrc/graph_io.cu on the CPU
# ---------------------------------------------------------------------------

# What csrc/graph_io.cu uses of the CUDA runtime, for g++: a graph is a
# list of nodes (a kernel or a memcpy), an instantiated graph a copy of its
# memcpy parameters, and a launch runs its copies in order with memcpy.
# ``emu_*`` build graphs from Python and read what a launch did.
_EMU_GRAPHS = r"""
#pragma once
#include <cstddef>
#include <cstring>
#include <vector>
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaMemcpyKind { cudaMemcpyDeviceToDevice = 3 };
enum cudaGraphNodeType { cudaGraphNodeTypeKernel = 0,
                         cudaGraphNodeTypeMemcpy = 1 };
struct cudaPitchedPtr { void* ptr; size_t pitch, xsize, ysize; };
struct cudaPos { size_t x, y, z; };
struct cudaExtent { size_t width, height, depth; };
typedef struct cudaArray* cudaArray_t;
struct cudaMemcpy3DParms {
  cudaArray_t srcArray; cudaPos srcPos; cudaPitchedPtr srcPtr;
  cudaArray_t dstArray; cudaPos dstPos; cudaPitchedPtr dstPtr;
  cudaExtent extent; cudaMemcpyKind kind; };
struct EmuNode { cudaGraphNodeType type; cudaMemcpy3DParms p; };
struct EmuGraph { std::vector<EmuNode*> nodes; };
struct EmuExec { EmuGraph* g; std::vector<cudaMemcpy3DParms> p;
                 int sets = 0, launches = 0; };
typedef EmuGraph* cudaGraph_t;
typedef EmuNode* cudaGraphNode_t;
typedef EmuExec* cudaGraphExec_t;
inline cudaError_t cudaGraphGetNodes(cudaGraph_t g, cudaGraphNode_t* nodes,
                                     size_t* n) {
  if (nodes)
    for (size_t i = 0; i < *n && i < g->nodes.size(); ++i)
      nodes[i] = g->nodes[i];
  *n = g->nodes.size();
  return cudaSuccess;
}
inline cudaError_t cudaGraphNodeGetType(cudaGraphNode_t n,
                                        cudaGraphNodeType* t) {
  *t = n->type;
  return cudaSuccess;
}
inline cudaError_t cudaGraphMemcpyNodeGetParams(cudaGraphNode_t n,
                                                cudaMemcpy3DParms* p) {
  *p = n->p;
  return cudaSuccess;
}
inline cudaError_t cudaGraphExecMemcpyNodeSetParams1D(
    cudaGraphExec_t e, cudaGraphNode_t node, void* dst, const void* src,
    size_t count, cudaMemcpyKind kind) {
  for (size_t i = 0; i < e->g->nodes.size(); ++i)
    if (e->g->nodes[i] == node) {
      cudaMemcpy3DParms& p = e->p[i];
      if (node->type != cudaGraphNodeTypeMemcpy || p.extent.height != 1 ||
          count != p.extent.width || kind != p.kind)
        return cudaErrorInvalidValue;
      p.srcPtr.ptr = (void*)src;
      p.dstPtr.ptr = dst;
      p.srcPos.x = p.dstPos.x = 0;
      ++e->sets;
      return cudaSuccess;
    }
  return cudaErrorInvalidValue;
}
inline cudaError_t cudaGraphLaunch(cudaGraphExec_t e, cudaStream_t) {
  for (size_t i = 0; i < e->g->nodes.size(); ++i)
    if (e->g->nodes[i]->type == cudaGraphNodeTypeMemcpy) {
      const cudaMemcpy3DParms& p = e->p[i];
      std::memcpy((char*)p.dstPtr.ptr + p.dstPos.x,
                  (char*)p.srcPtr.ptr + p.srcPos.x,
                  p.extent.width * p.extent.height);
    }
  ++e->launches;
  return cudaSuccess;
}
extern "C" {
EmuGraph* emu_graph() { return new EmuGraph; }
void emu_node(EmuGraph* g, int memcpy, void* src, void* dst, size_t bytes,
              size_t rows) {
  EmuNode* n = new EmuNode{};
  n->type = memcpy ? cudaGraphNodeTypeMemcpy : cudaGraphNodeTypeKernel;
  n->p.srcPtr.ptr = src;
  n->p.dstPtr.ptr = dst;
  n->p.extent = {bytes, rows, 1};
  n->p.kind = cudaMemcpyDeviceToDevice;
  g->nodes.push_back(n);
}
EmuExec* emu_instantiate(EmuGraph* g) {
  EmuExec* e = new EmuExec;
  e->g = g;
  for (EmuNode* n : g->nodes) e->p.push_back(n->p);
  return e;
}
int emu_sets(EmuExec* e) { return e->sets; }
int emu_launches(EmuExec* e) { return e->launches; }
}
"""


@pytest.fixture(scope="module")
def emulated_graphs(tmp_path_factory):
    """``csrc/graph_io.cu`` built with g++ against the emulated runtime,
    bound as the card's library is (``_build.bind_graph_io``)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the emulated CUDA source")
    from pqmf_tpu_torch.kernels import _build

    d = tmp_path_factory.mktemp("graph_io_emulated")
    (d / "cuda_runtime.h").write_text(_EMU_GRAPHS)
    src = Path(graphs.__file__).parent / "csrc" / "graph_io.cu"
    (d / "g.cpp").write_text(src.read_text())
    subprocess.run([gxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-w",
                    f"-I{d}", "-o", str(d / "g.so"), str(d / "g.cpp")],
                   check=True, capture_output=True)
    lib = _build.bind_graph_io(ctypes.CDLL(str(d / "g.so")))
    p = ctypes.c_void_p
    lib.emu_graph.restype = p
    lib.emu_node.argtypes = [p, ctypes.c_int, p, p, ctypes.c_size_t,
                             ctypes.c_size_t]
    lib.emu_instantiate.argtypes = [p]
    lib.emu_instantiate.restype = p
    lib.emu_sets.argtypes = lib.emu_launches.argtypes = [p]
    lib.pqmf_error_string = lambda err: b"emulated error"
    return lib


def _buf(values):
    return torch.tensor(values, dtype=torch.float32)


def test_emulated_replay_re_points_the_copies_it_binds(emulated_graphs):
    """``graphs._plan`` finds each copy by its addresses among the 1-D
    memcpy nodes (a kernel node and a 2-D copy are passed over, and 70
    other copies make the node walk ask twice); a replay re-points only a
    node whose pair changed and launches once, and a launch copies from the
    new sources into the new destinations."""
    lib = emulated_graphs
    arg, static = _buf([1, 2, 3, 4]), _buf([0] * 4)
    res, out = _buf([5, 6]), _buf([0] * 2)
    rows = _buf([0] * 4)  # the 2-D copy's destination: res in two rows
    others = [(_buf([float(i)]), _buf([0])) for i in range(70)]
    g = lib.emu_graph()
    lib.emu_node(g, 0, None, None, 0, 1)
    lib.emu_node(g, 1, arg.data_ptr(), static.data_ptr(), 16, 1)
    lib.emu_node(g, 1, res.data_ptr(), rows.data_ptr(), 4, 2)
    for s, t in others:
        lib.emu_node(g, 1, s.data_ptr(), t.data_ptr(), 4, 1)
    lib.emu_node(g, 1, res.data_ptr(), out.data_ptr(), 8, 1)
    e = lib.emu_instantiate(g)
    copies = [(arg.data_ptr(), static.data_ptr(), 16),
              (res.data_ptr(), out.data_ptr(), 8)]
    plan = graphs._plan(lib, g, e, copies)
    assert plan.n == 2 and list(plan.bytes[:2]) == [16, 8]
    at = ctypes.addressof(plan)
    assert lib.pqmf_graph_replay(at, None) == 0
    assert lib.emu_sets(e) == 0 and torch.equal(static, arg)
    new_arg, new_out = _buf([9, 8, 7, 6]), _buf([0] * 2)
    plan.next[0], plan.next[3] = new_arg.data_ptr(), new_out.data_ptr()
    for launches in (2, 3):
        assert lib.pqmf_graph_replay(at, None) == 0
        assert lib.emu_sets(e) == 2 and lib.emu_launches(e) == launches
    assert torch.equal(static, new_arg) and torch.equal(new_out, res)
    assert all(torch.equal(s, t) for s, t in others)


def test_emulated_plan_refuses_a_copy_it_cannot_tell_apart(emulated_graphs):
    """A copy the graph holds twice (the body copying from the same source
    into the same freed buffer) or not at all is refused: no node is bound
    by guess."""
    lib = emulated_graphs
    a, b = _buf([1, 2]), _buf([0, 0])
    g = lib.emu_graph()
    for _ in range(2):
        lib.emu_node(g, 1, a.data_ptr(), b.data_ptr(), 8, 1)
    e = lib.emu_instantiate(g)
    with pytest.raises(RuntimeError, match="holds 2 copy nodes"):
        graphs._plan(lib, g, e, [(a.data_ptr(), b.data_ptr(), 8)])
    with pytest.raises(RuntimeError, match="holds 0 copy nodes"):
        graphs._plan(lib, g, e, [(a.data_ptr(), b.data_ptr(), 4)])
