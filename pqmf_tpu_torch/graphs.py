"""CUDA graphs: the port's counterpart of ``jax.jit``.

The JAX package runs each serving step as one XLA program, compiled once
per static geometry: the flagship step (``pqmf_tpu/pipelines.py:182``),
the torchaudio variant's block (``_pitchshifter_jit``, ``:1007``), the
whole block-streaming harness (``_stream_ola_program``, ``:741-850``),
``scan_blocks`` (``lax.scan``, ``pqmf_tpu/streaming.py:543``), the train
step (``pqmf_tpu/parallel/training.py:193``) and the reloaded artifact
program (``pqmf_tpu/export.py:299-325``).
Here an eager step body is captured once per static key as a
``torch.cuda.CUDAGraph`` and replayed from then on, so a step costs one
graph launch on the host instead of one Python dispatch per op. The graph
replays exactly the launches the eager body made: the hand-written
kernels and the plain ops, bit for bit (``torch.compile`` would generate
the body anew and is not used).

- The first call of a key runs the body eagerly and returns its result.
  That run is the warm-up: it fills the wrappers' plan caches, the cached
  windows and DFT bases, builds the kernel library and sets the kernels'
  shared-memory attributes. Then the body is captured over static copies
  of the arguments, in a private memory pool.
- A later call copies its arguments into the static buffers, replays, and
  returns clones of the static outputs: a replay never changes a tensor
  that an earlier call returned, and no static buffer is handed out.
- The kernels' launch counters (``cached_conv.LAUNCHES``,
  ``polyphase.LAUNCHES``, ``middle.LAUNCHES``) count device launches: the
  capture adds nothing, and each replay adds the counts the capture
  recorded. So do the conv kernels' count by tier
  (``cached_conv.KERNELS``) and the DFT operands' roundings
  (``ops.stft.ROUNDED``), which ``Program.launches`` leaves out.
- Under a running ``torch.profiler`` a replay records three host spans:
  ``pqmf.graph.copy_in`` (the arguments' checks and copies into the
  static buffers), ``pqmf.graph.launch`` (the replay and the counters)
  and ``pqmf.graph.clone_out`` (the outputs' clones); a capture records
  ``pqmf.graph.capture``. The captured body itself holds no span.
- On the CPU nothing is captured: the body runs. On CUDA there is no
  fallback: a capture or replay that fails raises with its error.
- Programs nest: one called while another capture runs on the current
  stream (``scan_blocks`` over the graphed ``pitchshift_fn``) runs its
  eager body and records nothing, and the outer capture records its
  launches.
- A step over a (data, band) mesh holds collectives: the band
  ``all_reduce`` of the synthesis, the data-parallel gradient's. A graph
  captures them only over NCCL (``group=``): the communicator is made,
  and used once on the capture stream, before the capture, and
  :data:`COLLECTIVES` counts them as the launch counters count kernels.
  Over any other backend (gloo) a program on the card raises; the step's
  ``.eager`` form runs without a graph.

The graphs live where the caller keeps them: on the wrapper instance
(``wrapper._graphs``, ``wrapper._stream_ola_fns``), on the
``StreamingPQMF`` (``scan_blocks``), on the ``TrainState`` (the train
step) and in the loaded program's closure, keyed by everything the JAX
package makes static and, where a PQMF's banks are read, by its
``weights_version``: a graph holds the addresses of the banks it read, and
``set_weights`` installs new ones, so an entry of an older version is
evicted (as ``pqmf_tpu/pipelines.py:838-845`` evicts its programs) and its
pool freed. A dropped owner frees its graphs with it.
"""

from __future__ import annotations

import gc
import time

import torch
from torch.utils import _pytree as pytree

from pqmf_tpu_torch.kernels import cached_conv as cc
from pqmf_tpu_torch.kernels import middle as pm
from pqmf_tpu_torch.kernels import polyphase as pk
from pqmf_tpu_torch.ops import stft as S
from pqmf_tpu_torch.utils.profiling import span

__all__ = ["Program", "call", "COLLECTIVES", "reset_collectives"]

# the collectives the sharded steps run (``streaming.band_all_reduce``,
# ``parallel.training``'s gradient and loss all-reduce), counted like the
# kernels' launches: a capture adds nothing, a replay what it recorded
COLLECTIVES = {"band_all_reduce": 0, "grad_all_reduce": 0}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


_COUNTERS = (cc.LAUNCHES, pk.LAUNCHES, pm.LAUNCHES)
# every counter a replay adds to: the launches (``Program.launches``), the
# conv kernels by tier, the rounded DFT operands, the collectives
_ALL = _COUNTERS + (cc.KERNELS, S.ROUNDED, COLLECTIVES)


def _counts() -> list:
    return [dict(c) for c in _ALL]


def _graphed(device: torch.device) -> bool:
    """Whether a body on ``device`` is captured (CUDA) or run (CPU)."""
    return device.type == "cuda"


def _capturing() -> bool:
    """Whether a capture is running on the current stream: a program
    called inside it runs its body into the outer graph."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


_STREAMS: dict = {}


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """One side stream a card for every capture on it. cuBLAS allocates a
    workspace (32 MiB on an H100) at the first matmul on a stream; one
    matmul on the new stream, outside any capture, keeps that workspace
    out of the first graph's private pool, which it would otherwise hold
    after the graph is freed."""
    s = _STREAMS.get(device.index)
    if s is None:
        s = torch.cuda.Stream(device=device)
        s.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(s):
            a = torch.ones((8, 8), device=device)
            a @ a
        torch.cuda.current_stream(device).wait_stream(s)
        _STREAMS[device.index] = s
    return s


_WARM_GROUPS: set = set()


def _check_group(group, device: torch.device) -> None:
    """A graph on the card captures collectives over NCCL only; before the
    first capture over ``group`` its communicator is made and used once
    on the capture stream (as ``_capture_stream`` does for cuBLAS), so the
    capture records the collective and not the set-up."""
    if group is None or not _graphed(device):
        return
    import torch.distributed as dist

    backend = dist.get_backend(group)
    if backend != "nccl":
        raise RuntimeError(
            f"a CUDA graph captures collectives over NCCL only, this "
            f"step's group runs on {backend!r}: call the step's .eager form")
    if id(group) in _WARM_GROUPS:
        return
    s = _capture_stream(device)
    with torch.cuda.device(device), torch.cuda.stream(s):
        dist.all_reduce(torch.zeros(1, device=device), group=group)
    torch.cuda.synchronize(device)
    _WARM_GROUPS.add(id(group))


def _capture(fn, args, device: torch.device):
    """Capture ``fn(*args)`` as a CUDA graph on ``device``. Returns
    (replay, static outputs, stats): capture and instantiate ms, the bytes
    of the segments the graph's private pool took and of the tensors still
    alive in it (the static outputs).

    Python's garbage collector is held off during the capture: a dropped
    wrapper is a reference cycle, and collecting it there would destroy
    its graphs and free their pools inside another graph's capture."""
    g = torch.cuda.CUDAGraph(keep_graph=True)
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.device(device):
            t0 = time.perf_counter()
            with torch.cuda.graph(g, stream=_capture_stream(device)):
                reserved = torch.cuda.memory_reserved(device)
                allocated = torch.cuda.memory_allocated(device)
                out = fn(*args)
            t1 = time.perf_counter()
    finally:
        if collecting:
            gc.enable()
    with torch.cuda.device(device):
        g.instantiate()
        t2 = time.perf_counter()
        stats = {"capture_ms": (t1 - t0) * 1e3,
                 "instantiate_ms": (t2 - t1) * 1e3,
                 "pool_bytes": torch.cuda.memory_reserved(device) - reserved,
                 "output_bytes":
                     torch.cuda.memory_allocated(device) - allocated}

    def replay():
        with torch.cuda.device(device):
            g.replay()

    return replay, out, stats


class Program:
    """One step body over one static geometry: eager on the first call
    (then captured), replayed after; eager on the CPU and inside another
    program's capture. ``group``: the process group of the collectives
    the body runs, if any (NCCL only on the card)."""

    def __init__(self, fn, device: torch.device, group=None):
        self.fn = fn
        self.device = device
        self.group = group
        self.stats = None        # capture ms, instantiate ms, pool bytes
        self.launches = None     # the kernel launches one replay makes
        self.collectives = None  # and the collectives (COLLECTIVES' keys)
        self._replay = None
        self._adds = ()          # (counter, key, count) a replay adds
        self._static_in = None
        self._static_out = None

    def __call__(self, *args):
        if not _graphed(self.device) or _capturing():
            return self.fn(*args)
        _check_group(self.group, self.device)
        if self._replay is None:
            out = self.fn(*args)
            with span("pqmf.graph.capture"):
                self._record(args)
            return out
        return self._run(args)

    def _record(self, args):
        leaves, spec = pytree.tree_flatten(args)
        static = [a.clone() if isinstance(a, torch.Tensor) else a
                  for a in leaves]
        before = _counts()
        try:
            replay, out, stats = _capture(
                self.fn, pytree.tree_unflatten(static, spec), self.device)
        finally:
            after = _counts()
            for c, b in zip(_ALL, before):
                c.update(b)
        made = [{k: a[k] - b[k] for k in a} for a, b in zip(after, before)]
        self.launches = made[:len(_COUNTERS)]
        self.collectives = made[-1]
        self._adds = tuple((c, k, n) for c, counts in zip(_ALL, made)
                           for k, n in counts.items() if n)
        self._replay, self.stats = replay, stats
        self._static_in = (static, spec)
        self._static_out = out

    def _run(self, args):
        with span("pqmf.graph.copy_in"):
            self._copy_in(args)
        with span("pqmf.graph.launch"):
            self._replay()
            for c, k, n in self._adds:
                c[k] += n
        with span("pqmf.graph.clone_out"):
            return pytree.tree_map(
                lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                self._static_out)

    def _copy_in(self, args):
        static, spec = self._static_in
        leaves, given = pytree.tree_flatten(args)
        if given != spec:
            raise ValueError(f"arguments {given} differ from the captured "
                             f"step's {spec}")
        for s, a in zip(static, leaves):
            if not isinstance(s, torch.Tensor):
                if a != s:
                    raise ValueError(f"argument {a!r} differs from the "
                                     f"captured step's {s!r}")
                continue
            if (not isinstance(a, torch.Tensor) or a.shape != s.shape
                    or a.dtype != s.dtype or a.device != s.device):
                raise ValueError(
                    "an argument differs from the captured step's "
                    f"{s.dtype} {tuple(s.shape)} on {s.device}: " + (
                        f"{a.dtype} {tuple(a.shape)} on {a.device}"
                        if isinstance(a, torch.Tensor) else repr(a)))
            s.copy_(a)


def call(cache: dict, key: tuple, fn, *args, group=None):
    """``fn(*args)`` through the program of ``key`` in ``cache`` (a dict on
    the wrapper; ``key[-1]`` is the PQMF's ``weights_version``). Entries
    of another version are evicted when a key is first seen. On the CPU,
    and inside another program's capture, ``fn`` runs and nothing is
    cached. ``group``: as :class:`Program`'s."""
    device = key[-2]
    if not _graphed(device) or _capturing():
        return fn(*args)
    prog = cache.get(key)
    if prog is None:
        for stale in [k for k in cache if k[-1] != key[-1]]:
            del cache[stale]
        prog = cache[key] = Program(fn, device, group)
    return prog(*args)
