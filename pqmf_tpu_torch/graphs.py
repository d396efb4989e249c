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
  shared-memory attributes. Then the body is captured with its copies in
  and out: each tensor argument copied into a buffer of the graph's
  private pool, which the body reads, and each tensor output (made dense
  first) copied out of the pool. PyTorch records each of these copies as
  a 1-D memcpy node, found after instantiation by its addresses.
- A later call reads its arguments' leaves, checks them against the
  captured ones, allocates its outputs afresh and makes one call into C
  (``csrc/graph_io.cu``): that re-points each argument's node at the
  caller's tensor and each output's node at the fresh one, and launches
  the graph. No copy or clone is dispatched, a replay never changes a
  tensor that an earlier call returned, and no buffer of the graph is
  handed out. Only an argument the 1-D copy cannot read (not contiguous)
  is made contiguous first, by a copy of its own; a leaf of no elements
  has no node. :data:`IO` counts both kinds. A replayed body draws no
  random numbers: the launch does not advance PyTorch's generator.
- The kernels' launch counters (``cached_conv.LAUNCHES``,
  ``polyphase.LAUNCHES``, ``middle.LAUNCHES``) count device launches: the
  capture adds nothing, and each replay adds the counts the capture
  recorded. So do the conv kernels' count by tier
  (``cached_conv.KERNELS``), the round trips that run in thread-block
  clusters (``cached_conv.CLUSTERS``) and the DFT operands' roundings
  (``ops.stft.ROUNDED``), which ``Program.launches`` leaves out.
- Under a running ``torch.profiler`` a replay records three host spans:
  ``pqmf.graph.copy_in`` (reading and checking the arguments, making a
  non-contiguous one contiguous, allocating the outputs),
  ``pqmf.graph.launch`` (the call that re-points the copy nodes and
  launches the graph, and the counters) and ``pqmf.graph.clone_out``
  (the outputs' structure built around the fresh tensors); a capture
  records ``pqmf.graph.capture``. The captured body itself holds no span.
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

import ctypes
import gc
import time

import torch
from torch.utils import _pytree as pytree

from pqmf_tpu_torch.kernels import cached_conv as cc
from pqmf_tpu_torch.kernels import middle as pm
from pqmf_tpu_torch.kernels import polyphase as pk
from pqmf_tpu_torch.ops import stft as S
from pqmf_tpu_torch.utils.profiling import span

__all__ = ["Program", "call", "COLLECTIVES", "IO", "reset_collectives"]

# the collectives the sharded steps run (``streaming.band_all_reduce``,
# ``parallel.training``'s gradient and loss all-reduce), counted like the
# kernels' launches: a capture adds nothing, a replay what it recorded
COLLECTIVES = {"band_all_reduce": 0, "grad_all_reduce": 0}

# a replay's tensor leaves: ``bound``, the arguments and outputs that a
# copy node of the graph carried, re-pointed at the call's tensor;
# ``dispatched``, the arguments made contiguous by a copy of their own
# first (they are bound too)
IO = {"bound": 0, "dispatched": 0}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


_COUNTERS = (cc.LAUNCHES, pk.LAUNCHES, pm.LAUNCHES)
# every counter a replay adds to: the launches (``Program.launches``), the
# conv kernels by tier, the clustered round trips, the rounded DFT
# operands, the collectives (last: ``Program.collectives``)
_ALL = _COUNTERS + (cc.KERNELS, cc.CLUSTERS, S.ROUNDED, COLLECTIVES)


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


class _Differ(Exception):
    """A call's arguments are not of the captured structure."""


def _tree(obj):
    """``obj``'s structure, compiled once: tuples, lists and dicts walked
    here, any other node through ``torch.utils._pytree``, in its leaf
    order. Returns (read, build, tensors): ``read(o, out)`` appends the
    tensor leaves of ``o`` to ``out``, raising ``_Differ`` where ``o`` has
    another structure and ``ValueError`` where a leaf that is no tensor in
    ``obj`` differs; ``build(it)`` makes ``obj``'s structure with its
    tensor leaves taken from the iterator ``it`` and its other leaves as
    ``obj`` has them; ``tensors`` are ``obj``'s tensor leaves in order."""
    tensors = []

    def take(v, out):
        out.append(v)

    def compile_(o):
        t = type(o)
        if t is tuple or t is list:
            kids = [compile_(v) for v in o]
            n = len(kids)

            def read(v, out):
                if type(v) is not t or len(v) != n:
                    raise _Differ
                for (r, _), w in zip(kids, v):
                    r(w, out)
            return read, lambda it: t([b(it) for _, b in kids])
        if t is dict:
            keys = list(o)
            names = set(keys)
            kids = [compile_(o[k]) for k in keys]

            def read(v, out):
                if type(v) is not dict or v.keys() != names:
                    raise _Differ
                for k, (r, _) in zip(keys, kids):
                    r(v[k], out)
            return read, lambda it: {k: b(it) for k, (_, b) in zip(keys,
                                                                    kids)}
        if isinstance(o, torch.Tensor):
            tensors.append(o)
            return take, next
        leaves, spec = pytree.tree_flatten(o)
        if spec.is_leaf():
            def read(v, out):
                if v is not o and (type(v) is not t or v != o):
                    raise ValueError(f"argument {v!r} differs from the "
                                     f"captured step's {o!r}")
            return read, lambda it: o
        kids = [compile_(v) for v in leaves]

        def read(v, out):
            got, given = pytree.tree_flatten(v)
            if given != spec:
                raise _Differ
            for (r, _), w in zip(kids, got):
                r(w, out)
        return read, lambda it: pytree.tree_unflatten(
            [b(it) for _, b in kids], spec)

    read, build = compile_(obj)
    return read, build, tensors


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


class _Plan(ctypes.Structure):
    """``csrc/graph_io.cu``'s ``pqmf_graph_plan``: the instantiated graph,
    its re-pointed copy nodes with each one's kind and bytes, the (source,
    destination) pairs the next launch copies and those the graph
    holds."""
    _fields_ = [("exec", ctypes.c_void_p), ("n", ctypes.c_int),
                ("nodes", ctypes.POINTER(ctypes.c_void_p)),
                ("kinds", ctypes.POINTER(ctypes.c_int)),
                ("bytes", ctypes.POINTER(ctypes.c_size_t)),
                ("next", ctypes.POINTER(ctypes.c_void_p)),
                ("held", ctypes.POINTER(ctypes.c_void_p))]


def _error(lib, fn: str, err: int) -> RuntimeError:
    return RuntimeError(
        f"{fn} failed: {lib.pqmf_error_string(err).decode()} ({err})")


def _plan(lib, graph: int, exec_: int, copies: list) -> _Plan:
    """The replay plan of ``copies`` ((source, destination, bytes) each),
    found among the graph's 1-D memcpy nodes by those addresses: each is
    exactly one node, or this raises."""
    cap = 64
    while True:
        nodes = (ctypes.c_void_p * cap)()
        kinds = (ctypes.c_int * cap)()
        src, dst = (ctypes.c_void_p * cap)(), (ctypes.c_void_p * cap)()
        nbytes, count = (ctypes.c_size_t * cap)(), ctypes.c_int()
        err = lib.pqmf_graph_copies(graph, cap, nodes, kinds, src, dst,
                                    nbytes, ctypes.byref(count))
        if err:
            raise _error(lib, "pqmf_graph_copies", err)
        if count.value <= cap:
            break
        cap = count.value
    found: dict = {}
    for k in range(count.value):
        found.setdefault((src[k] or 0, dst[k] or 0, nbytes[k]), []).append(k)
    n = len(copies)
    plan = _Plan(exec=exec_, n=n, nodes=(ctypes.c_void_p * n)(),
                 kinds=(ctypes.c_int * n)(), bytes=(ctypes.c_size_t * n)(),
                 next=(ctypes.c_void_p * (2 * n))(),
                 held=(ctypes.c_void_p * (2 * n))())
    for i, copy in enumerate(copies):
        at = found.get(copy, [])
        if len(at) != 1:
            raise RuntimeError(
                f"the captured graph holds {len(at)} copy nodes from "
                f"{copy[0]:#x} to {copy[1]:#x} of {copy[2]} bytes, not one")
        k = at[0]
        plan.nodes[i], plan.kinds[i], plan.bytes[i] = nodes[k], kinds[k], \
            nbytes[k]
        plan.next[2 * i] = plan.held[2 * i] = copy[0]
        plan.next[2 * i + 1] = plan.held[2 * i + 1] = copy[1]
    return plan


def _capture(fn, args, device: torch.device):
    """Capture ``fn(*args)`` (``args``: contiguous tensors) as a CUDA graph
    on ``device``, with its copies in and out as memcpy nodes (see the
    module's doc). Returns (replay, outputs, stats): ``replay(leaves,
    outs)`` re-points the nodes at the argument tensors ``leaves`` and the
    output tensors ``outs``, of the captured shapes, and launches the graph
    on the device's current stream; the outputs are the pool's copies;
    stats: capture and instantiate ms, the bytes of the segments the
    graph's private pool took and of the tensors still alive in it (the
    buffers the copies fill).

    Python's garbage collector is held off during the capture: a dropped
    wrapper is a reference cycle, and collecting it there would destroy
    its graphs and free their pools inside another graph's capture."""
    from pqmf_tpu_torch.kernels import _build

    lib = _build.load()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.device(device):
            index = torch.cuda.current_device()
            t0 = time.perf_counter()
            with torch.cuda.graph(g, stream=_capture_stream(device)):
                reserved = torch.cuda.memory_reserved(device)
                allocated = torch.cuda.memory_allocated(device)
                static = [a.clone() for a in args]
                out = fn(*static)
                _, build, outs = _tree(out)
                dense = [o.contiguous() for o in outs]
                copies = [o.clone() for o in dense]
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
    pairs = [*zip(args, static), *zip(dense, copies)]
    bound = [i for i, (a, _) in enumerate(pairs) if a.numel()]
    plan = _plan(lib, g.raw_cuda_graph(), g.raw_cuda_graph_exec(),
                 [(pairs[i][0].data_ptr(), pairs[i][1].data_ptr(),
                   pairs[i][0].numel() * pairs[i][0].element_size())
                   for i in bound])
    # the pointer each replay writes: an argument's source, an output's
    # destination, as (slot in plan.next, leaf)
    n_in = len(args)
    ins = [(2 * k, i) for k, i in enumerate(bound) if i < n_in]
    outs_at = [(2 * k + 1, i - n_in) for k, i in enumerate(bound)
               if i >= n_in]
    at, launch, nxt = ctypes.addressof(plan), lib.pqmf_graph_replay, plan.next
    stream = torch._C._cuda_getCurrentRawStream
    current = torch._C._cuda_getDevice

    def replay(leaves, outs):
        for slot, i in ins:
            nxt[slot] = leaves[i].data_ptr()
        for slot, j in outs_at:
            nxt[slot] = outs[j].data_ptr()
        if current() == index:
            err = launch(at, stream(index))
        else:
            with torch.cuda.device(index):
                err = launch(at, stream(index))
        if err:
            raise _error(lib, "pqmf_graph_replay", err)

    # the graph, its buffers and the plan live as long as the replay
    replay.held = (g, static, dense, plan)
    return replay, build(iter(copies)), stats


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
        self._spec = None        # the arguments' structure, for messages
        self._read = None        # the arguments' reader (``_tree``)
        self._ins = ()           # (shape, dtype, device) a tensor argument
        self._outs = ()          # (shape, strides, dtype, device) an output
        self._build = None       # the outputs' structure around them
        self._bound = 0          # the leaves a replay's copy nodes carry
        self._static_out = None

    def __call__(self, *args):
        if not _graphed(self.device) or _capturing():
            return self.fn(*args)
        return self._step(args)

    def _step(self, args):
        """A call on the card, outside any capture."""
        if self.group is not None:
            _check_group(self.group, self.device)
        if self._replay is None:
            out = self.fn(*args)
            with span("pqmf.graph.capture"):
                self._record(args)
            return out
        return self._run(args)

    def _record(self, args):
        read, build, tensors = _tree(args)
        placeholders = [t.clone(memory_format=torch.contiguous_format)
                        for t in tensors]

        def body(*leaves):
            return self.fn(*build(iter(leaves)))

        before = _counts()
        try:
            replay, out, stats = _capture(body, placeholders, self.device)
        finally:
            after = _counts()
            for c, b in zip(_ALL, before):
                c.update(b)
        made = [{k: a[k] - b[k] for k in a} for a, b in zip(after, before)]
        self.launches = made[:len(_COUNTERS)]
        self.collectives = made[-1]
        self._adds = tuple((c, k, n) for c, counts in zip(_ALL, made)
                           for k, n in counts.items() if n)
        _, self._build, outs = _tree(out)
        self._spec, self._read = pytree.tree_structure(args), read
        self._ins = tuple((t.shape, t.dtype, t.device) for t in tensors)
        self._outs = tuple((o.shape, o.stride(), o.dtype, o.device)
                           for o in outs)
        self._bound = sum(t.numel() > 0 for t in (*tensors, *outs))
        self._replay, self.stats = replay, stats
        self._static_out = out

    def _run(self, args):
        with span("pqmf.graph.copy_in"):
            leaves = self._leaves(args)
            outs = [torch.empty_strided(shape, stride, dtype=dtype,
                                        device=device)
                    for shape, stride, dtype, device in self._outs]
        with span("pqmf.graph.launch"):
            self._replay(leaves, outs)
            for c, k, n in self._adds:
                c[k] += n
            IO["bound"] += self._bound
        with span("pqmf.graph.clone_out"):
            return self._build(iter(outs))

    def _leaves(self, args) -> list:
        """The call's tensor arguments, checked against the captured ones;
        one that is not contiguous is replaced by a contiguous copy."""
        leaves = []
        try:
            self._read(args, leaves)
        except _Differ:
            raise ValueError(
                f"arguments {pytree.tree_structure(args)} differ from the "
                f"captured step's {self._spec}") from None
        for i, (a, (shape, dtype, device)) in enumerate(zip(leaves,
                                                            self._ins)):
            if (not isinstance(a, torch.Tensor) or a.shape != shape
                    or a.dtype != dtype or a.device != device):
                raise ValueError(
                    "an argument differs from the captured step's "
                    f"{dtype} {tuple(shape)} on {device}: " + (
                        f"{a.dtype} {tuple(a.shape)} on {a.device}"
                        if isinstance(a, torch.Tensor) else repr(a)))
            if not a.is_contiguous():
                leaves[i] = a.contiguous()
                IO["dispatched"] += 1
        return leaves


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
    return prog._step(args)
