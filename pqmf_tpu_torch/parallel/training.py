"""Differentiable filterbank, its fine-tuning, and the committed banks.

Counterpart of ``pqmf_tpu/parallel/training.py``. The modulated bank ``hk``
is a learnable leaf tensor: the polyphase analysis/synthesis matrices are
derived from it inside the loss by pure reshapes, so autograd reaches
``hk``, and :func:`finetune_filterbank` fine-tunes the designed bank's
steady-state reconstruction on white noise with Adam — the recipe behind
every committed bank (``pqmf_tpu/data/*.npz``, read by path: importing
``pqmf_tpu`` would import JAX).

No TPU kernel sits on the training path: the JAX package differentiates
its lax polyphase convs, and this module differentiates the port's plain
ops (``ops/filterbank.polyphase_forward`` / ``polyphase_inverse``), cuDNN
on the card, forward and backward in full f32 (:func:`loss_and_grad`). The
quality readout, :func:`streaming_roundtrip_snr`, runs
``StreamingPQMF.roundtrip``: one K3 launch at every committed band count,
M = 2 to 64.

On the card the train step is one CUDA graph (``graphs.py``), the port
of ``jax.jit(step)``: forward, backward and a capturable Adam, captured
once per batch geometry on the :class:`TrainState` and replayed every
step after (:func:`make_train_step`).

Over a (data, band) mesh (``mesh=``, ``parallel.sharding.make_mesh``) the
training is fully data-parallel, as the JAX package's: the batch splits
over every rank of the mesh (world = data x band), ``hk`` and Adam's
moments are replicated, each rank takes the gradient of its local loss,
and the mean gradient and loss are summed over the mesh with
``all_reduce`` before every rank takes the same Adam step (on the card
inside the step's CUDA graph, over NCCL). Every entry point runs on the
card unless the caller asks for ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from pqmf_tpu_torch import graphs
from pqmf_tpu_torch.ops import filterbank as fb
from pqmf_tpu_torch.streaming import StreamingPQMF, resolve_device
from pqmf_tpu_torch.utils.audio import read_wav
from pqmf_tpu_torch.utils.metrics import aligned_roundtrip_snr_db

__all__ = ["analysis_from_hk", "synthesis_from_hk", "reconstruction_loss",
           "make_finetune_loss", "loss_and_grad", "adam",
           "cosine_decay_schedule", "noise_batches", "finetune_filterbank",
           "worst_stopband_db", "roundtrip_snr", "streaming_roundtrip_snr",
           "TrainState", "make_train_step", "TrainablePQMF",
           "save_train_state", "load_train_state", "BANK_DIR",
           "load_pretrained_bank", "available_pretrained_banks"]

BANK_DIR = Path(__file__).resolve().parents[2] / "pqmf_tpu" / "data"


# ---------------------------------------------------------------------------
# The loss side
# ---------------------------------------------------------------------------


def analysis_from_hk(x: torch.Tensor, hk: torch.Tensor,
                     precision: str = "highest") -> torch.Tensor:
    """Differentiable polyphase analysis with the polyphase matrix derived
    from ``hk`` in the graph. x: [B, 1, T]; hk: [M, P]."""
    M, Pn = hk.shape
    hk_poly = hk.reshape(M, Pn // M, M).transpose(1, 2)
    return fb.reverse_half(fb.polyphase_forward(x, hk_poly, precision))


def synthesis_from_hk(x: torch.Tensor, hk: torch.Tensor,
                      precision: str = "highest") -> torch.Tensor:
    """Differentiable polyphase synthesis. x: [B, M, T']; hk: [M, P]."""
    M, Pn = hk.shape
    hk_ipoly = torch.flip(hk, (-1,)).reshape(M, Pn // M, M).permute(2, 0, 1)
    return fb.polyphase_inverse(fb.reverse_half(x), hk_ipoly, precision)


def reconstruction_loss(hk: torch.Tensor, x: torch.Tensor,
                        precision: str = "highest") -> torch.Tensor:
    """Round-trip MSE through the filterbank."""
    y = synthesis_from_hk(analysis_from_hk(x, hk, precision), hk, precision)
    return torch.mean((y - x) ** 2)


def make_finetune_loss(n_band: int, n_taps: int, trim: int | None = None,
                       stopband_weight: float = 1e-4, nfft: int = 2048):
    """The fine-tuning loss ``loss_fn(hk, x, precision)``: the round-trip
    MSE with ``trim`` samples (default: one filter length) cut from each
    edge, plus ``stopband_weight`` times the per-band stopband energy (the
    response more than one band-width outside the passband, through a
    matmul DFT of ``nfft`` points). The plain round-trip MSE is the wrong
    objective on short batches: the edge transients dominate it, and
    chasing them wrecks the interior and the stopband (see the JAX
    package's docstring for its measurements).

    Dtype-generic: the cos/sin DFT matrices hold float32-rounded values,
    cast to ``hk``'s dtype and device (the JAX package's f32 constants
    promote the same way under x64)."""
    M, Pn = n_band, n_taps
    t = trim if trim is not None else Pn
    w = np.linspace(0, np.pi, nfft // 2 + 1)
    n = np.arange(Pn)
    masks = np.stack([
        (w < k * np.pi / M - np.pi / M) | (w > (k + 1) * np.pi / M
                                           + np.pi / M)
        for k in range(M)])
    dft = (np.cos(np.outer(n, w)).astype(np.float32),
           np.sin(np.outer(n, w)).astype(np.float32))
    consts = {}  # (dtype, device) -> (Cm, Sm, masks)

    def loss_fn(hk, x, precision="highest"):
        if x.shape[-1] <= 2 * t:
            # the interior slice would be empty and the mean NaN
            raise ValueError(
                f"batch length {x.shape[-1]} must exceed 2*trim={2 * t} "
                f"for the interior loss (trim defaults to n_taps="
                f"{n_taps}); use longer batches or pass a smaller trim")
        key = (hk.dtype, hk.device)
        if key not in consts:
            consts[key] = (*(torch.from_numpy(a).to(hk.device, hk.dtype)
                             for a in dft),
                           torch.from_numpy(masks).to(hk.device))
        Cm, Sm, mk = consts[key]
        y = synthesis_from_hk(analysis_from_hk(x, hk, precision), hk,
                              precision)
        e = (y - x)[..., t:-t]
        mse = torch.mean(e * e)
        re, im = hk @ Cm, hk @ Sm
        sb = torch.sum(torch.where(mk, re * re + im * im, 0.0)) / M
        return mse + stopband_weight * sb

    return loss_fn


@contextlib.contextmanager
def _cudnn_deterministic():
    """cuDNN's deterministic algorithms only, restored after. With cuDNN's
    default choice at ``highest`` two runs of one step differ in the last
    bits (two eager steps by 1e-11 in the loss on an NVIDIA H100 80GB HBM3,
    700.00 W: ``tools/train_determinism.py``), and so would the eager step
    and its graph."""
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = was


def loss_and_grad(loss_fn, hk: torch.Tensor, x: torch.Tensor,
                  precision: str = "highest") -> tuple:
    """``(loss, d loss / d hk)`` of ``loss_fn(hk, x, precision)``, both
    detached (``jax.value_and_grad``). The forward AND the backward run
    inside ``full_f32()``: autograd's backward convs run after the forward
    returns, and on the card cuDNN would run them in TF32 (about three
    decimal digits), against a residual about 1e-3 of the signal. They also
    run on cuDNN's deterministic algorithms, so a step gives the same bits
    each time it runs, eagerly or replayed."""
    hk = hk.detach().requires_grad_(True)
    with fb.full_f32(), _cudnn_deterministic():
        loss = loss_fn(hk, x, precision)
        grad, = torch.autograd.grad(loss, hk)
    return loss.detach(), grad


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def cosine_decay_schedule(lr: float, steps: int):
    """``optax.cosine_decay_schedule(lr, steps)`` in closed form, in
    float32: ``count -> lr * 0.5 * (1 + cos(pi * min(count, steps) /
    steps))``. The cosine is rounded to float32 from float64; XLA's float32
    cosine is within a few ulps of it, which ``1 + cos`` near pi turns
    into a few 1e-7 of ``lr``."""
    if not steps > 0:
        raise ValueError(f"cosine_decay_schedule needs steps > 0, got "
                         f"{steps}")
    f32 = np.float32

    def schedule(count: int) -> float:
        arg = f32(np.pi) * f32(min(count, steps)) / f32(steps)
        decay = f32(0.5) * (f32(1) + f32(np.cos(np.float64(arg))))
        return float(f32(lr) * decay)

    return schedule


def adam(learning_rate):
    """The optimizer of :func:`make_train_step`, as ``optax.adam``: a
    factory mapping ``hk`` to ``torch.optim.Adam`` (betas 0.9 / 0.999, eps
    1e-8) at a constant ``learning_rate`` or, for a callable, the schedule
    ``count -> lr`` (read at the count before each step; the factory's
    ``schedule`` attribute).

    On the card the Adam is ``capturable``, so one CUDA graph serves every
    step: its count and its lr live on the card (a float lr would be baked
    into the graph; :func:`make_train_step` writes each step's value into
    the lr tensor), and its moments and count are made here, in ``hk``'s
    dtype, before any step (Adam's own count would be float32, and a
    float64 run's bias corrections with it). On the CPU it is the plain
    Adam with a float lr."""
    schedule = learning_rate if callable(learning_rate) else None

    def factory(hk: torch.Tensor) -> torch.optim.Optimizer:
        lr = float(schedule(0) if schedule is not None else learning_rate)
        betas, eps = (0.9, 0.999), 1e-8
        if hk.device.type != "cuda":
            return torch.optim.Adam([hk], lr=lr, betas=betas, eps=eps)
        opt = torch.optim.Adam(
            [hk], lr=torch.tensor(lr, dtype=hk.dtype, device=hk.device),
            betas=betas, eps=eps, capturable=True)
        opt.state[hk] = {"step": hk.new_zeros(()),
                         "exp_avg": torch.zeros_like(hk),
                         "exp_avg_sq": torch.zeros_like(hk)}
        return opt

    factory.schedule = schedule
    return factory


def _set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The step's lr: written into a capturable Adam's lr tensor on the
    card (a kernel launch, no host sync), set as a float elsewhere."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


class _DataParallel:
    """The data-parallel layout of a mesh: this rank's index among the
    mesh's ``world`` ranks (data-major, as the JAX package flattens
    ``("data", "band")``) and the group over all of them."""

    def __init__(self, mesh):
        import torch.distributed as dist

        ndim = getattr(mesh, "ndim", None)
        if ndim != 2:
            raise ValueError(f"expected a 2-axis (data, band) mesh, got "
                             f"{ndim} dim(s)")
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the mesh")
        self.world = mesh.size()
        self.rank = coord[0] * mesh.size(1) + coord[1]
        ranks = mesh.mesh.flatten().tolist()
        # every rank of the default group makes the group, in or out of it
        self.group = (dist.group.WORLD if len(ranks) == dist.get_world_size()
                      else dist.new_group(ranks))

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the global batch (or of a DTensor's)."""
        from torch.distributed.tensor import DTensor

        if isinstance(x, DTensor):
            x = x.full_tensor()
        B = x.shape[0]
        if B % self.world:
            raise ValueError(
                f"batch of {B} does not split over the mesh's {self.world} "
                f"devices: its size must be divisible by {self.world}")
        n = B // self.world
        return x[self.rank * n:(self.rank + 1) * n]

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the mesh's ranks, in place."""
        import torch.distributed as dist

        dist.all_reduce(t, group=self.group)
        graphs.COLLECTIVES["grad_all_reduce"] += 1
        return t.div_(self.world)


class TrainState:
    """The train state: ``hk`` (a leaf tensor with ``requires_grad``), the
    torch optimizer over it, the lr ``schedule`` (None for a constant lr)
    and ``count``, the steps taken (the schedule's count). On the card it
    keeps its steps' CUDA graphs (``_graphs``): a graph holds the addresses
    of this state's ``hk`` and Adam moments, so a new state, or one that
    :func:`load_train_state` makes, captures its own."""

    def __init__(self, hk: torch.Tensor, optimizer: torch.optim.Optimizer,
                 schedule=None, count: int = 0):
        self.hk = hk
        self.optimizer = optimizer
        self.schedule = schedule
        self.count = count
        self._graphs = {}


def _batch_on(x, like: torch.Tensor) -> torch.Tensor:
    """A batch as a tensor on ``like``'s device: arrays are copied there
    (their dtype kept); a tensor must already be there."""
    if isinstance(x, torch.Tensor):
        if x.device != like.device:
            raise ValueError(f"batch is on {x.device}, the train state on "
                             f"{like.device}")
        return x
    return torch.tensor(np.asarray(x), device=like.device)


def make_train_step(optimizer=None, mesh=None, precision: str = "highest",
                    remat: bool = False, loss_fn=None, device="cuda"):
    """Build ``(init_fn, step_fn)``: ``init_fn(hk)`` makes a
    :class:`TrainState` on ``device``; ``step_fn(state, x)`` takes one
    optimizer step on batch ``x`` [B, 1, T] in place and returns ``(state,
    loss)`` with the loss as a detached 0-d tensor on the device (no host
    sync). ``optimizer`` is a factory ``hk -> torch.optim.Optimizer``
    (:func:`adam`; default ``adam(1e-4)``) whose ``schedule`` attribute,
    if set, gives the lr before each step. ``loss_fn(hk, x, precision)``
    defaults to :func:`reconstruction_loss`; pass
    :func:`make_finetune_loss`'s result for quality fine-tuning.
    ``remat=True`` recomputes the loss's forward in the backward
    (``torch.utils.checkpoint``) instead of keeping its activations.
    ``mesh``: a (data, band) mesh for full data parallelism (the module
    docstring); ``x`` is then the global batch (the same on every rank, or
    a DTensor), whose size must divide by the mesh's device count, as the
    JAX package's sharded step requires, and the loss is the global one.

    On the card the step is one CUDA graph a ``(batch shape, dtype,
    precision, remat, loss)``, kept on the state (``jax.jit(step)``): its
    first call runs eagerly (Adam's lazy set-up, cuDNN's algorithm choice
    and the loss's cached constants happen there), then the body — the
    loss and its gradient, the ``hk.grad`` assignment and
    ``optimizer.step()`` — is captured, and every later step copies the
    batch into the graph's buffer, writes the schedule's lr into Adam's lr
    tensor and replays. ``hk`` and Adam's moments are updated in place by
    the replay. ``step_fn.eager`` takes the same step without the graph
    (the card checks hold the graph against it; over gloo on the card the
    graph raises and ``eager`` is the step)."""
    dp = None if mesh is None else _DataParallel(mesh)
    fb.check_precision(precision)
    dev = resolve_device(device)
    if optimizer is None:
        optimizer = adam(1e-4)
    schedule = getattr(optimizer, "schedule", None)
    if loss_fn is None:
        loss_fn = reconstruction_loss
    if remat:
        inner = loss_fn

        def loss_fn(hk, x, precision):
            # the loss draws no random numbers: no RNG state to keep
            return checkpoint(inner, hk, x, precision, use_reentrant=False,
                              preserve_rng_state=False)

    def init_fn(hk) -> TrainState:
        t = (hk.detach().to(dev).clone() if isinstance(hk, torch.Tensor)
             else torch.tensor(np.asarray(hk), device=dev))
        t.requires_grad_(True)
        return TrainState(t, optimizer(t), schedule)

    def step(state: TrainState, x, graphed: bool):
        if dp is not None:
            x = dp.local(x)
        x = _batch_on(x, state.hk)
        if state.schedule is not None:
            _set_lr(state.optimizer, state.schedule(state.count))

        def body(xb):
            loss, grad = loss_and_grad(loss_fn, state.hk, xb, precision)
            if dp is not None:
                # the mean of the ranks' equal-sized local means is the
                # global batch's mean, as the JAX package's loss
                loss, grad = dp.mean(loss), dp.mean(grad)
            state.hk.grad = grad
            state.optimizer.step()
            return loss

        if graphed:
            key = (tuple(x.shape), x.dtype, precision, remat, loss_fn)
            prog = state._graphs.get(key)
            if prog is None:
                prog = state._graphs[key] = graphs.Program(
                    body, x.device, None if dp is None else dp.group)
            loss = prog(x)
        else:
            loss = body(x)
        state.count += 1
        return state, loss

    def step_fn(state: TrainState, x):
        return step(state, x, graphs._graphed(state.hk.device))

    step_fn.eager = lambda state, x: step(state, x, False)
    return init_fn, step_fn


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


NOISE_CHUNK = 256  # steps of noise drawn at once (32 MB at batch 4 x 8192)


def noise_batches(seed: int, steps: int, batch: int, length: int, device):
    """The training noise, one [batch, 1, length] float32 tensor on
    ``device`` a step: ``default_rng(seed).standard_normal((steps, batch,
    1, length))``, drawn :data:`NOISE_CHUNK` steps at a time (the same
    stream as the JAX package's single draw) and copied to the card from
    pinned memory without a host sync."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    for start in range(0, steps, NOISE_CHUNK):
        n = min(NOISE_CHUNK, steps - start)
        a = torch.from_numpy(rng.standard_normal(
            (n, batch, 1, length)).astype(np.float32))
        if dev.type == "cuda":
            a = a.pin_memory().to(dev, non_blocking=True)
        yield from a


def finetune_filterbank(attenuation: float, n_band: int, steps: int = 2000,
                        batch: int = 8, length: int = 4096, lr: float = 3e-6,
                        stopband_weight: float = 1e-4, seed: int = 0,
                        mesh=None, precision: str = "highest",
                        lr_schedule: str = "constant", device="cuda"):
    """Fine-tune the designed bank's steady-state reconstruction on white
    noise with ``steps`` Adam steps (:func:`make_finetune_loss`) and return
    ``(params, losses)``: a params dict (``fb.params_from_hk``, installable
    with ``set_weights``) and the per-step losses as a NumPy array.

    White noise is the right training signal for a linear system: the
    interior round-trip MSE is the Frobenius norm of (round trip -
    identity), so the result carries over to any program material.
    ``lr_schedule="cosine"`` decays ``lr`` (the peak) to 0 over ``steps``;
    every committed bank is ``lr=2e-5, steps=8000, batch=4, length=8192,
    lr_schedule="cosine"`` at its band count (M=64: ``length=16384,
    steps=12000, batch=2``). The losses stay on the device until the end:
    the loop never waits for the card. Under a ``mesh`` every rank draws
    the same global noise and trains on its rows of it (data-parallel,
    :func:`make_train_step`); ``batch`` must divide by the mesh's device
    count, and every rank returns the same bank and losses."""
    dev = resolve_device(device)
    base = fb.build_filterbank(attenuation, n_band)
    n_taps = base["hk"].shape[-1]
    if length <= 2 * n_taps:
        raise ValueError(
            f"length={length} must exceed 2*n_taps={2 * n_taps} "
            f"(the interior-loss trim) for this bank; the interior slice "
            f"would be empty and training would silently produce NaNs")
    loss_fn = make_finetune_loss(n_band, n_taps,
                                 stopband_weight=stopband_weight)
    if lr_schedule == "cosine":
        rate = cosine_decay_schedule(lr, steps)
    elif lr_schedule == "constant":
        rate = lr
    else:
        raise ValueError(f"unknown lr_schedule {lr_schedule!r}: expected "
                         f"'constant' or 'cosine'")
    init_fn, step_fn = make_train_step(adam(rate), mesh=mesh,
                                       precision=precision, loss_fn=loss_fn,
                                       device=dev)
    state = init_fn(base["hk"])
    losses = torch.empty(steps, device=dev)
    for i, x in enumerate(noise_batches(seed, steps, batch, length, dev)):
        losses[i] = step_fn(state, x)[1]
    return (fb.params_from_hk(state.hk.detach().cpu().numpy(), h=base["h"]),
            losses.cpu().numpy())


def worst_stopband_db(hk) -> float:
    """The worst band's stopband peak over its own peak, in dB:
    ``|rfft(hk[k], 8192)|`` more than one band-width outside band k's
    passband (the JAX package's fine-tune test reads the same)."""
    hk = np.asarray(hk, np.float64)
    M = hk.shape[0]
    H = np.abs(np.fft.rfft(hk, 8192, axis=-1))
    w = np.linspace(0, np.pi, H.shape[-1])
    worst = max(
        H[k][(w < k * np.pi / M - np.pi / M)
             | (w > (k + 1) * np.pi / M + np.pi / M)].max() / H[k].max()
        for k in range(M))
    return float(20 * np.log10(worst))


def roundtrip_snr(params, attenuation: float, n_band: int, x,
                  **streaming_kwargs) -> float:
    """Group-delay-aligned steady-state round-trip SNR (dB) of the mono
    signal ``x`` [T] through ``StreamingPQMF.roundtrip`` with ``params``
    installed (None: the designed bank); ``x`` is cut to a multiple of
    ``n_band`` and one bank length is trimmed from each edge
    (``utils.metrics.aligned_roundtrip_snr_db``). Extra kwargs reach the
    ``StreamingPQMF`` constructor (``device``, ``precision``)."""
    x = np.asarray(x, np.float32).reshape(1, -1)
    x = x[:, : (x.shape[-1] // n_band) * n_band]
    sp = StreamingPQMF(attenuation, n_band, **streaming_kwargs)
    if params is not None:
        sp.set_weights(params)
    y = sp.roundtrip(x[None])[0, 0].cpu().numpy()
    return aligned_roundtrip_snr_db(
        x[0], y, sp.centered_delay, edge_trim=int(sp.params["hk"].shape[-1]))


def streaming_roundtrip_snr(params, attenuation: float, n_band: int,
                            wav_path: str, **streaming_kwargs) -> float:
    """:func:`roundtrip_snr` of a wav file, multichannel files
    mono-averaged first — the measurement behind every committed
    fine-tuned-bank number."""
    x, _ = read_wav(wav_path)
    if x.shape[0] > 1:
        x = x.mean(axis=0, keepdims=True)
    return roundtrip_snr(params, attenuation, n_band, x[0],
                         **streaming_kwargs)


class TrainablePQMF:
    """Start from the designed bank and fine-tune ``hk``, one batch at a
    time."""

    def __init__(self, attenuation: float, n_band: int, optimizer=None,
                 mesh=None, device="cuda"):
        params = fb.build_filterbank(attenuation, n_band)
        self.n_band = n_band
        self.device = resolve_device(device)
        init_fn, self.step = make_train_step(optimizer, mesh,
                                             device=self.device)
        self.state = init_fn(params["hk"])

    def train_batch(self, x) -> float:
        self.state, loss = self.step(self.state, x)
        return float(loss)

    @property
    def hk(self) -> torch.Tensor:
        return self.state.hk


def save_train_state(state: TrainState, path: str) -> str:
    """Checkpoint ``state`` to one npz in the JAX package's layout (its
    pytree leaves in order), so checkpoints load across the two packages:
    ``leaf_0`` hk, ``leaf_1`` Adam's count (int32), ``leaf_2`` / ``leaf_3``
    its first and second moments, ``leaf_4`` the schedule's count (int32)
    when a schedule sets the lr."""
    hk = state.hk.detach().cpu().numpy()
    moments = state.optimizer.state.get(state.hk)
    if moments:
        leaves = [hk, np.int32(int(moments["step"])),
                  moments["exp_avg"].detach().cpu().numpy(),
                  moments["exp_avg_sq"].detach().cpu().numpy()]
    else:
        leaves = [hk, np.int32(0), np.zeros_like(hk), np.zeros_like(hk)]
    if state.schedule is not None:
        leaves.append(np.int32(state.count))
    np.savez(path, **{f"leaf_{i}": a for i, a in enumerate(leaves)})
    return path


def load_train_state(template: TrainState, path: str) -> TrainState:
    """Restore a checkpoint (the JAX package's or :func:`save_train_state`'s)
    into a new state shaped like ``template``: its device, dtype,
    optimizer settings and schedule."""
    n = 5 if template.schedule is not None else 4
    with np.load(path) as z:
        leaves = [z[f"leaf_{i}"] for i in range(n)]
    like = template.hk
    hk = torch.from_numpy(leaves[0]).to(like.device, like.dtype)
    hk.requires_grad_(True)
    opt = type(template.optimizer)([hk], **template.optimizer.defaults)
    sd = opt.state_dict()
    sd["state"] = {0: {"step": torch.tensor(float(leaves[1])),
                       "exp_avg": torch.from_numpy(leaves[2]),
                       "exp_avg_sq": torch.from_numpy(leaves[3])}}
    opt.load_state_dict(sd)  # deep-copies the groups: the lr tensor too
    if opt.defaults.get("capturable"):
        # load_state_dict makes a capturable count float32; adam() keeps
        # it in hk's dtype
        opt.state[hk]["step"] = opt.state[hk]["step"].to(hk.dtype)
    count = int(leaves[4]) if n == 5 else int(leaves[1])
    return TrainState(hk, opt, template.schedule, count)


# ---------------------------------------------------------------------------
# The committed banks
# ---------------------------------------------------------------------------


def available_pretrained_banks() -> list[str]:
    """Names accepted by :func:`load_pretrained_bank`."""
    return sorted(p.stem for p in BANK_DIR.glob("*.npz"))


def load_pretrained_bank(name: str = "hk16_atten100_finetuned") -> dict:
    """A committed fine-tuned bank as a params dict ``{h, hk, hk_poly,
    hk_ipoly}`` (float32 NumPy), derived from its ``hk`` exactly as the JAX
    package derives it."""
    path = BANK_DIR / f"{name}.npz"
    if not path.exists():
        raise FileNotFoundError(
            f"no committed bank named {name!r}; available: "
            f"{available_pretrained_banks()}")
    with np.load(path) as z:
        return fb.params_from_hk(z["hk"],
                                 h=z["h"] if "h" in z.files else None)
