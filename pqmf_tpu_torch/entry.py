"""Entry points of the port: the flagship step and the mesh dry run.

Counterpart of the JAX package's ``__graft_entry__.py``:

- :func:`entry` returns one flagship pitch-shift step
  ``fn(prev_tail, x) -> (new_tail, y)`` and its example arguments: the
  ``PQMFPitchShiftWrapper`` at attenuation 100, 16 bands, 8192-sample
  blocks, whose ``pitchshift_fn`` is a CUDA graph on the card (K1, the
  batched middle, K2).
- :func:`dryrun_multichip` spawns ``n_devices`` ranks over gloo (they may
  share one card, or run on the CPU) and runs the JAX dry run's four steps
  on the (data, band) mesh: the sharded flagship step, the 16-band sharded
  step against the unsharded wrapper, the torchaudio-variant wrapper on the
  mesh against the unsharded one, and one data-parallel train step.

On the CPU (``device="cpu"``) the kernel wrappers run their plain
versions. Asked for ``"cuda"`` without a card, both raise.

    python -c "from pqmf_tpu_torch.entry import entry; fn, a = entry(); \
print(fn(*a)[1].shape)"
    python -c "from pqmf_tpu_torch.entry import dryrun_multichip as d; \
d(4, device='cpu')"
"""

from __future__ import annotations

import json
import math
import os
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip", "DRYRUN_STEPS", "EXAMPLE_FLOOR_DB"]

# the four steps of the dry run, each printed as "<name> OK: ..."
DRYRUN_STEPS = ("sharded pitchshift step", "sharded kernel pitchshift step",
                "sharded TA pitchshifter step", "sharded train step")
BAR_DB = 90.0          # the card's sharded step against the CPU port
# entry()'s example input, a pure sine, leaves 17% of the STFT bins of the
# sub-band that carries it at noise level (under 1e-5 of the peak), where
# the f32 DFT's rounding is ~1% of the bin and turns its phase. The
# reference's per-frame phase rule anchors an output frame on such a bin's
# phase while its magnitude comes from the next frame, so the order of the
# DFT's sums moves the output: one ulp on the JAX entry's own input moves
# its output to 82.7 dB, the CPU port reads 60.65 dB against the JAX
# package (tail 68.2; ``tools/entry_conditioning.py``), and an NVIDIA H100
# 80GB HBM3 at 700 W reads 57.55 dB against the CPU port (tail 66.95;
# ``chip_smoke.py`` phase 7, the CPU's MKL pinned). Audio blocks hold
# BAR_DB (115.7 dB on the CPU against JAX, 120.1 dB on the H100). On the
# example input a step is held only at this floor, which a wrong
# configuration (no shift: 4.7 dB, attenuation 70: 21.1, the accumulating
# phase rule: 12.2) falls far below.
EXAMPLE_FLOOR_DB = 40.0
STEP_TOL = 1e-5        # sharded vs unsharded on one device (the JAX bar)
TA_TOL = 1e-4          # the TA wrapper on the mesh vs unsharded
DRYRUN_TIMEOUT = 600.0  # seconds for the ranks; then they are killed


def _require(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run "
                           "on the CPU")
    return dev


def entry(device="cuda"):
    """Return ``(fn, (tail0, x))``: one flagship pitch-shift step.

    ``fn(prev_tail [M, L], x [1, 1, T]) -> (new_tail [M, L], y [1, T])``:
    streaming PQMF analysis (K1), the batched per-band STFT, stretch with
    per-band rates, masked OLA ISTFT and resample, the crossfade against
    the carried tail, streaming PQMF synthesis (K2); on the card the
    wrapper's CUDA graph of all of it. ``x`` is ``sin(linspace(0, 800 pi,
    8192))`` in float32, as in the JAX package's entry."""
    from pqmf_tpu_torch.pipelines import PQMFPitchShiftWrapper

    dev = _require(device)
    wrapper = PQMFPitchShiftWrapper(attenuation=100, n_band=16,
                                    m_buffer_size=8192, device=dev)

    def fn(prev_tail, x):
        state, y = wrapper.pitchshift_fn({"prev_tail": prev_tail}, x)
        return state["prev_tail"], y

    tail0 = wrapper.init_state()["prev_tail"]
    x = torch.from_numpy(
        np.sin(np.linspace(0, 800 * np.pi, 8192, dtype=np.float32))
    )[None, None, :].to(dev)
    return fn, (tail0, x)


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout: float = DRYRUN_TIMEOUT) -> dict:
    """Run the JAX package's multi-device dry run on ``n_devices`` ranks.

    The ranks are spawned processes joined over gloo (``file://``
    rendezvous in a temporary directory); on ``"cuda"`` rank r uses card
    ``r % device_count``, so several ranks may share one card. Every step
    runs its eager form (a CUDA graph holds collectives over NCCL only):

    (a) the 4-band, attenuation 70, 256-sample ``ShardedPitchShift`` step
        on ``make_mesh(n_devices, n_band=4)``, the batch on ``data``;
    (b) the 16-band, attenuation 100, 2048-sample step on a mesh of
        ``min(n_devices, 8)`` ranks (even band shards), held against the
        unsharded wrapper on the same device at 1e-5 and, on the card,
        against the CPU port at >= 90 dB; on the card K1 and K2 run on each
        rank's band shard;
    (c) ``PQMFPitchShiftWrapperTA(mesh=)`` at 4096 samples against the
        unsharded wrapper at 1e-4;
    (d) one data-parallel train step of ``build_filterbank(70, 4)``, with a
        finite loss.

    Prints the mesh and one "OK" line a step (:data:`DRYRUN_STEPS`) and
    returns rank 0's results. A rank that fails, or is still running after
    ``timeout`` seconds (then killed), makes the call raise."""
    import torch.multiprocessing as mp

    dev = _require(device)
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if dev.type == "cuda":
        from pqmf_tpu_torch.kernels import _build

        _build.load()  # built once here, not by every rank
    td = tempfile.mkdtemp(prefix="pqmf_dryrun_")
    try:
        ctx = mp.get_context("spawn")
        init = "file://" + os.path.join(td, "rendezvous")
        procs = [ctx.Process(target=_rank, args=(r, n, init, dev.type, td))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
        errs = [f"rank {r}:\n" + open(os.path.join(td, f"rank{r}.err")).read()
                for r in range(n)
                if os.path.exists(os.path.join(td, f"rank{r}.err"))]
        codes = [p.exitcode for p in procs]
        if hung or any(codes) or errs:
            raise RuntimeError(
                f"dryrun_multichip({n}, {dev.type!r}): "
                f"{len(hung)} rank(s) hung past {timeout} s, exit codes "
                f"{codes}\n" + "\n".join(errs))
        with open(os.path.join(td, "rank0.json")) as f:
            res = json.load(f)
    finally:
        shutil.rmtree(td, ignore_errors=True)
    print(f"mesh: {res['mesh']}")
    for line in res["lines"]:
        print(line)
    return res


def _gather_rows(t, lay):
    """The global [B, ...] value of ``t``, a DTensor split (or not) over the
    data axis of ``lay``'s mesh, on the CPU (gloo gathers CPU objects).
    Every rank of the world calls it; a rank outside the mesh passes None
    for both and gets None."""
    import torch.distributed as dist

    local = None if t is None else t.to_local().detach().cpu().numpy()
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, None if t is None else
                           (lay.data_rank, lay.band_rank, local))
    if t is None or not t.placements[0].is_shard():
        return None if t is None else torch.from_numpy(local)
    rows = sorted((d, a) for d, b, a in (p for p in parts if p is not None)
                  if b == 0)
    return torch.from_numpy(np.concatenate([a for _, a in rows]))


def _check(ok: bool, what: str) -> None:
    """A dry-run check that holds under ``python -O`` too."""
    if not ok:
        raise AssertionError(what)


def _max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def _rank(rank: int, world: int, init: str, device_type: str,
          out_dir: str) -> None:
    """One rank of :func:`dryrun_multichip`: writes ``rank<r>.json`` (rank
    0's lines and checks) or ``rank<r>.err`` (its traceback)."""
    import torch.distributed as dist

    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        res = _dryrun_steps(rank, world, dev)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def _dryrun_steps(rank: int, world: int, dev: torch.device) -> dict:
    """The four steps on this rank; every rank takes part in every
    collective, and rank 0 checks the gathered results."""
    from pqmf_tpu_torch.kernels import cached_conv as cc
    from pqmf_tpu_torch.ops import filterbank as fb
    from pqmf_tpu_torch.parallel.sharding import ShardedPitchShift, make_mesh
    from pqmf_tpu_torch.parallel.training import make_train_step
    from pqmf_tpu_torch.pipelines import (PQMFPitchShiftWrapper,
                                          PQMFPitchShiftWrapperTA)
    from pqmf_tpu_torch.utils.metrics import snr_db

    res = {"lines": [], "checks": {}, "launches": {}}
    lines = res["lines"]

    # --- (a) the flagship step, 4 bands, the batch on 'data' --------------
    n_band = 4
    mesh = make_mesh(world, n_band=n_band, device_type=dev.type)
    data_dim = mesh.size(0)
    res["mesh"] = {"data": data_dim, "band": mesh.size(1)}
    wrapper = PQMFPitchShiftWrapper(attenuation=70, n_band=n_band,
                                    m_buffer_size=256, device=dev)
    sharded = ShardedPitchShift(wrapper, mesh)
    tail = sharded.init_state()
    x = torch.ones((data_dim, 1, 256), device=dev)
    tail, y = sharded.eager(tail, x)
    y_full = _gather_rows(y, sharded.layout)
    _check(tuple(y.shape) == (data_dim, 256), f"y {tuple(y.shape)}")
    _check(bool(torch.isfinite(y_full).all()), "non-finite y")
    lines.append(f"{DRYRUN_STEPS[0]} OK: y{tuple(y.shape)} "
                 f"placements={tuple(str(p) for p in y.placements)}")

    # --- (b) 16 bands on a mesh of at most 8 ranks (even band shards) -----
    n16 = min(world, 8)
    mesh16 = make_mesh(n16, n_band=16, device_type=dev.type)
    in16 = rank < n16
    d16 = mesh16.size(0)
    x16 = (0.3 * np.random.default_rng(0).standard_normal(
        (d16, 1, 2048)).astype(np.float32))
    y_pal, lay16 = None, None
    if in16:
        w_pal = PQMFPitchShiftWrapper(attenuation=100, n_band=16,
                                      m_buffer_size=2048, device=dev)
        sp_pal = ShardedPitchShift(w_pal, mesh16)
        _check(sp_pal.wrapper.pqmf.mesh is not None,
               "the kernels did not band-shard under the mesh")
        lay16 = sp_pal.layout
        if dev.type == "cuda":
            torch.cuda.synchronize()
        cc.reset_launches()
        _, y_pal = sp_pal.eager(sp_pal.init_state(),
                                torch.from_numpy(x16).to(dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        res["launches"]["sharded step"] = {
            "K1": cc.LAUNCHES["analysis"], "K2": cc.LAUNCHES["synthesis"],
            "Mb": lay16.Mb}
        if dev.type == "cuda":
            _check(cc.LAUNCHES["analysis"] >= 1
                   and cc.LAUNCHES["synthesis"] >= 1,
                   f"K1/K2 launches {cc.LAUNCHES}")
    y16 = _gather_rows(y_pal, lay16)
    if rank == 0:
        ref = PQMFPitchShiftWrapper(attenuation=100, n_band=16,
                                    m_buffer_size=2048, device=dev)
        _, y_ref = ref.pitchshift_fn(ref.init_state(),
                                     torch.from_numpy(x16).to(dev))
        y_ref = y_ref.cpu()
        err = _max_err(y16, y_ref)
        res["checks"]["sharded vs unsharded, one device, max abs"] = err
        if dev.type == "cpu":
            torch.testing.assert_close(y16, y_ref, atol=STEP_TOL,
                                       rtol=STEP_TOL)
        else:
            cpu = PQMFPitchShiftWrapper(attenuation=100, n_band=16,
                                        m_buffer_size=2048, device="cpu")
            _, y_cpu = cpu.pitchshift_fn(cpu.init_state(),
                                         torch.from_numpy(x16))
            db = snr_db(y_cpu.numpy(), y16.numpy())
            res["checks"]["sharded (card) vs CPU port, dB"] = db
            _check(db >= BAR_DB, f"sharded step {db:.2f} dB vs the CPU port")
        lines.append(f"{DRYRUN_STEPS[1]} OK: y{tuple(y16.shape)} == "
                     f"unsharded (band axis {mesh16.size(1)}-way, "
                     f"max abs {err:.3g})")

    # --- (c) the torchaudio-variant wrapper on the mesh --------------------
    x_ta = (0.3 * np.random.default_rng(1).standard_normal(
        (d16, 1, 4096)).astype(np.float32))
    y_ta, lay_ta = None, None
    if in16:
        w_ta = PQMFPitchShiftWrapperTA(attenuation=100, n_band=16,
                                       m_buffer_size=4096, mesh=mesh16,
                                       device=dev)
        lay_ta = w_ta.pqmf._layout
        xt = torch.from_numpy(x_ta).to(dev)
        # the eager form of pitchshifter under the mesh: gloo is not
        # captured
        y_ta = lay_ta.wrap(
            w_ta._pitchshifter_eager(lay_ta.local(xt, data_dim=0)),
            data_dim=0, batch=xt.shape[0])
    y_ta_full = _gather_rows(y_ta, lay_ta)
    if rank == 0:
        w_ref = PQMFPitchShiftWrapperTA(attenuation=100, n_band=16,
                                        m_buffer_size=4096, device=dev)
        y_ref = w_ref.pitchshifter(torch.from_numpy(x_ta).to(dev)).cpu()
        y_got = y_ta_full.reshape(y_ref.shape)
        res["checks"]["TA sharded vs unsharded, max abs"] = _max_err(y_got,
                                                                    y_ref)
        torch.testing.assert_close(y_got, y_ref, atol=TA_TOL, rtol=TA_TOL)
        lines.append(f"{DRYRUN_STEPS[2]} OK: y{tuple(y_ref.shape)} == "
                     f"unsharded (band axis {mesh16.size(1)}-way)")

    # --- (d) one data-parallel train step ----------------------------------
    params = fb.build_filterbank(70, n_band)
    init_fn, step_fn = make_train_step(mesh=mesh, device=dev)
    state = init_fn(params["hk"])
    n_mesh = mesh.size()
    batch = torch.ones((2 * n_mesh, 1, 512), device=dev)
    state, loss = step_fn.eager(state, batch)
    loss = float(loss)
    _check(math.isfinite(loss), f"train loss {loss}")
    res["checks"]["train loss"] = loss
    lines.append(f"{DRYRUN_STEPS[3]} OK: loss={loss:.6f} "
                 f"(batch {batch.shape[0]} over {n_mesh} devices)")
    return res
