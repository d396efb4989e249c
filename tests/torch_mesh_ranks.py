"""Rank programs of the port's (data, band) mesh tests, and their launcher.

Each test file spawns its ranks once (``torch.multiprocessing``, spawn
context, gloo over a ``file://`` rendezvous in the test's temporary
directory) and reads what every rank wrote to ``rank<r>.npz``. The ranks
import numpy, torch and ``pqmf_tpu_torch`` only (this module imports no
JAX); the JAX references run in the test process. The inputs are made here
from seeds with numpy, and the tests make the same ones.
"""

from __future__ import annotations

import os
import time
import traceback

import numpy as np
import torch

WORLD = 4          # ranks of every spawn
JOIN_TIMEOUT = 120  # seconds; then the ranks are killed and the test fails
SHAPES = ((1, 4), (2, 2))


def signal(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            .astype(np.float32) * np.float32(scale))


# -- the launcher --------------------------------------------------------------


class Ranks:
    """``WORLD`` rank processes running ``target(rank, world, out)``; each
    writes the dict ``out`` it fills to ``rank<r>.npz``. Start them, do
    the test process's own work, then ``join``."""

    def __init__(self, target, tmp_dir, *args):
        self.dir = str(tmp_dir)
        ctx = torch.multiprocessing.get_context("spawn")
        init = "file://" + os.path.join(self.dir, "rendezvous")
        self.procs = [ctx.Process(target=_entry,
                                  args=(target, r, WORLD, init, self.dir)
                                  + args)
                      for r in range(WORLD)]
        for p in self.procs:
            p.start()

    def join(self, timeout: float = JOIN_TIMEOUT) -> list:
        deadline = time.monotonic() + timeout
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [p for p in self.procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
        errors = []
        for r in range(WORLD):
            path = os.path.join(self.dir, f"rank{r}.err")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
        codes = [p.exitcode for p in self.procs]
        assert not hung and not any(codes) and not errors, (
            f"ranks {'hung past ' + str(timeout) + ' s, ' if hung else ''}"
            f"exit codes {codes}\n" + "\n".join(errors))
        out = []
        for r in range(WORLD):
            with np.load(os.path.join(self.dir, f"rank{r}.npz")) as z:
                out.append({k: z[k] for k in z.files})
        return out


def _entry(target, rank, world, init, out_dir, *args):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        out = {}
        target(rank, world, out, *args)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 **{k: np.asarray(v) for k, v in out.items()})
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


# -- helpers inside a rank -------------------------------------------------------


def _mesh(shape, names=("data", "band")):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(WORLD).reshape(shape),
                      mesh_dim_names=names)


def _full(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().numpy()


class _Counts:
    """Counts, in a rank, the collectives (``dist.all_reduce``, and every
    gather: ``dist.all_gather*``, ``DTensor.full_tensor`` and
    ``redistribute``), the K3 and K6 calls, and the rows of every K1 bank
    and columns of every K2 bank."""

    def __init__(self):
        import torch.distributed as dist
        from torch.distributed.tensor import DTensor

        from pqmf_tpu_torch.kernels import cached_conv as cc
        from pqmf_tpu_torch.kernels import polyphase as pk

        self.n = {"all_reduce": 0, "gather": 0, "k3": 0, "k6": 0}
        self.k1_rows, self.k2_cols = [], []
        self._undo = []

        def patch(obj, name, wrapper):
            orig = getattr(obj, name)
            setattr(obj, name, wrapper(orig))
            self._undo.append((obj, name, orig))

        def count(key):
            def wrap(orig):
                def fn(*a, **k):
                    self.n[key] += 1
                    return orig(*a, **k)
                return fn
            return wrap

        patch(dist, "all_reduce", count("all_reduce"))
        for name in ("all_gather", "all_gather_into_tensor",
                     "all_gather_object"):
            patch(dist, name, count("gather"))
        patch(DTensor, "full_tensor", count("gather"))
        patch(DTensor, "redistribute", count("gather"))
        patch(cc, "fused_roundtrip_conv", count("k3"))
        patch(pk, "polyphase_roundtrip", count("k6"))

        def k1(orig):
            def fn(x, w, *a, **k):
                self.k1_rows.append(w.shape[0])
                return orig(x, w, *a, **k)
            return fn

        def k2(orig):
            def fn(x, w, *a, **k):
                self.k2_cols.append(w.shape[1])
                return orig(x, w, *a, **k)
            return fn

        patch(cc, "strided_analysis_conv", k1)
        patch(cc, "dense_synthesis_conv", k2)

    def reset(self):
        for k in self.n:
            self.n[k] = 0
        self.k1_rows.clear()
        self.k2_cols.clear()

    def undo(self):
        for obj, name, orig in reversed(self._undo):
            setattr(obj, name, orig)


# -- the inference ranks -----------------------------------------------------------


def mesh_ranks(rank, world, out):
    """Every check of the inference path, on meshes (1, 4) and (2, 2), the
    bad meshes and the odd-shard ShardedPitchShift. Keys are
    ``<shape>/<what>``; the full (global) value of every output, its
    launches and collectives."""
    from pqmf_tpu_torch import (PQMF, PQMFPitchShiftWrapper,
                                PQMFPitchShiftWrapperTA, PQMFWrapper,
                                StreamingPQMF, stream_ola)
    from pqmf_tpu_torch.parallel.sharding import ShardedPitchShift
    from pqmf_tpu_torch.streaming import scan_blocks

    x = torch.from_numpy(signal(0, (2, 1, 4096)))
    xw = torch.from_numpy(signal(1, (2, 1, 2048), 0.1))
    blocks1 = torch.from_numpy(signal(2, (3, 1, 1, 2048), 0.1))
    counts = _Counts()
    try:
        for shape in SHAPES:
            tag = f"{shape[0]}x{shape[1]}"
            mesh = _mesh(shape)
            Mb = 16 // shape[1]

            # StreamingPQMF: offline, causal, streaming
            sp = StreamingPQMF(100, 16, device="cpu", mesh=mesh)
            out[f"{tag}/sp_shard_rows"] = (sp.hkf_shard.shape[0],
                                           sp.hki_shard.shape[1])
            counts.reset()
            sub = sp.forward(x)
            out[f"{tag}/sp_forward"] = _full(sub)
            counts.reset()
            y = sp.inverse(sub)
            out[f"{tag}/sp_inverse_counts"] = (counts.n["all_reduce"],
                                               counts.n["gather"])
            out[f"{tag}/sp_inverse"] = _full(y)
            counts.reset()
            out[f"{tag}/sp_roundtrip"] = _full(sp.roundtrip(x))
            out[f"{tag}/sp_roundtrip_counts"] = (
                counts.n["all_reduce"], counts.n["k3"],
                max(counts.k1_rows), max(counts.k2_cols))
            out[f"{tag}/sp_causal"] = _full(
                sp.inverse_causal(sp.forward_causal(x)))
            state, ys = sp.init_state(2), []
            for blk in x.split(1024, dim=-1):
                state, yb = sp.process_block(state, blk)
                ys.append(_full(yb))
            out[f"{tag}/sp_stream"] = np.concatenate(ys, axis=-1)
            out[f"{tag}/sp_stream_state"] = _full(state["synthesis"])
            _, ys_scan = scan_blocks(sp.process_block, sp.init_state(2),
                                     torch.stack(x.split(1024, dim=-1)))
            out[f"{tag}/sp_scan"] = _full(ys_scan)

            # PQMF: K4, K5, and the round trip without K6
            pq = PQMF(100, 16, device="cpu", mesh=mesh)
            counts.reset()
            psub = pq.forward(x)
            out[f"{tag}/pq_forward"] = _full(psub)
            py = pq.inverse(psub)
            out[f"{tag}/pq_inverse"] = _full(py)
            out[f"{tag}/pq_roundtrip"] = _full(pq.roundtrip(x))
            out[f"{tag}/pq_counts"] = (counts.n["all_reduce"],
                                       counts.n["k6"], pq._hp.shape[0],
                                       pq._hi.shape[1])

            # two channels: their bands interleave with the channels
            x2 = torch.from_numpy(signal(4, (2, 2, 2048)))
            for name, cls in (("sp", StreamingPQMF), ("pq", PQMF)):
                f2 = cls(100, 16, n_channels=2, device="cpu", mesh=mesh)
                sub2 = f2.forward(x2)
                out[f"{tag}/{name}_stereo_forward"] = _full(sub2)
                out[f"{tag}/{name}_stereo_inverse"] = _full(f2.inverse(sub2))

            # PQMFWrapper.process
            wr = PQMFWrapper(100, 16, device="cpu", mesh=mesh)
            rec, wsub = wr.process(xw)
            out[f"{tag}/wrap_rec"], out[f"{tag}/wrap_sub"] = (_full(rec),
                                                              _full(wsub))

            # ShardedPitchShift: B = 2 (no crossfade), then B = 1 over
            # three blocks with the tail carried
            w = PQMFPitchShiftWrapper(100, 16, 2048, device="cpu")
            sh = ShardedPitchShift(w, mesh)
            counts.reset()
            tail, y2 = sh(sh.init_state(), xw)
            out[f"{tag}/sps_counts"] = (counts.n["all_reduce"],
                                        counts.n["gather"],
                                        max(counts.k1_rows),
                                        max(counts.k2_cols))
            out[f"{tag}/sps_y2"], out[f"{tag}/sps_tail2"] = (_full(y2),
                                                             _full(tail))
            tail, ys = sh.init_state(), []
            for blk in blocks1:
                tail, yb = sh(tail, blk)
                ys.append(_full(yb))
            out[f"{tag}/sps_y1"] = np.stack(ys)
            out[f"{tag}/sps_tail1"] = _full(tail)
            tail_e, y_e = sh.eager(sh.init_state(), xw)
            out[f"{tag}/sps_eager_y2"] = _full(y_e)
            out[f"{tag}/sps_view"] = (sh.wrapper.pqmf.mesh is not None,
                                      w.pqmf.mesh is None)
            # the port unsharded, in this rank
            st, yu = w.pitchshift_fn(w.init_state(), xw)
            out[f"{tag}/ps_y2"] = _full(yu)
            out[f"{tag}/ps_tail2"] = _full(st["prev_tail"])
            st, ys = w.init_state(), []
            for blk in blocks1:
                st, yb = w.pitchshift_fn(st, blk)
                ys.append(_full(yb))
            out[f"{tag}/ps_y1"] = np.stack(ys)
            out[f"{tag}/ps_tail1"] = _full(st["prev_tail"])

            # the wrapper's own mesh: its 2-stream step and stream_ola
            wm = PQMFPitchShiftWrapper(100, 16, 2048, device="cpu",
                                       mesh=mesh)
            states, ysm = wm.pitchshift_streams(wm.init_streams(2), xw[:, 0])
            out[f"{tag}/streams_y"] = _full(ysm)
            out[f"{tag}/streams_tail"] = _full(states["prev_tail"])
            states, ysu = w.pitchshift_streams(w.init_streams(2), xw[:, 0])
            out[f"{tag}/streams_y_port"] = _full(ysu)
            out[f"{tag}/streams_tail_port"] = _full(states["prev_tail"])
            pitch, recon = stream_ola(wm, x[0, :, :3000], 1024)
            pitch_u, recon_u = stream_ola(w, x[0, :, :3000], 1024)
            out[f"{tag}/ola"] = np.stack([_full(pitch), _full(recon)])
            out[f"{tag}/ola_port"] = np.stack([_full(pitch_u),
                                               _full(recon_u)])

            # restored weights survive the view
            wf = PQMFPitchShiftWrapper(70, 16, 1024, device="cpu")
            wf.pqmf.set_weights({k: v * 1.05
                                 for k, v in wf.pqmf.params.items()},
                                wf.pqmf.hkf * 1.05, wf.pqmf.hki * 1.05)
            shf = ShardedPitchShift(wf, mesh)
            out[f"{tag}/restored_same_bank"] = (
                shf.wrapper.pqmf is not wf.pqmf
                and torch.equal(shf.wrapper.pqmf.hkf, wf.pqmf.hkf)
                and wf.pqmf.mesh is None)
            _, yf = shf(shf.init_state(), xw[..., :1024])
            out[f"{tag}/restored_y"] = _full(yf)

            # the torchaudio variant over the mesh (8 bands)
            ta = PQMFPitchShiftWrapperTA(100, 8, 2048, device="cpu",
                                         mesh=mesh)
            counts.reset()
            out[f"{tag}/ta_y"] = _full(ta.pitchshifter(xw))
            out[f"{tag}/ta_counts"] = (counts.n["all_reduce"],
                                       max(counts.k1_rows))
            tau = PQMFPitchShiftWrapperTA(100, 8, 2048, device="cpu")
            out[f"{tag}/ta_y_port"] = _full(tau.pitchshifter(xw))

            # odd shards: ShardedPitchShift keeps the bands unsharded
            w4 = PQMFPitchShiftWrapper(70, 4, m_buffer_size=256,
                                       device="cpu")
            x4 = torch.from_numpy(signal(3, (2, 1, 256), 0.1))
            sh4 = ShardedPitchShift(w4, mesh)
            counts.reset()
            t4, y4 = sh4(sh4.init_state(), x4)
            out[f"{tag}/odd_y"], out[f"{tag}/odd_tail"] = _full(y4), _full(t4)
            out[f"{tag}/odd_sharded"] = sh4.wrapper.pqmf.mesh is not None
            st4, yu4 = w4.pitchshift_fn(w4.init_state(), x4)
            out[f"{tag}/odd_y_port"] = _full(yu4)
            out[f"{tag}/odd_tail_port"] = _full(st4["prev_tail"])
            out[f"{tag}/Mb"] = Mb

        # bad meshes: one dim, odd shards
        one = _mesh((WORLD,), names=("data",))
        odd = _mesh((1, 4))
        refused = []
        for build in (lambda: PQMF(70, 8, device="cpu", mesh=one),
                      lambda: StreamingPQMF(70, 8, device="cpu", mesh=one),
                      lambda: StreamingPQMF(70, 4, device="cpu", mesh=odd),
                      lambda: PQMF(70, 4, device="cpu", mesh=odd),
                      lambda: PQMFWrapper(70, 4, device="cpu", mesh=odd)):
            try:
                build()
                refused.append("")
            except ValueError as e:
                refused.append(str(e))
        out["refused"] = np.asarray(refused)
    finally:
        counts.undo()


# -- the training ranks ------------------------------------------------------------


def train_ranks(rank, world, out):
    """Data-parallel training on a (2, 2) mesh of the 4 ranks: one step
    against the unsharded step, a few TrainablePQMF steps, a short
    fine-tune, and the refusal of a batch that does not split."""
    from pqmf_tpu_torch.ops import filterbank as fb
    from pqmf_tpu_torch.parallel import training as tt

    mesh = _mesh((2, 2))
    hk = fb.build_filterbank(70, 4)["hk"]
    x = torch.from_numpy(signal(2, (8, 1, 256)))
    init_s, step_s = tt.make_train_step(mesh=mesh, device="cpu")
    ss, loss_s = step_s(init_s(hk), x)
    out["step_loss"], out["step_hk"] = float(loss_s), _full(ss.hk)
    init_u, step_u = tt.make_train_step(device="cpu")
    su, loss_u = step_u(init_u(hk), x)
    out["step_loss_port"], out["step_hk_port"] = float(loss_u), _full(su.hk)
    init_e, step_e = tt.make_train_step(mesh=mesh, device="cpu")
    se, loss_e = step_e.eager(init_e(hk), x)
    out["eager_hk"] = _full(se.hk)

    model = tt.TrainablePQMF(70, 4, mesh=mesh, device="cpu")
    xm = torch.from_numpy(signal(1, (8, 1, 512)))
    out["trainable_losses"] = [model.train_batch(xm) for _ in range(5)]

    params, losses = tt.finetune_filterbank(70, 8, steps=6, batch=4,
                                            length=1024, lr=3e-5, mesh=mesh,
                                            device="cpu")
    out["finetune_hk"], out["finetune_losses"] = params["hk"], losses
    try:
        step_s(init_s(hk), x[:6])
        out["uneven"] = ""
    except ValueError as e:
        out["uneven"] = str(e)
