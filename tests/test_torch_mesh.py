"""The port's (data, band) mesh against the JAX package, on the CPU.

Four gloo ranks (``torch_mesh_ranks``: spawned once for this module, each
on one thread, joined within 120 s) run ``pqmf_tpu_torch`` over meshes
(1, 4) and (2, 2) of ``DeviceMesh("cpu")``; the JAX references run here,
on conftest's virtual CPU devices, on the lax path as
``tests/test_parallel.py`` runs it (the same values as the Pallas path in
interpret mode, which that file holds). Every input is made from a seed
with numpy on both sides. Tolerances: the filterbanks against JAX's
unsharded output within atol 2e-5, rtol 1e-4 (the kernels' bar); the
pitch shifters against JAX's at >= 90 dB; the port sharded against the
port unsharded within 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

import pqmf_tpu_torch as pt
from pqmf_tpu_torch.parallel.sharding import make_mesh, mesh_shape
from torch_mesh_ranks import SHAPES, Ranks, mesh_ranks, signal

TOL_JAX = dict(atol=2e-5, rtol=1e-4)
TOL_PORT = dict(atol=1e-5, rtol=1e-5)
BAR_DB = 90.0
TAGS = [f"{d}x{b}" for d, b in SHAPES]


def _snr_db(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.sum((got - ref) ** 2)
    return float(10 * np.log10(np.sum(ref ** 2) / max(err, 1e-300)))


def _assert_db(got, ref, what=""):
    """>= BAR_DB against ref; an all-zero ref (a tail a batch of two
    passes through untouched) must be matched exactly."""
    assert got.shape == ref.shape, what
    if not np.any(ref):
        np.testing.assert_array_equal(got, ref, err_msg=what)
    else:
        assert _snr_db(got, ref) >= BAR_DB, what


def _jax_refs() -> dict:
    """The JAX package on the same seeded inputs."""
    from jax.sharding import Mesh

    import pqmf_tpu.pipelines as jp
    from pqmf_tpu import PQMF as JPQMF
    from pqmf_tpu.parallel.sharding import ShardedPitchShift as JSharded
    from pqmf_tpu.parallel.sharding import make_mesh as jmake
    from pqmf_tpu.streaming import StreamingPQMF as JStreaming

    x = signal(0, (2, 1, 4096))
    xw = signal(1, (2, 1, 2048), 0.1)
    blocks1 = signal(2, (3, 1, 1, 2048), 0.1)
    ref = {}
    sp = JStreaming(100, 16, use_pallas=False)
    sub = sp.forward(x)
    ref["sp_forward"], ref["sp_inverse"] = sub, sp.inverse(sub)
    ref["sp_roundtrip"] = sp.roundtrip(x)
    ref["sp_causal"] = sp.inverse_causal(sp.forward_causal(x))
    state, ys = sp.init_state(2), []
    for blk in np.split(x, 4, axis=-1):
        state, y = sp.process_block(state, blk)
        ys.append(np.asarray(y))
    ref["sp_stream"] = np.concatenate(ys, axis=-1)
    ref["sp_stream_state"] = state["synthesis"]
    pq = JPQMF(100, 16, use_pallas=False)
    psub = pq.forward(x)
    ref["pq_forward"], ref["pq_inverse"] = psub, pq.inverse(psub)
    ref["pq_roundtrip"] = pq.roundtrip(x)
    ref["wrap_rec"], ref["wrap_sub"] = jp.PQMFWrapper(
        100, 16, use_pallas=False).process(xw)
    x2 = signal(4, (2, 2, 2048))
    for name, f2 in (("sp", JStreaming(100, 16, use_pallas=False,
                                       n_channels=2)),
                     ("pq", JPQMF(100, 16, n_channels=2, use_pallas=False))):
        sub2 = f2.forward(x2)
        ref[f"{name}_stereo_forward"] = sub2
        ref[f"{name}_stereo_inverse"] = f2.inverse(sub2)

    w = jp.PQMFPitchShiftWrapper(100, 16, 2048, use_pallas=False)
    sh = JSharded(w, jmake(4, n_band=16))
    ref["sps_tail2"], ref["sps_y2"] = sh(sh.init_state(), xw)
    tail, ys = sh.init_state(), []
    for blk in blocks1:
        tail, y = sh(tail, blk)
        ys.append(np.asarray(y))
    ref["sps_y1"], ref["sps_tail1"] = np.stack(ys), tail
    # the streams step on a (data 2, band 2) mesh of 4 devices
    mesh22 = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                  ("data", "band"))
    wm = jp.PQMFPitchShiftWrapper(100, 16, 2048, use_pallas=False,
                                  mesh=mesh22)
    states, ref["streams_y"] = wm.pitchshift_streams(wm.init_streams(2),
                                                     xw[:, 0])
    ref["streams_tail"] = states["prev_tail"]

    wf = jp.PQMFPitchShiftWrapper(70, 16, m_buffer_size=1024,
                                  use_pallas=False)
    wf.pqmf.set_weights({k: np.asarray(v) * 1.05
                         for k, v in wf.pqmf.params.items()},
                        np.asarray(wf.pqmf.hkf) * 1.05,
                        np.asarray(wf.pqmf.hki) * 1.05)
    shf = JSharded(wf, jmake(4, n_band=16))
    ref["restored_y"] = shf(shf.init_state(), xw[..., :1024])[1]

    ref["ta_y"] = jp.PQMFPitchShiftWrapperTA(
        100, 8, 2048, use_pallas=False).pitchshifter(xw)

    w4 = jp.PQMFPitchShiftWrapper(70, 4, m_buffer_size=256,
                                  use_pallas=False)
    sh4 = JSharded(w4, jmake(4, n_band=4))
    ref["odd_tail"], ref["odd_y"] = sh4(sh4.init_state(),
                                        signal(3, (2, 1, 256), 0.1))
    return {k: np.asarray(v) for k, v in ref.items()}


def _port_refs() -> dict:
    """The port unsharded, here, where a rank does not compute it."""
    x = signal(0, (2, 1, 4096))
    xw = signal(1, (2, 1, 2048), 0.1)
    ref = {}
    sp = pt.StreamingPQMF(100, 16, device="cpu")
    ref["sp_forward"] = sp.forward(x)
    ref["sp_inverse"] = sp.inverse(ref["sp_forward"])
    ref["sp_causal"] = sp.inverse_causal(sp.forward_causal(x))
    pq = pt.PQMF(100, 16, device="cpu")
    ref["pq_forward"] = pq.forward(x)
    ref["pq_inverse"] = pq.inverse(ref["pq_forward"])
    ref["wrap_rec"], ref["wrap_sub"] = pt.PQMFWrapper(
        100, 16, device="cpu").process(xw)
    wf = pt.PQMFPitchShiftWrapper(70, 16, 1024, device="cpu")
    wf.pqmf.set_weights({k: v * 1.05 for k, v in wf.pqmf.params.items()},
                        wf.pqmf.hkf * 1.05, wf.pqmf.hki * 1.05)
    ref["restored_y"] = wf.pitchshift_fn(wf.init_state(),
                                         xw[..., :1024])[1]
    return {k: v.numpy() for k, v in ref.items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(every rank's results, JAX's, the port's unsharded): the ranks
    compute while this process runs the references."""
    ranks = Ranks(mesh_ranks, tmp_path_factory.mktemp("mesh"))
    try:
        jax_ref, port_ref = _jax_refs(), _port_refs()
    finally:
        out = ranks.join()
    return out, jax_ref, port_ref


def test_make_mesh_shapes():
    """The pure shape helper against JAX's make_mesh at world 4 and 8,
    n_band 4 and 16."""
    from pqmf_tpu.parallel.sharding import make_mesh as jmake

    for n in (4, 8):
        for nb in (4, 16):
            assert mesh_shape(n, nb) == jmake(n, n_band=nb).devices.shape
    assert mesh_shape(8, 4) == (2, 4) and mesh_shape(8, 16) == (1, 8)


def test_make_mesh_without_a_process_group_raises():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(4, n_band=16, device_type="cpu")


def test_every_rank_holds_the_same_global_values(run):
    out = run[0]
    for r in range(1, len(out)):
        assert out[r].keys() == out[0].keys()
        for k in out[0]:
            if k.endswith("_counts") or k.endswith("shard_rows"):
                continue  # this rank's own
            np.testing.assert_array_equal(out[r][k], out[0][k], err_msg=k)


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("what", ["sp_forward", "sp_inverse", "sp_roundtrip",
                                  "sp_causal", "sp_stream",
                                  "sp_stream_state"])
def test_streaming_pqmf_matches_jax(run, tag, what):
    """StreamingPQMF(mesh=) offline, causal and streaming (four blocks,
    the state carried) against JAX's unsharded StreamingPQMF."""
    out, jax_ref, _ = run
    np.testing.assert_allclose(out[0][f"{tag}/{what}"], jax_ref[what],
                               **TOL_JAX)


@pytest.mark.parametrize("tag", TAGS)
def test_streaming_pqmf_matches_the_port_unsharded(run, tag):
    out, _, port = run
    for what in ("sp_forward", "sp_inverse", "sp_causal"):
        np.testing.assert_allclose(out[0][f"{tag}/{what}"], port[what],
                                   err_msg=what, **TOL_PORT)
    # streaming blocks are the causal round trip, and scan_blocks the loop
    np.testing.assert_allclose(out[0][f"{tag}/sp_stream"],
                               out[0][f"{tag}/sp_causal"], **TOL_PORT)
    np.testing.assert_allclose(
        np.concatenate(list(out[0][f"{tag}/sp_scan"]), axis=-1),
        out[0][f"{tag}/sp_stream"], rtol=0, atol=0)


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("what", ["pq_forward", "pq_inverse",
                                  "pq_roundtrip"])
def test_pqmf_matches_jax(run, tag, what):
    out, jax_ref, _ = run
    np.testing.assert_allclose(out[0][f"{tag}/{what}"], jax_ref[what],
                               **TOL_JAX)


@pytest.mark.parametrize("tag", TAGS)
def test_pqmf_matches_the_port_unsharded(run, tag):
    out, _, port = run
    for what in ("pq_forward", "pq_inverse"):
        np.testing.assert_allclose(out[0][f"{tag}/{what}"], port[what],
                                   err_msg=what, **TOL_PORT)


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("what", ["sp_stereo_forward", "sp_stereo_inverse",
                                  "pq_stereo_forward", "pq_stereo_inverse"])
def test_two_channels_over_a_mesh_match_jax(run, tag, what):
    """n_channels = 2 folds the channels into the batch, so a rank's bands
    interleave with the channels in [B, C*M, T']: the forward's output is
    gathered over the band axis, and the inverse takes its bands back."""
    out, jax_ref, _ = run
    np.testing.assert_allclose(out[0][f"{tag}/{what}"], jax_ref[what],
                               **TOL_JAX)


@pytest.mark.parametrize("tag", TAGS)
def test_pqmf_wrapper_process_matches_jax(run, tag):
    out, jax_ref, port = run
    for what in ("wrap_rec", "wrap_sub"):
        np.testing.assert_allclose(out[0][f"{tag}/{what}"], jax_ref[what],
                                   err_msg=what, **TOL_JAX)
        np.testing.assert_allclose(out[0][f"{tag}/{what}"], port[what],
                                   err_msg=what, **TOL_PORT)


@pytest.mark.parametrize("tag", TAGS)
def test_band_axis_stays_partitioned(run, tag):
    """The port's counterpart of the JAX package's HLO tests: every rank's
    K1 bank has Mb = 16/band rows and its K2 bank Mb columns, a synthesis
    is ONE band all-reduce, nothing is gathered before the middle, and no
    K3 or K6 runs under a mesh."""
    out = run[0]
    for r, res in enumerate(out):
        Mb = int(res[f"{tag}/Mb"])
        assert tuple(res[f"{tag}/sp_shard_rows"]) == (Mb, Mb), r
        assert tuple(res[f"{tag}/sp_inverse_counts"]) == (1, 0), r
        # all-reduces, K3 calls, K1 rows, K2 columns
        assert tuple(res[f"{tag}/sp_roundtrip_counts"]) == (1, 0, Mb, Mb), r
        # all-reduces (inverse, roundtrip), K6 calls, K4 rows, K5 columns
        assert tuple(res[f"{tag}/pq_counts"]) == (2, 0, Mb, Mb), r
        # all-reduces, gathers, K1 rows, K2 columns of one sharded step
        assert tuple(res[f"{tag}/sps_counts"]) == (1, 0, Mb, Mb), r
        assert tuple(res[f"{tag}/ta_counts"]) == (1, 8 // (16 // Mb)), r


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("what", ["sps_y2", "sps_tail2", "sps_y1",
                                  "sps_tail1"])
def test_sharded_pitchshift_matches_jax(run, tag, what):
    """ShardedPitchShift at 16 bands: B = 2 (no crossfade) and B = 1 over
    three blocks with the tail carried, against JAX's ShardedPitchShift
    on its (1, 4) mesh (the values do not depend on the mesh)."""
    out, jax_ref, _ = run
    _assert_db(out[0][f"{tag}/{what}"], jax_ref[what], what)


@pytest.mark.parametrize("tag", TAGS)
def test_sharded_pitchshift_matches_unsharded(run, tag):
    out = run[0][0]
    for a, b in (("sps_y2", "ps_y2"), ("sps_tail2", "ps_tail2"),
                 ("sps_y1", "ps_y1"), ("sps_tail1", "ps_tail1"),
                 ("sps_eager_y2", "ps_y2")):
        np.testing.assert_allclose(out[f"{tag}/{a}"], out[f"{tag}/{b}"],
                                   err_msg=a, **TOL_PORT)
    view_sharded, caller_unsharded = out[f"{tag}/sps_view"]
    assert view_sharded and caller_unsharded


@pytest.mark.parametrize("tag", TAGS)
def test_sharded_pitchshift_preserves_restored_weights(run, tag):
    """The view's rebuilt filterbank carries the caller's restored bank
    (x1.05), and the caller's wrapper keeps ``mesh is None``."""
    out, jax_ref, port = run
    assert bool(out[0][f"{tag}/restored_same_bank"])
    got = out[0][f"{tag}/restored_y"]
    np.testing.assert_allclose(got, port["restored_y"], **TOL_PORT)
    _assert_db(got, jax_ref["restored_y"])


@pytest.mark.parametrize("tag", TAGS)
def test_odd_shards_keep_the_bands_replicated(run, tag):
    """4 bands: on (1, 4) the shards would be odd, so ShardedPitchShift
    keeps every band on every rank (the JAX package's replicated kernels),
    and on (2, 2) it band-shards; both against JAX's ShardedPitchShift on
    make_mesh(4, n_band=4) and the port unsharded."""
    out, jax_ref, _ = run
    res = out[0]
    assert bool(res[f"{tag}/odd_sharded"]) == (tag == "2x2")
    for what in ("odd_y", "odd_tail"):
        got = res[f"{tag}/{what}"]
        np.testing.assert_allclose(got, res[f"{tag}/{what}_port"],
                                   err_msg=what, **TOL_PORT)
        _assert_db(got, jax_ref[what], what)


@pytest.mark.parametrize("tag", TAGS)
def test_wrapper_mesh_streams_step_matches_jax(run, tag):
    """The flagship's own mesh: the 2-stream step against JAX's wrapper
    over a (2, 2) mesh and the port unsharded."""
    out, jax_ref, _ = run
    res = out[0]
    for what in ("streams_y", "streams_tail"):
        np.testing.assert_allclose(res[f"{tag}/{what}"],
                                   res[f"{tag}/{what}_port"], err_msg=what,
                                   **TOL_PORT)
        _assert_db(res[f"{tag}/{what}"], jax_ref[what], what)


@pytest.mark.parametrize("tag", TAGS)
def test_stream_ola_over_a_mesh_matches_unsharded(run, tag):
    res = run[0][0]
    got, want = res[f"{tag}/ola"], res[f"{tag}/ola_port"]
    np.testing.assert_allclose(got[0], want[0], **TOL_PORT)
    np.testing.assert_allclose(got[1], want[1], **TOL_JAX)  # K1+K2 vs K3


@pytest.mark.parametrize("tag", TAGS)
def test_ta_wrapper_over_a_mesh_matches_jax(run, tag):
    """PQMFPitchShiftWrapperTA(mesh=) at 8 bands (Mb = 2 or 4)."""
    out, jax_ref, _ = run
    got = out[0][f"{tag}/ta_y"]
    _assert_db(got, jax_ref["ta_y"])
    np.testing.assert_allclose(got, out[0][f"{tag}/ta_y_port"], **TOL_PORT)


@pytest.mark.parametrize("i,match", [(0, "2-axis"), (1, "2-axis"),
                                     (2, "even shards"), (3, "even shards"),
                                     (4, "even shards")],
                         ids=["PQMF-1d", "StreamingPQMF-1d",
                              "StreamingPQMF-odd", "PQMF-odd",
                              "PQMFWrapper-odd"])
def test_bad_mesh_raises_clear_error_everywhere(run, i, match):
    """A one-dim mesh and a mesh of odd band shards raise ValueError, as
    the JAX package's check_band_mesh."""
    for res in run[0]:
        assert match in str(res["refused"][i]), res["refused"]


def test_bad_mesh_raises_without_a_rank():
    """What is not a 2-D mesh at all is refused before any collective."""
    with pytest.raises(ValueError, match="2-axis"):
        pt.StreamingPQMF(70, 8, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="2-axis"):
        pt.PQMF(70, 8, device="cpu", mesh=object())


def test_jax_refuses_the_same_meshes():
    """The JAX package's check, on the same shapes (a premise of the
    test above)."""
    from jax.sharding import Mesh

    from pqmf_tpu.kernels.polyphase import check_band_mesh

    devs = np.asarray(jax.devices()[:4])
    with pytest.raises(ValueError, match="2-axis"):
        check_band_mesh(Mesh(devs, ("data",)), 8)
    with pytest.raises(ValueError, match="even shards"):
        check_band_mesh(Mesh(devs.reshape(1, 4), ("data", "band")), 4)
    assert check_band_mesh(Mesh(devs.reshape(2, 2), ("data", "band")),
                           4) is not None
