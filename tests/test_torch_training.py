"""pqmf_tpu_torch's filterbank fine-tuning (``parallel/training.py``)
against pqmf_tpu on the CPU, on the same NumPy-seeded inputs.

Tolerances: in float64 (JAX under its scoped x64 context, never the global
flag) the fine-tune loss, the plain reconstruction loss and their
gradients agree to 1e-10 relative (of the loss; of max|g| for the
gradient), and five Adam steps to 1e-10 absolute in ``hk``. In float32 at
full width (M=16, 512 taps, [4, 1, 8192]) the loss agrees to 1e-4
relative and the gradient to 1e-3 of max|g|: the loss is the MSE of a
residual about 1e-3 of the signal, so the two conv libraries' f32
summation orders show up amplified. Over many f32 steps Adam turns a
gradient entry whose sign is inside that rounding into a step of about
one lr, so whole training runs are held per step to 1e-3 relative in the
loss and to one lr in ``hk``.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from pqmf_tpu.ops import filterbank as jfb
from pqmf_tpu.parallel import training as jt
from pqmf_tpu_torch.cli import finetune_bank as cli
from pqmf_tpu_torch.ops import filterbank as tfb
from pqmf_tpu_torch.parallel import training as tt
from pqmf_tpu_torch.streaming import StreamingPQMF
from pqmf_tpu_torch.utils.audio import write_wav

F64 = 1e-10


def _noise(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _hk(attenuation, n_band, dtype=np.float32):
    return np.asarray(jfb.build_filterbank(attenuation, n_band)["hk"], dtype)


@contextlib.contextmanager
def _jax_dtype(dtype):
    """JAX in float64 inside the block when ``dtype`` is float64 (the x64
    context is scoped: the suite's global flag stays off)."""
    with jax.enable_x64(dtype == np.float64):
        yield


def _jax_loss_grad(loss_fn, hk, x, dtype):
    with _jax_dtype(dtype):
        loss, g = jax.value_and_grad(loss_fn)(jnp.asarray(hk), jnp.asarray(x))
        return float(loss), np.asarray(g)


def _close(loss, grad, ref_loss, ref_grad, loss_rtol, grad_rtol):
    assert abs(float(loss) - ref_loss) <= loss_rtol * abs(ref_loss), \
        (float(loss), ref_loss)
    err = np.abs(grad.numpy() - ref_grad).max() / np.abs(ref_grad).max()
    assert err <= grad_rtol, err


# -- the loss side ------------------------------------------------------------


@pytest.mark.parametrize("dtype,loss_rtol,grad_rtol", [
    (np.float64, F64, F64), (np.float32, 1e-4, 1e-3)])
def test_finetune_loss_and_grad_match_jax_full_width(dtype, loss_rtol,
                                                     grad_rtol):
    hk, x = _hk(100, 16, dtype), _noise((4, 1, 8192), 0, dtype)
    ref = _jax_loss_grad(jt.make_finetune_loss(16, 512), hk, x, dtype)
    got = tt.loss_and_grad(tt.make_finetune_loss(16, 512),
                           torch.from_numpy(hk), torch.from_numpy(x))
    assert got[0].dtype == got[1].dtype == torch.from_numpy(hk).dtype
    _close(*got, *ref, loss_rtol, grad_rtol)


@pytest.mark.parametrize("atten,M,T", [(70, 8, 1024), (100, 16, 8192)])
def test_reconstruction_loss_and_grad_match_jax_f64(atten, M, T):
    hk, x = _hk(atten, M, np.float64), _noise((2, 1, T), 1, np.float64)
    ref = _jax_loss_grad(jt.reconstruction_loss, hk, x, np.float64)
    got = tt.loss_and_grad(tt.reconstruction_loss, torch.from_numpy(hk),
                           torch.from_numpy(x))
    _close(*got, *ref, F64, F64)


def test_analysis_and_synthesis_from_hk_match_jax():
    hk, x = _hk(100, 16), _noise((2, 1, 2048), 2)
    sub = tt.analysis_from_hk(torch.from_numpy(x), torch.from_numpy(hk))
    ref = jt.analysis_from_hk(jnp.asarray(x), jnp.asarray(hk))
    np.testing.assert_allclose(sub.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=1e-4)
    y = tt.synthesis_from_hk(sub, torch.from_numpy(hk))
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jt.synthesis_from_hk(ref, jnp.asarray(hk))),
        atol=2e-5, rtol=1e-4)


def test_finetune_loss_trim_and_stopband_weight_match_jax():
    """A given trim and stopband weight reach the loss as in JAX (f64)."""
    hk, x = _hk(70, 8, np.float64), _noise((2, 1, 1024), 3, np.float64)
    ref = _jax_loss_grad(jt.make_finetune_loss(8, hk.shape[-1], trim=100,
                                               stopband_weight=1e-2),
                         hk, x, np.float64)
    got = tt.loss_and_grad(
        tt.make_finetune_loss(8, hk.shape[-1], trim=100,
                              stopband_weight=1e-2),
        torch.from_numpy(hk), torch.from_numpy(x))
    _close(*got, *ref, F64, F64)


# -- the tier conv's gradients ------------------------------------------------


def _split64(a):
    hi, lo = tfb.split_bf16(a)
    return hi.double(), lo.double()


@pytest.mark.parametrize("precision", ["bf16x3", "default"])
@pytest.mark.parametrize("stride", [1, 4])
def test_tier_conv_grads_match_split_reference(precision, stride):
    """The tier conv's gradients equal split-operand transposed convs
    computed another way (``conv_transpose1d`` and an unfolded einsum, in
    float64 over the exact bf16 halves): each at the forward's tier, with
    the cotangent split like the other operand (not rounded to bf16)."""
    g = torch.Generator().manual_seed(stride)
    x = torch.randn(2, 3, 67, generator=g, requires_grad=True)
    w = torch.randn(5, 3, 9, generator=g, requires_grad=True)
    y = tfb._conv1d(x, w, stride=stride, padding=(4, 3), precision=precision)
    ct = torch.randn(y.shape, generator=g)
    gx, gw = torch.autograd.grad(y, (x, w), ct)

    xp = F.pad(x.detach(), (4, 3))
    (xh, xl), (wh, wl), (ch, cl) = (_split64(xp), _split64(w.detach()),
                                    _split64(ct))
    pairs_x = [(ch, wh)] + ([(ch, wl), (cl, wh)]
                            if precision == "bf16x3" else [])
    pairs_w = [(xh, ch)] + ([(xh, cl), (xl, ch)]
                            if precision == "bf16x3" else [])
    Tp = xp.shape[-1]
    ref_x = 0
    for c, k in pairs_x:
        full = F.conv_transpose1d(c, k, stride=stride)
        ref_x = ref_x + F.pad(full, (0, Tp - full.shape[-1]))
    ref_x = ref_x[..., 4:Tp - 3]
    ref_w = 0
    for a, c in pairs_w:
        win = a.unfold(-1, w.shape[-1], stride)[..., :c.shape[-1], :]
        ref_w = ref_w + torch.einsum("bot,bitl->oil", c, win)
    for got, ref in ((gx, ref_x), (gw, ref_w)):
        err = (got.double() - ref).abs().max() / ref.abs().max()
        assert err <= 1e-6, err


def test_highest_conv_grads_equal_f_conv1d():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 50, generator=g, requires_grad=True)
    w = torch.randn(4, 3, 7, generator=g, requires_grad=True)
    ct = torch.randn(2, 4, 44 + 5, generator=g)
    got = torch.autograd.grad(tfb._conv1d(x, w, padding=(2, 3)), (x, w), ct)
    ref = torch.autograd.grad(F.conv1d(F.pad(x, (2, 3)), w), (x, w), ct)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


# -- the step -----------------------------------------------------------------


@pytest.mark.parametrize("steps", [10, 8000])
def test_cosine_schedule_matches_optax(steps):
    """Every count of the run and past it; XLA's float32 cosine is within
    a few ulps of the correctly rounded one, ``1 + cos`` near pi makes
    that a few 1e-7 of the peak."""
    lr = 2e-5
    counts = np.arange(steps + 2, dtype=np.int32)
    ref = np.asarray(jax.jit(jax.vmap(optax.cosine_decay_schedule(
        lr, steps)))(counts))
    sched = tt.cosine_decay_schedule(lr, steps)
    got = np.array([sched(int(c)) for c in counts])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * lr)
    assert got[0] == np.float32(lr) and got[-1] == 0.0


def _jax_adam(schedule, lr, steps):
    return optax.adam(optax.cosine_decay_schedule(lr, steps)
                      if schedule == "cosine" else lr)


def _port_adam(schedule, lr, steps):
    return tt.adam(tt.cosine_decay_schedule(lr, steps)
                   if schedule == "cosine" else lr)


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_adam_steps_match_jax_f64(schedule):
    """Five Adam steps of the fine-tune loss at full width (the committed
    recipe's shapes and peak lr)."""
    hk, steps = _hk(100, 16, np.float64), 5
    xs = _noise((steps, 4, 1, 8192), 4, np.float64)
    with _jax_dtype(np.float64):
        init, step = jt.make_train_step(_jax_adam(schedule, 2e-5, steps),
                                        loss_fn=jt.make_finetune_loss(16,
                                                                      512))
        s = init(jnp.asarray(hk))
        ref = []
        for x in xs:
            s, loss = step(s, jnp.asarray(x))
            ref.append(float(loss))
        ref_hk = np.asarray(s.hk)
    init, step = tt.make_train_step(_port_adam(schedule, 2e-5, steps),
                                    loss_fn=tt.make_finetune_loss(16, 512),
                                    device="cpu")
    state = init(hk)
    got = [float(step(state, x)[1]) for x in xs]
    assert state.hk.dtype == torch.float64 and state.count == steps
    # under x64 optax evaluates the cosine schedule in float64, the port in
    # float32 (as optax does in the float32 runs): a few 1e-8 of the lr
    np.testing.assert_allclose(got, ref, rtol=F64 if schedule == "constant"
                               else 1e-6)
    np.testing.assert_allclose(state.hk.detach().numpy(), ref_hk, rtol=0,
                               atol=F64)


def test_remat_step_matches_plain():
    """The counterpart of the JAX package's remat test: one step with the
    loss recomputed in the backward equals the plain step."""
    hk = _hk(70, 4)
    x = _noise((2, 1, 256), 5)
    sa, la = _one_step(hk, x, remat=False)
    sb, lb = _one_step(hk, x, remat=True)
    assert abs(float(la) - float(lb)) < 1e-7
    np.testing.assert_allclose(sb.hk.detach().numpy(),
                               sa.hk.detach().numpy(), atol=1e-7)


def _one_step(hk, x, **kwargs):
    init, step = tt.make_train_step(device="cpu", **kwargs)
    return step(init(hk), x)


def test_trainable_pqmf_matches_jax():
    """TrainablePQMF (Adam 1e-4 on the plain round-trip MSE) over five
    batches, float32."""
    x = _noise((8, 1, 512), 1)
    jm = jt.TrainablePQMF(70, 4)
    tm = tt.TrainablePQMF(70, 4, device="cpu")
    ref = [jm.train_batch(jnp.asarray(x)) for _ in range(5)]
    got = [tm.train_batch(x) for _ in range(5)]
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    np.testing.assert_allclose(tm.hk.detach().numpy(), np.asarray(jm.hk),
                               rtol=0, atol=1e-4)  # one lr


def test_step_keeps_the_batch_device_rule():
    init, step = tt.make_train_step(device="cpu")
    state = init(_hk(70, 4))
    state, loss = step(state, torch.from_numpy(_noise((1, 1, 256), 0)))
    assert loss.ndim == 0 and not loss.requires_grad
    assert state.hk.requires_grad and state.hk.grad is not None


# -- checkpoints --------------------------------------------------------------


def _jax_state(schedule, hk, xs):
    init, step = jt.make_train_step(_jax_adam(schedule, 1e-3, 6))
    s = init(jnp.asarray(hk))
    for x in xs:
        s, _ = step(s, jnp.asarray(x))
    return s, step


def _port_state(schedule, hk, xs):
    init, step = tt.make_train_step(_port_adam(schedule, 1e-3, 6),
                                    device="cpu")
    s = init(hk)
    for x in xs:
        step(s, x)
    return s, step, init


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_jax_checkpoint_resumes_in_the_port(schedule, tmp_path):
    hk, xs = _hk(70, 8, np.float64), _noise((4, 2, 1, 512), 6, np.float64)
    path = str(tmp_path / "jax.npz")
    with _jax_dtype(np.float64):
        s, step = _jax_state(schedule, hk, xs[:2])
        jt.save_train_state(s, path)
        for x in xs[2:]:
            s, loss = step(s, jnp.asarray(x))
        ref_hk, ref_loss = np.asarray(s.hk), float(loss)
    _, step, init = _port_state(schedule, hk, [])
    state = tt.load_train_state(init(hk), path)
    assert state.count == 2
    for x in xs[2:]:
        _, loss = step(state, x)
    assert abs(float(loss) - ref_loss) <= F64 * ref_loss
    np.testing.assert_allclose(state.hk.detach().numpy(), ref_hk, rtol=0,
                               atol=F64)


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_port_checkpoint_resumes_in_jax(schedule, tmp_path):
    hk, xs = _hk(70, 8, np.float64), _noise((4, 2, 1, 512), 7, np.float64)
    path = str(tmp_path / "port.npz")
    state, step, _ = _port_state(schedule, hk, xs[:2])
    tt.save_train_state(state, path)
    for x in xs[2:]:
        _, loss = step(state, x)
    with _jax_dtype(np.float64):
        template, jstep = _jax_state(schedule, hk, [])
        s = jt.load_train_state(template, path)
        for x in xs[2:]:
            s, ref_loss = jstep(s, jnp.asarray(x))
        ref_hk = np.asarray(s.hk)
    assert abs(float(loss) - float(ref_loss)) <= F64 * float(ref_loss)
    np.testing.assert_allclose(state.hk.detach().numpy(), ref_hk, rtol=0,
                               atol=F64)


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_port_checkpoint_round_trip_is_bit_exact(schedule, tmp_path):
    hk, xs = _hk(70, 8), _noise((3, 2, 1, 512), 8)
    state, step, init = _port_state(schedule, hk, xs[:2])
    path = tt.save_train_state(state, str(tmp_path / "ckpt.npz"))
    with np.load(path) as z:
        assert sorted(z.files) == [f"leaf_{i}" for i in range(
            5 if schedule == "cosine" else 4)]
        assert z["leaf_1"].dtype == np.int32 and z["leaf_1"] == 2
    restored = tt.load_train_state(init(hk), path)
    assert torch.equal(restored.hk, state.hk)
    a, b = state.optimizer.state[state.hk], restored.optimizer.state[
        restored.hk]
    for k in ("exp_avg", "exp_avg_sq"):
        assert torch.equal(a[k], b[k]), k
    _, l1 = step(restored, xs[2])
    _, l2 = step(state, xs[2])
    assert float(l1) == float(l2)
    assert torch.equal(restored.hk, state.hk)


def test_fresh_state_checkpoints_as_zero_moments(tmp_path):
    """Before any step the moments are zeros and the count 0, as in JAX's
    freshly initialized state."""
    hk = _hk(70, 4)
    init, _ = tt.make_train_step(device="cpu")
    path = tt.save_train_state(init(hk), str(tmp_path / "fresh.npz"))
    ref = str(tmp_path / "jax.npz")
    jt.save_train_state(jt.make_train_step()[0](jnp.asarray(hk)), ref)
    with np.load(path) as got, np.load(ref) as want:
        assert got.files == want.files
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- finetune_filterbank ------------------------------------------------------


def test_noise_batches_equal_jax_single_draw():
    """Across two chunk boundaries and a short last chunk."""
    steps = 2 * tt.NOISE_CHUNK + 5
    got = torch.stack(list(tt.noise_batches(3, steps, 2, 16, "cpu")))
    ref = np.random.default_rng(3).standard_normal(
        (steps, 2, 1, 16)).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_finetune_improves_interior_reconstruction():
    """The counterpart of the JAX package's test: a short run lowers the
    loss, improves held-out interior reconstruction through the port's
    StreamingPQMF and keeps the stopband."""
    params, losses = tt.finetune_filterbank(70, 8, steps=60, batch=4,
                                            length=1024, lr=3e-5,
                                            device="cpu")
    assert losses.shape == (60,) and losses.dtype == np.float32
    assert losses[-1] < losses[0]
    x = _noise((1, 1, 8 * 1024), 7)
    P = params["hk"].shape[-1]

    def interior_mse(sp):
        y = sp.roundtrip(x).numpy()
        return float(np.mean((y - x)[..., P:-P] ** 2))

    sp0 = StreamingPQMF(70, 8, device="cpu")
    sp1 = StreamingPQMF(70, 8, device="cpu")
    sp1.set_weights(params)
    assert interior_mse(sp1) < interior_mse(sp0)
    assert tt.worst_stopband_db(params["hk"]) < -40


def test_finetune_run_matches_jax():
    """The whole path, float32: the same run in both packages."""
    kw = dict(steps=60, batch=4, length=1024, lr=3e-5)
    ref_params, ref = jt.finetune_filterbank(70, 8, **kw)
    params, got = tt.finetune_filterbank(70, 8, device="cpu", **kw)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-3)
    np.testing.assert_allclose(params["hk"], np.asarray(ref_params["hk"]),
                               rtol=0, atol=kw["lr"])
    for k in ("h", "hk_poly", "hk_ipoly"):
        assert params[k].shape == np.asarray(ref_params[k]).shape, k
    np.testing.assert_array_equal(params["h"], np.asarray(ref_params["h"]))


def test_worst_stopband_matches_the_committed_bank():
    """The committed M=16 bank's worst stopband, as the JAX package's test
    computes it: -59.8 dB (its bar at M=16 is -55 dB)."""
    db = tt.worst_stopband_db(tt.load_pretrained_bank()["hk"])
    assert -60.0 < db < -59.5, db
    assert tt.worst_stopband_db(_hk(100, 16)) < -90


# -- errors -------------------------------------------------------------------


def test_finetune_loss_refuses_an_empty_interior():
    loss_fn = tt.make_finetune_loss(8, 256)
    with pytest.raises(ValueError, match="must exceed 2\\*trim=512"):
        loss_fn(torch.from_numpy(_hk(70, 8)),
                torch.zeros(1, 1, 512))


@pytest.mark.parametrize("kwargs,match", [
    ({"length": 256}, "must exceed 2\\*n_taps=256"),
    ({"lr_schedule": "linear"}, "unknown lr_schedule"),
])
def test_finetune_filterbank_refuses(kwargs, match):
    with pytest.raises(ValueError, match=match):
        tt.finetune_filterbank(70, 8, **{"steps": 1, "length": 1024,
                                         "device": "cpu", **kwargs})


@pytest.mark.parametrize("build", [
    lambda: tt.make_train_step(mesh=object(), device="cpu"),
    lambda: tt.TrainablePQMF(70, 4, mesh=object(), device="cpu"),
    lambda: tt.finetune_filterbank(70, 8, steps=1, length=1024,
                                   mesh=object(), device="cpu"),
], ids=["make_train_step", "TrainablePQMF", "finetune_filterbank"])
def test_mesh_is_refused(build):
    """What is not a 2-D (data, band) mesh is refused: data-parallel
    training over a real one is held against JAX in
    tests/test_torch_mesh_train.py."""
    with pytest.raises(ValueError, match="2-axis"):
        build()


def test_step_refuses_a_batch_on_another_device():
    init, step = tt.make_train_step(device="cpu")
    state = init(_hk(70, 4))
    with pytest.raises(ValueError, match="batch is on meta"):
        step(state, torch.zeros(1, 1, 256, device="meta"))


@pytest.mark.parametrize("build", [
    lambda: tt.make_train_step(device="cuda"),
    lambda: tt.TrainablePQMF(70, 4, device="cuda"),
    lambda: tt.finetune_filterbank(70, 8, steps=1, length=1024,
                                   device="cuda"),
    lambda: tt.roundtrip_snr(None, 70, 8, np.zeros(4096, np.float32),
                             device="cuda"),
], ids=["make_train_step", "TrainablePQMF", "finetune_filterbank",
        "roundtrip_snr"])
def test_cuda_without_a_card_raises(build):
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        build()


# -- the readout, the CLI, the surface ----------------------------------------


@pytest.fixture(scope="module")
def bench_wav(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("wav") / "bench10s.wav")
    write_wav(path, cli.bench_signal(10 * 44100), 44100)
    return path


@pytest.mark.parametrize("bank", [None, "hk16_atten100_finetuned"])
def test_streaming_roundtrip_snr_matches_jax(bank, bench_wav):
    """The readout behind every committed bank's number, on 10 s of the
    JAX package's bench.py signal (PCM16): the designed bank within 0.01
    dB, the committed bank within 0.05 dB. Both readouts are float32: at
    104 dB the port's CPU convs' round-off (each stage ~128 dB from
    float64) moves the readout by ~0.03 dB (float64: 104.2600 dB; JAX
    104.2548, the port 104.2269 here)."""
    ref = jt.streaming_roundtrip_snr(
        None if bank is None else jt.load_pretrained_bank(bank), 100, 16,
        bench_wav, use_pallas=False)
    got = tt.streaming_roundtrip_snr(
        None if bank is None else tt.load_pretrained_bank(bank), 100, 16,
        bench_wav, device="cpu")
    assert abs(got - ref) <= (0.05 if bank else 0.01), (got, ref)
    assert got > (100 if bank else 70), got


def test_bench_signal_is_bench_py_signal():
    import bench

    np.testing.assert_array_equal(cli.bench_signal(4096), bench._signal(4096))


@pytest.mark.parametrize("with_wav", [True, False], ids=["wav", "signal"])
def test_finetune_cli_writes_a_loadable_bank(with_wav, bench_wav, tmp_path,
                                             monkeypatch, capsys):
    args = ["--n_band", "8", "--attenuation", "70", "--steps", "2",
            "--batch", "2", "--length", "1024", "--device", "cpu",
            "--out", str(tmp_path / "hk8_test")]
    if with_wav:
        args += ["--wav", bench_wav, "--wav", bench_wav]
    assert cli.main(args) == 0
    out = capsys.readouterr().out
    assert "noise interior loss" in out and "worst stopband" in out
    assert out.count("bench10s.wav" if with_wav
                     else "60 s test signal") == (4 if with_wav else 2)
    assert (tmp_path / "hk8_test.npz").exists()
    monkeypatch.setattr(tt, "BANK_DIR", tmp_path)
    params = tt.load_pretrained_bank("hk8_test")
    base = tfb.build_filterbank(70, 8)
    assert params["hk"].shape == base["hk"].shape
    np.testing.assert_array_equal(params["h"], base["h"])
    assert not np.array_equal(params["hk"], base["hk"])


def test_finetune_cli_requires_out_and_defaults_to_the_card():
    p = cli.build_parser()
    with pytest.raises(SystemExit):
        p.parse_args(["--n_band", "16"])
    a = p.parse_args(["--n_band", "16", "--out", "x.npz"])
    assert (a.device, a.steps, a.batch, a.length, a.lr, a.seed,
            a.attenuation, a.wav) == ("cuda", 8000, 4, 8192, 2e-5, 0, 100.0,
                                      None)


def test_models_reexport_matches_jax():
    from pqmf_tpu import models as jmodels
    from pqmf_tpu_torch import models, pipelines

    assert models.__all__ == jmodels.__all__
    assert models.TrainablePQMF is tt.TrainablePQMF
    assert models.PQMFPitchShiftWrapper is pipelines.PQMFPitchShiftWrapper


def test_chained_ms_and_trace_on_the_cpu(tmp_path):
    import time

    from pqmf_tpu_torch.utils import profiling

    ms = profiling.chained_ms(lambda v: (time.sleep(0.002), v)[1],
                              torch.zeros(4), n=5, repeats=2)
    assert 1.5 < ms < 50, ms
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64).sum()
    assert prof.key_averages()
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
