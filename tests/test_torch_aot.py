"""The ahead-of-time artifact of pqmf_tpu_torch (``export.py``) on the CPU,
against the live port and against pqmf_tpu's StableHLO program.

Geometry as ``tests/test_export.py``'s AOT tests: atten 100, 8 bands,
1024-sample blocks. The port's program (``torch.export``) is held bit-equal
to the live port over two blocks with the flagship's tail carried; the
JAX package's program (``jax.export``, its Pallas kernels in interpret
mode on the CPU, as its own tests run it) on the same inputs: the flagship
and the TA wrapper >= 90 dB (the JAX package's parity bar), ``PQMFWrapper``
atol 2e-5 / rtol 1e-4 (its kernel-vs-lax bar). Also: the kernel operators'
fake shapes and operand checks, the program's argument checks, the plan
caches after a trace, a failing export, a stale program, cross-package
loading, the device refusal, the ``--stablehlo``
CLIs, the three demos and ``tools/gpu_checks.py`` at ``--device cpu``.
"""

import importlib
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import pqmf_tpu.export as jex
import pqmf_tpu.pipelines as jpl
import pqmf_tpu_torch.export as tex
from pqmf_tpu_torch import (PQMFPitchShiftWrapper, PQMFPitchShiftWrapperTA,
                            PQMFWrapper, StreamingPQMF)
from pqmf_tpu_torch.kernels import cached_conv as cc
from pqmf_tpu_torch.ops import stft as tS
from pqmf_tpu_torch.utils.audio import write_wav
from pqmf_tpu_torch.utils.metrics import snr_db

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, T = 8, 1024
SHIFTS = [0, 4, -5, -12, 3, -7, 2, -3]
TA_SHIFTS = [0, -3, 5, 12, -7, 2, 1, -1]
KINDS = ("flagship", "ta", "plain")
BAR_DB = 90.0
TOL = dict(atol=2e-5, rtol=1e-4)


def _wrapper(kind, precision="highest", pkg="torch"):
    if pkg == "jax":
        return {"flagship": lambda: jpl.PQMFPitchShiftWrapper(
                    100, M, T, 44100, SHIFTS),
                "ta": lambda: jpl.PQMFPitchShiftWrapperTA(
                    100, M, T, 44100, TA_SHIFTS),
                "plain": lambda: jpl.PQMFWrapper(100, M, T)}[kind]()
    kw = dict(precision=precision, device="cpu")
    return {"flagship": lambda: PQMFPitchShiftWrapper(
                100, M, T, 44100, SHIFTS, **kw),
            "ta": lambda: PQMFPitchShiftWrapperTA(
                100, M, T, 44100, TA_SHIFTS, **kw),
            "plain": lambda: PQMFWrapper(100, M, T, **kw)}[kind]()


def _blocks(seed=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, T)).astype(np.float32) * 0.3
            for _ in range(2)]


def _run(kind, fn, blocks, tail=None):
    """Two blocks through ``fn`` with the exported method's signature (the
    flagship's tail carried); a list of output arrays."""
    outs = []
    for x in blocks:
        if kind == "flagship":
            tail, y = fn(tail, x)
            outs.append(y)
        elif kind == "ta":
            outs.append(fn(x[None]))
        else:
            outs.extend(fn(x[None]))
    if kind == "flagship":
        outs.append(tail)
    return [np.asarray(o) for o in outs]


def _live(kind, w):
    if kind == "flagship":
        def step(tail, x):
            state, y = w.pitchshift_fn({"prev_tail": tail},
                                       torch.from_numpy(x))
            return state["prev_tail"], y
        return step
    if kind == "ta":
        return lambda x: w.pitchshifter(torch.from_numpy(x))
    return lambda x: w.process(torch.from_numpy(x))


def _program(kind, fn):
    """``fn`` of the port's program, on NumPy inputs."""
    if kind == "flagship":
        return lambda tail, x: fn(tail, torch.from_numpy(x))
    return lambda x: fn(torch.from_numpy(x))


def _tail0(kind):
    return torch.zeros((M, 32)) if kind == "flagship" else None


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """(kind, precision) -> (live wrapper, artifact path), each exported
    once with its program."""
    root = tmp_path_factory.mktemp("aot")
    out = {}
    for kind in KINDS:
        for precision in ("highest", "bf16x3"):
            w = _wrapper(kind, precision)
            path = str(root / f"{kind}_{precision}")
            tex.save_artifact(w, path, with_stablehlo=True)
            out[kind, precision] = (w, path)
    return out


@pytest.mark.parametrize("precision", ["highest", "bf16x3"])
@pytest.mark.parametrize("kind", KINDS)
def test_program_reload_bit_equal_to_live(saved, kind, precision):
    w, path = saved[kind, precision]
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    method = tex._AOT_METHOD[type(w).__name__]
    assert manifest["torch_export"] == {method: {"length": T,
                                                 "device": "cpu"}}
    assert "stablehlo" not in manifest
    fn = tex.load_stablehlo(path, device="cpu")
    assert fn is not None
    blocks = _blocks()
    got = _run(kind, _program(kind, fn), blocks, _tail0(kind))
    want = _run(kind, _live(kind, w), blocks, _tail0(kind))
    assert len(got) == len(want)
    for g, r in zip(got, want):
        assert g.shape == r.shape
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("kind", KINDS)
def test_program_signature_reads_only_buffers_and_constants(saved, kind):
    from torch.export.graph_signature import InputKind

    w, path = saved[kind, "highest"]
    method = tex._AOT_METHOD[type(w).__name__]
    ep = torch.export.load(os.path.join(path, method + ".pt2"))
    kinds = [s.kind for s in ep.graph_signature.input_specs]
    assert kinds.count(InputKind.USER_INPUT) == (2 if kind == "flagship"
                                                 else 1)
    assert set(kinds) <= {InputKind.USER_INPUT, InputKind.BUFFER,
                          InputKind.CONSTANT_TENSOR}
    # the convs are the kernel operators, one K1 and one K2 a block
    ops = sorted(str(n.target) for n in ep.graph.nodes
                 if "pqmf_tpu_torch" in str(n.target))
    assert ops == ["pqmf_tpu_torch.analysis_conv.default",
                   "pqmf_tpu_torch.synthesis_conv.default"]


@pytest.fixture(scope="module")
def jax_saved(tmp_path_factory):
    """kind -> the JAX package's artifact of the same wrapper, with its
    StableHLO program."""
    root = tmp_path_factory.mktemp("jax_aot")
    return {kind: jex.save_artifact(_wrapper(kind, pkg="jax"),
                                    str(root / kind), with_stablehlo=True)
            for kind in KINDS}


@pytest.mark.parametrize("kind", KINDS)
def test_program_matches_jax_program(saved, jax_saved, kind):
    jfn = jex.load_stablehlo(jax_saved[kind])
    assert jfn is not None
    blocks = _blocks(7)
    tail = np.zeros((M, 32), np.float32) if kind == "flagship" else None
    if kind == "flagship":
        want = _run(kind, lambda t, x: jfn(jnp.asarray(t), jnp.asarray(x)),
                    blocks, tail)
    else:
        want = _run(kind, lambda x: jfn(jnp.asarray(x)), blocks)
    _, path = saved[kind, "highest"]
    fn = tex.load_stablehlo(path, device="cpu")
    got = _run(kind, _program(kind, fn), blocks, _tail0(kind))
    for g, r in zip(got, want):
        assert g.shape == r.shape
        if kind == "plain":
            np.testing.assert_allclose(g, r, **TOL)
        else:
            assert snr_db(r, g) >= BAR_DB


# -- the kernel operators' fake (shape) implementations ----------------------


def _fake_and_real(op, *args):
    from torch._subclasses.fake_tensor import FakeTensorMode

    real = op(*args)
    with FakeTensorMode(allow_non_fake_inputs=False) as mode:
        fargs = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                 for a in args]
        fake = op(*fargs)
    return tuple(fake.shape), tuple(real.shape)


@settings(max_examples=25, deadline=None)
@given(B=st.integers(1, 3), M_=st.sampled_from([2, 4, 8, 16]),
       K=st.integers(1, 70), T_=st.integers(1, 200),
       pad=st.tuples(st.integers(0, 40), st.integers(0, 40)),
       precision=st.sampled_from(["highest", "bf16x3", "default"]))
def test_analysis_fake_shape(B, M_, K, T_, pad, precision):
    if pad[0] + T_ + pad[1] < K:
        return
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, 1, T_, generator=g)
    w = torch.randn(M_, 1, K, generator=g)
    fake, real = _fake_and_real(cc.OPS.analysis_conv.default, x, w, None,
                                M_, True, *pad, precision)
    assert fake == real == (B, M_, (pad[0] + T_ + pad[1] - K) // M_ + 1)


@settings(max_examples=25, deadline=None)
@given(B=st.integers(1, 3), M_=st.sampled_from([2, 4, 8, 16]),
       Mb=st.sampled_from([2, 4, 8]), K=st.integers(1, 40),
       T_=st.integers(1, 80), x_offset=st.integers(-20, 20),
       pad=st.tuples(st.integers(0, 40), st.integers(0, 40)),
       precision=st.sampled_from(["highest", "bf16x3", "default"]))
def test_synthesis_fake_shape(B, M_, Mb, K, T_, x_offset, pad, precision):
    if pad[0] + T_ + pad[1] < K:
        return
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, Mb, T_, generator=g)
    w = torch.randn(M_, Mb, K, generator=g)
    fake, real = _fake_and_real(cc.OPS.synthesis_conv.default, x, w, None,
                                True, x_offset, *pad, precision)
    assert fake == real == (B, pad[0] + T_ + pad[1] - K + 1, M_)


@settings(max_examples=25, deadline=None)
@given(B=st.integers(1, 3), M_=st.sampled_from([2, 4, 8, 16]),
       Ka=st.integers(1, 70), Ks=st.integers(1, 20), T_=st.integers(1, 300),
       pad=st.tuples(st.integers(0, 40), st.integers(0, 40)),
       syn_pad=st.tuples(st.integers(0, 20), st.integers(0, 20)),
       precision=st.sampled_from(["highest", "bf16x3", "default"]))
def test_roundtrip_fake_shape(B, M_, Ka, Ks, T_, pad, syn_pad, precision):
    T_ana = (pad[0] + T_ + pad[1] - Ka) // M_ + 1
    if T_ana < 1 or syn_pad[0] + T_ana + syn_pad[1] < Ks:
        return
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, 1, T_, generator=g)
    wa = torch.randn(M_, 1, Ka, generator=g)
    ws = torch.randn(M_, M_, Ks, generator=g)
    fake, real = _fake_and_real(cc.OPS.roundtrip_conv.default, x, wa, ws,
                                None, None, M_, *pad, *syn_pad, precision)
    assert fake == real == (B, syn_pad[0] + T_ana + syn_pad[1] - Ks + 1, M_)


def test_wrappers_call_the_operators(monkeypatch):
    """The public kernel functions route through the operators on the CPU
    too (one route for the live call and the exported program)."""
    seen = []
    real = torch.ops.pqmf_tpu_torch

    class Spy:
        def __getattr__(self, name):
            overload = getattr(real, name).default

            class One:
                @staticmethod
                def default(*args):
                    seen.append(name)
                    return overload(*args)
            return One

    monkeypatch.setattr(cc, "OPS", Spy())
    sp = StreamingPQMF(100, M, device="cpu")
    x = torch.randn(1, 1, T)
    sp.inverse(sp.forward(x))
    sp.roundtrip(x)
    assert seen == ["analysis_conv", "synthesis_conv", "roundtrip_conv"]


def test_readout_runs_with_a_bank_that_requires_grad():
    """No autograd is registered on the operators; a call whose bank
    requires grad still runs and gives the plain value (training's SNR
    readout, ``parallel/training.roundtrip_snr``, reaches K3)."""
    sp = StreamingPQMF(100, M, device="cpu")
    wa = sp.hkf.clone().requires_grad_(True)
    ws = sp.hki.clone().requires_grad_(True)
    x = torch.randn(1, 1, T)
    got = cc.fused_roundtrip_conv(x, wa, ws, M, (16, 16), pad=(128, 128))
    want = cc.roundtrip_conv_plain(x, sp.hkf, sp.hki, M, (16, 16),
                                   pad=(128, 128))
    torch.testing.assert_close(got.detach(), want, rtol=0, atol=0)


# -- the plan caches under tracing --------------------------------------------


def _no_fake(obj):
    from torch._subclasses.fake_tensor import FakeTensor

    if isinstance(obj, torch.Tensor):
        return not isinstance(obj, FakeTensor) and type(obj) is torch.Tensor
    if isinstance(obj, (tuple, list)):
        return all(_no_fake(o) for o in obj)
    if isinstance(obj, dict):
        return all(_no_fake(o) for o in obj.values())
    return True


@pytest.mark.parametrize("kind", ["flagship", "ta"])
def test_export_leaves_no_fake_tensor_in_live_caches(kind):
    w = _wrapper(kind)
    cache = w._plans if kind == "flagship" else w._ta_plans
    assert cache == {}  # cold: the export's own warm-up fills it
    tex.export_stablehlo(w, T)
    assert cache and _no_fake(cache)
    # the module-level tensor caches the steps read are real too
    assert _no_fake([tS.hann_window(128, device=torch.device("cpu")),
                     tS.idft_basis(128, device=torch.device("cpu"))])
    # the next live block equals a fresh wrapper's
    fresh = _wrapper(kind)
    x = _blocks(11)[0]
    got = _run(kind, _live(kind, w), [x], _tail0(kind))
    want = _run(kind, _live(kind, fresh), [x], _tail0(kind))
    for g, r in zip(got, want):
        np.testing.assert_array_equal(g, r)


# -- what an export leaves on disk --------------------------------------------


def test_failed_export_raises_and_writes_nothing(tmp_path, monkeypatch):
    w = _wrapper("plain")
    # a real failure: a block length the wrapper refuses
    with pytest.raises(RuntimeError, match="torch.export program"):
        tex.save_artifact(w, str(tmp_path / "bad"), with_stablehlo=True,
                          example_length=T + 1)
    assert not os.path.exists(tmp_path / "bad")
    # and any exception of the export
    def boom(*a, **k):
        raise ValueError("boom")
    monkeypatch.setattr(tex, "export_stablehlo", boom)
    with pytest.raises(RuntimeError, match="torch.export program"):
        tex.save_artifact(w, str(tmp_path / "bad2"), with_stablehlo=True)
    assert not os.path.exists(tmp_path / "bad2")


def test_reexport_without_program_removes_the_stale_one(tmp_path):
    w = _wrapper("flagship")
    path = str(tmp_path / "a")
    tex.save_artifact(w, path, with_stablehlo=True)
    assert os.path.exists(os.path.join(path, "pitchshift.pt2"))
    # files that are not this package's programs stay
    for other in ("mine.pt2", "pitchshift.jaxexport"):
        open(os.path.join(path, other), "wb").close()
    tex.save_artifact(w, path)
    assert sorted(os.listdir(path)) == [
        "manifest.json", "mine.pt2", "pitchshift.jaxexport", "state.npz",
        "weights.npz"]
    with open(os.path.join(path, "manifest.json")) as f:
        assert "torch_export" not in json.load(f)
    assert tex.load_stablehlo(path, device="cpu") is None


def test_artifacts_cross_load_and_programs_do_not(saved, jax_saved):
    for kind in KINDS:
        # the JAX artifact: a wrapper here, its StableHLO never taken
        loaded, manifest = tex.load_artifact(jax_saved[kind], device="cpu")
        assert manifest["stablehlo"]
        assert type(loaded).__name__ == manifest["kind"]
        assert tex.load_stablehlo(jax_saved[kind], device="cpu") is None
        # the port's artifact: a wrapper in JAX, its program never taken
        _, path = saved[kind, "highest"]
        jloaded, jmanifest = jex.load_artifact(path)
        assert type(jloaded).__name__ == jmanifest["kind"]
        method = tex._AOT_METHOD[jmanifest["kind"]]
        assert jex.load_stablehlo(path) is None
        assert jex.load_stablehlo(path, method) is None


def test_program_for_another_device_is_refused(saved, tmp_path):
    import shutil

    _, src = saved["plain", "highest"]
    path = str(tmp_path / "moved")
    shutil.copytree(src, path)
    mpath = os.path.join(path, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["torch_export"]["process"]["device"] = "cuda"
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="exported for 'cuda'"):
        tex.load_stablehlo(path, device="cpu")
    # an input on another device than the program's is refused too
    fn = tex.load_stablehlo(src, device="cpu")
    assert fn is not None
    with pytest.raises(ValueError, match="on meta"):
        fn(torch.zeros((1, 1, T), device="meta"))


def test_program_for_another_card_index_is_refused(saved, monkeypatch):
    """A program whose tensors lie on another device than the one asked
    for (as a program exported on one card and loaded with another
    current) is refused at load, though the manifest's device type
    matches. On the CPU the other index is simulated by asking for
    ``cpu:0`` (the program's tensors lie on ``cpu``)."""
    _, path = saved["flagship", "highest"]
    monkeypatch.setattr(tex, "resolve_device",
                        lambda d: torch.device("cpu", 0))
    with pytest.raises(ValueError, match="holds tensors on"):
        tex.load_stablehlo(path, device="cpu")


@pytest.mark.parametrize("kind", KINDS)
def test_program_checks_its_arguments(saved, kind):
    """The reloaded program takes what the live wrapper takes: a float64
    block raises ``ValueError`` (as the wrapper does, and as JAX's program
    refuses another dtype), and a strided block (one channel of
    interleaved stereo) gives the wrapper's output bit for bit."""
    w, path = saved[kind, "highest"]
    fn = tex.load_stablehlo(path, device="cpu")
    x = np.random.default_rng(4).standard_normal((1, T))
    head = (_tail0(kind),) if kind == "flagship" else ()
    as_arg = (lambda t: t) if kind == "flagship" else (lambda t: t[None])
    with pytest.raises(ValueError, match="float64"):
        fn(*head, as_arg(torch.from_numpy(x)))
    stereo = torch.from_numpy(np.stack([x[0], -x[0]], axis=-1).astype(
        np.float32))
    strided = as_arg(stereo[:, 0][None])
    assert not strided.is_contiguous()
    got = fn(*head, strided)
    want = _live(kind, w)(*head, np.ascontiguousarray(strided.numpy()))
    for g, r in zip(*(o if isinstance(o, tuple) else (o,)
                      for o in (got, want))):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


def _operands(op, x=None, w=None, bank=None, precision="bf16x3"):
    """One call of a kernel operator on the CPU at M = 8 with its operands
    replaced as given."""
    sp = StreamingPQMF(100, M, device="cpu")
    if op == "analysis":
        w = sp.hkf if w is None else w
        x = torch.zeros((1, 1, T)) if x is None else x
        return cc.OPS.analysis_conv.default(x, w, bank, M, True, 0, 0,
                                            precision)
    w = sp.hki if w is None else w
    x = torch.zeros((1, M, 64)) if x is None else x
    return cc.OPS.synthesis_conv.default(x, w, bank, True, 0, 0, 0,
                                         precision)


@pytest.mark.parametrize("case", [
    "x float64", "x strided", "w float64", "x channels", "w channels",
    "bank shape", "bank dtype", "precision"])
def test_operators_refuse_bad_operands(case):
    """The operators check their operands themselves (an exported program
    calls them without the public functions' checks, and the CUDA impl
    takes raw pointers): these raise ``ValueError`` before any kernel or
    plain version runs."""
    sp = StreamingPQMF(100, M, device="cpu")
    good = cc.arrange_tc_bank(sp.hkf, "analysis", "bf16x3").words
    call = {
        "x float64": lambda: _operands(
            "analysis", x=torch.zeros((1, 1, T), dtype=torch.float64)),
        "x strided": lambda: _operands(
            "synthesis", x=torch.zeros((1, 64, M)).transpose(1, 2)),
        "w float64": lambda: _operands("analysis", w=sp.hkf.double()),
        "x channels": lambda: _operands("analysis",
                                        x=torch.zeros((1, 2, T))),
        "w channels": lambda: _operands("synthesis",
                                        w=sp.hki[:, :M // 2].contiguous()),
        "bank shape": lambda: _operands("analysis", bank=good[:1]),
        "bank dtype": lambda: _operands("analysis", bank=good.float()),
        "precision": lambda: _operands("analysis", precision="tf32"),
    }[case]
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize("kind", ["analysis", "synthesis"])
@pytest.mark.parametrize("precision", ["bf16x3", "default"])
@pytest.mark.parametrize("M_,Mb,K", [(2, 2, 5), (8, 8, 33), (16, 8, 17),
                                     (16, 16, 513), (32, 32, 65)])
def test_tc_words_shape_is_the_arranged_banks(kind, precision, M_, Mb, K):
    """The bank shape the operators hold a tier bank to is the shape
    ``arrange_tc_bank`` gives."""
    shape = (Mb, 1, K) if kind == "analysis" else (M_, Mb, K)
    w = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    words = cc.arrange_tc_bank(w, kind, precision).words
    assert tuple(words.shape) == cc._tc_words_shape(shape, kind, precision)


# -- the CLIs, the demos and the card checks at --device cpu -----------------


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("wav") / "in.wav")
    t = np.arange(3000) / 44100.0
    write_wav(path, (0.3 * np.sin(2 * np.pi * 440 * t))[None].astype(
        np.float32), 44100)
    return path


@pytest.mark.parametrize("cli,method", [("export_pqmf", "process"),
                                        ("export_pvoc", "pitchshift")])
def test_cli_stablehlo(wav, tmp_path, cli, method):
    main = importlib.import_module(f"pqmf_tpu_torch.cli.{cli}").main
    out = str(tmp_path / "art")
    assert main(["--input", wav, "--out_dir", out, "--audio_dir",
                 str(tmp_path / "audio"), "--n_band", str(M), "--buffer",
                 str(T), "--stablehlo", "--device", "cpu"]) == 0
    assert os.path.exists(os.path.join(out, method + ".pt2"))
    with open(os.path.join(out, "manifest.json")) as f:
        assert json.load(f)["torch_export"] == {
            method: {"length": T, "device": "cpu"}}


def _demo(name):
    sys.path.insert(0, os.path.join(ROOT, "examples", "torch"))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.pop(0)


@pytest.mark.parametrize("name,argv", [
    ("serving_demo", ["--n_band", "8", "--buffer", "1024", "--streams", "2",
                      "--blocks", "2"]),
    ("realtime_demo", ["--n_band", "8", "--buffer", "1024", "--seconds",
                       "0.2"]),
    ("finetune_demo", ["--n_band", "8", "--steps", "2", "--batch", "2",
                       "--length", "1024", "--seconds", "0.5"]),
])
def test_demo_runs_on_the_cpu(name, argv, capsys):
    assert _demo(name).main([*argv, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "device: cpu" in out
    if name == "serving_demo":
        assert "(bit-equal)" in out


def test_chip_smoke_aot_phase_rehearses_on_the_cpu():
    """``chip_smoke.py``'s AOT phase (3b) at full width on the plain
    versions, in its own process (the module pins the CPU reference's
    environment at import): five programs, the fresh-process reload, the
    ``--stablehlo`` CLIs."""
    import subprocess

    code = ("import json, chip_smoke; r = chip_smoke._aot_phase('cpu', "
            "'cpu'); print(json.dumps({k: v['bit_equal'] for k, v in "
            "r.items()}))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == {
        "flagship highest": True, "flagship bf16x3": True,
        "flagship default": True, "plain": True, "ta": True}


def test_gpu_checks_rehearse_on_the_cpu(capsys):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        gpu_checks = importlib.import_module("gpu_checks")
    finally:
        sys.path.pop(0)
    assert gpu_checks.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.rstrip().endswith("ALL PASS")
