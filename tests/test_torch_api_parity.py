"""The port's public signatures against the JAX package's, and the
reference's non-default arguments against the JAX functions.

The sweep: one case for each public callable of each ``pqmf_tpu`` module
(its ``__all__``, else the functions and classes it defines) and each
public method of its classes. The port's module of the same path must have
the name; every parameter of the reference must exist in the port with an
equal default (dtypes compare by name: ``jnp.float32`` equals
``torch.float32``; a parameter the reference requires may take a default
in the port, since a call written for the reference passes it); and the
parameters the reference takes positionally must come in the port in the
same order, positionally. Every difference is in :data:`BY_DESIGN`, with
its reason.

Bars for the values: the kernel banks, plans, windows and DFT bases
bit-equal (host NumPy on both sides); ``sinc_resample`` >= 90 dB (the bar
of ``tests/test_torch_ta.py``); K4 without its sign mask at atol 2e-5 /
rtol 1e-4 against the JAX op run as its own tests run it on the CPU. The
suite runs JAX in float32, so a float64 table is held against the same
NumPy float64 construction.
"""

import importlib
import inspect
import math
import pkgutil
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pqmf_tpu
from pqmf_tpu.kernels import polyphase as jpk
from pqmf_tpu.ops import filterbank as jfb
from pqmf_tpu.ops import phase_vocoder as jpv
from pqmf_tpu.ops import resample as jrs
from pqmf_tpu.ops import stft as jS
from pqmf_tpu_torch.kernels import polyphase as pk
from pqmf_tpu_torch.ops import phase_vocoder as tpv
from pqmf_tpu_torch.ops import resample as trs
from pqmf_tpu_torch.ops import stft as tS
from pqmf_tpu_torch.utils.metrics import snr_db

# every difference between a pqmf_tpu signature and the port's. Keys of
# ``where`` are the reference object's "module:qualname"; None = anywhere.
# ``params``: reference parameters the port does not take; ``defaults``:
# parameters whose default differs; ``missing``: the callable itself is
# absent; ``modules``: modules the port has no counterpart of.
BY_DESIGN = {
    "pallas_knobs": dict(
        where=None,
        params={"tile", "interpret", "out_layout", "scheme", "mid", "calls",
                "use_pallas"},
        missing={"pqmf_tpu.kernels.polyphase:pallas_available"},
        reason="They choose among the TPU's Pallas variants (tiles, the "
               "Mosaic interpreter, output layout, MXU scheme, mid layout, "
               "call split) and between Pallas and lax. The port has one "
               "CUDA route per tier that plans its own launch "
               "(cached_conv.launch_plan), and takes the plain versions "
               "only for CPU tensors."),
    "tpu_layout_gates": dict(
        where={"pqmf_tpu.kernels.polyphase:supports",
               "pqmf_tpu.kernels.polyphase:roundtrip_supported",
               "pqmf_tpu.kernels.cached_conv:fused_roundtrip_supported"},
        params={"halos", "syn_taps", "syn_pad_left"},
        reason="The JAX gates test TPU layouts: a VMEM tile's halo rows "
               "and the 128-lane grouping of the synthesis pad. The port's "
               "gates test what K1-K3 need, shared memory, by the banks' "
               "taps and the tier."),
    "einsum_precision": dict(
        where=None,
        missing={"pqmf_tpu.ops.stft:einsum_precision"},
        reason="It maps a tier to the TPU's Precision for the DFT einsums. "
               "ops.stft.dft_matmul has that role in the port: at "
               "'default' it rounds both operands to bf16 and runs the "
               "product in full f32."),
    "lerp_forms": dict(
        where=None,
        missing={"pqmf_tpu.ops.resample:interpolate_linear_dynamic_gather",
                 "pqmf_tpu.ops.resample:interpolate_linear_dynamic_chunked"},
        reason="The one-hot and chunked forms of the dynamic lerp exist "
               "for the TPU's slow minor-dim gathers. The port's "
               "interpolate_linear_dynamic is one gather of the same "
               "values."),
    "make_mesh_devices": dict(
        where={"pqmf_tpu.parallel.sharding:make_mesh"},
        params={"devices"},
        reason="A JAX mesh is built from a device list. The port's ranks "
               "are processes of torch.distributed's default group, each "
               "owning its device, so make_mesh takes a device_type."),
    "train_state": dict(
        where={"pqmf_tpu.parallel.training:TrainState"},
        params={"opt_state"},
        missing={"pqmf_tpu.parallel.training:TrainState.tree_flatten",
                 "pqmf_tpu.parallel.training:TrainState.tree_unflatten"},
        reason="JAX's state is an optax pytree (hk, opt_state) registered "
               "with jax.tree_util for jit. The port's holds a torch "
               "optimizer over hk with its lr schedule and step count, "
               "steps it in place and keeps its CUDA graphs."),
    "native_library": dict(
        where=None,
        modules={"pqmf_tpu.native._pqmf_wavio"},
        reason="The JAX package builds a CPython extension module in place "
               "and build() answers True/False. The port builds a plain C "
               "library into _build/ and loads it with ctypes (no Python.h "
               "build is known to work on the card's machine); its build() "
               "returns the library's path or None."),
    "dispatch_floor_repeats": dict(
        where={"pqmf_tpu.utils.profiling:dispatch_floor_ms"},
        defaults={"repeats"},
        reason="The port times 100 back-to-back CUDA launches, not 10 JAX "
               "dispatches: one launch is a few microseconds, so 10 sit "
               "near the CUDA events' resolution."),
}

# what the port's repair of its public ops fixed: none of it may come back
# as a difference by design
FIXED = {
    "where": {"pqmf_tpu.ops.resample:sinc_resample_kernel",
              "pqmf_tpu.ops.resample:banded_resample_plan",
              "pqmf_tpu.ops.resample:sinc_resample",
              "pqmf_tpu.ops.stft:frame_count",
              "pqmf_tpu.ops.stft:hann_window",
              "pqmf_tpu.ops.stft:dft_basis",
              "pqmf_tpu.ops.stft:idft_basis",
              "pqmf_tpu.ops.phase_vocoder:phase_advance",
              "pqmf_tpu.ops.phase_vocoder:phase_advance_reference",
              "pqmf_tpu.kernels.cached_conv:strided_analysis_conv",
              "pqmf_tpu.kernels.cached_conv:dense_synthesis_conv",
              "pqmf_tpu.kernels.cached_conv:fused_roundtrip_conv",
              "pqmf_tpu.kernels.polyphase:polyphase_analysis",
              "pqmf_tpu.kernels.polyphase:polyphase_synthesis",
              "pqmf_tpu.kernels.polyphase:polyphase_roundtrip",
              "pqmf_tpu.native:build"},
    "params": {"mxu_precision", "fuse_mask", "lowpass_filter_width",
               "rolloff", "window", "beta", "dtype", "center", "quiet"},
}

SKIP_MODULES = {"pqmf_tpu.native.setup"}  # importing it runs setuptools


def _modules():
    names = ["pqmf_tpu"] + [
        m.name for m in pkgutil.walk_packages(pqmf_tpu.__path__,
                                              "pqmf_tpu.")]
    return [n for n in names if n not in SKIP_MODULES]


def _key(obj, fallback: str) -> str:
    mod = getattr(obj, "__module__", None)
    qual = getattr(obj, "__qualname__", None)
    return f"{mod}:{qual}" if mod and qual else fallback


def _public(mod):
    """(name, reference object) of each public callable of ``mod`` and
    each public method of its classes."""
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n, o in vars(mod).items()
                 if not n.startswith("_")
                 and (inspect.isfunction(o) or inspect.isclass(o))
                 and getattr(o, "__module__", None) == mod.__name__]
    out = []
    for n in names:
        o = getattr(mod, n)
        if not callable(o) or inspect.ismodule(o):
            continue
        out.append((n, o))
        if inspect.isclass(o) and o.__module__.startswith("pqmf_tpu."):
            for mn, mo in vars(o).items():
                if mn.startswith("_"):
                    continue
                if isinstance(mo, (staticmethod, classmethod)):
                    mo = mo.__func__
                if inspect.isfunction(mo):
                    out.append((f"{n}.{mn}", mo))
    return out


def _cases():
    cases = []
    for m in _modules():
        try:
            mod = importlib.import_module(m)
        except ImportError:
            continue
        if m in BY_DESIGN["native_library"]["modules"]:
            cases.append(pytest.param(m, None, None, id=m))
            continue
        for name, obj in _public(mod):
            cases.append(pytest.param(m, name, obj, id=f"{m}:{name}"))
    return cases


CASES = _cases()


def _canon(v):
    """A default for comparison: dtypes by name, anything else as is."""
    if isinstance(v, torch.dtype):
        return ("dtype", str(v).rsplit(".", 1)[-1])
    if isinstance(v, np.dtype) or (isinstance(v, type)
                                   and issubclass(v, np.generic)):
        return ("dtype", np.dtype(v).name)
    if isinstance(v, type) and v.__module__.startswith("jax"):
        try:
            return ("dtype", np.dtype(v).name)
        except TypeError:
            pass
    return v


def _positional(sig):
    return [p.name for p in sig.parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


def differences(modname, name, ref):
    """The differences of the port's counterpart of ``ref``, as (kind,
    detail) pairs: ("module", m), ("missing", name), ("param", p),
    ("default", p), ("order", (ref order, port order))."""
    tmod_name = "pqmf_tpu_torch" + modname[len("pqmf_tpu"):]
    try:
        port = importlib.import_module(tmod_name)
    except ImportError:
        return [("module", modname)]
    if name is None:
        return []
    for part in name.split("."):
        if not hasattr(port, part):
            return [("missing", name)]
        port = getattr(port, part)
    try:
        rs, ps = inspect.signature(ref), inspect.signature(port)
    except (TypeError, ValueError):
        return []
    out = []
    rp, pp = rs.parameters, ps.parameters
    for p in rp.values():
        if p.name not in pp:
            out.append(("param", p.name))
        elif p.default is not p.empty:
            d = pp[p.name].default
            try:
                same = bool(_canon(p.default) == _canon(d))
            except Exception:  # an array default: compare identities
                same = p.default is d
            if not same:
                out.append(("default", p.name))
    r_order = [n for n in _positional(rs) if n in pp]
    p_order = [n for n in _positional(ps) if n in r_order]
    if r_order != p_order:
        out.append(("order", (tuple(r_order), tuple(p_order))))
    return out


def _covered(key, diff, entries=None) -> bool:
    kind, detail = diff
    for entry in (BY_DESIGN if entries is None else entries).values():
        where = entry.get("where")
        if kind == "module" and detail in entry.get("modules", ()):
            return True
        if kind == "missing" and key in entry.get("missing", ()):
            return True
        if where is not None and key not in where:
            continue
        if kind == "param" and detail in entry.get("params", ()):
            return True
        if kind == "default" and detail in entry.get("defaults", ()):
            return True
    return False


def _reference_key(modname, name, ref):
    if name is None:
        return modname
    if "." in name:  # a method: its class's key and its own name
        cls = getattr(importlib.import_module(modname), name.split(".")[0])
        return f"{_key(cls, modname)}.{name.split('.', 1)[1]}"
    return _key(ref, f"{modname}:{name}")


@pytest.mark.parametrize("modname,name,ref", CASES)
def test_port_takes_the_reference_signature(modname, name, ref):
    key = _reference_key(modname, name, ref)
    left = [d for d in differences(modname, name, ref)
            if not _covered(key, d)]
    assert not left, f"{key}: {left}"


def test_sweep_walks_the_whole_package():
    mods = {m for m, _, _ in (c.values for c in CASES)}
    assert len(CASES) > 150
    assert {"pqmf_tpu", "pqmf_tpu.ops.resample", "pqmf_tpu.kernels",
            "pqmf_tpu.kernels.cached_conv", "pqmf_tpu.native",
            "pqmf_tpu.utils.profiling"} <= mods


def test_every_by_design_entry_is_used():
    """A stale entry would hide a future difference."""
    used = set()
    for m, name, ref in (c.values for c in CASES):
        key = _reference_key(m, name, ref)
        for diff in differences(m, name, ref):
            used |= {tag for tag, entry in BY_DESIGN.items()
                     if _covered(key, diff, {tag: entry})}
    modules = {m for m, _, _ in (c.values for c in CASES)}
    if "pqmf_tpu.native._pqmf_wavio" not in modules:
        # the JAX package's extension is built only where it was asked for
        used.add("native_library")
    assert used == set(BY_DESIGN), set(BY_DESIGN) - used
    for tag, entry in BY_DESIGN.items():
        assert len(entry["reason"]) > 40, tag


def test_by_design_leaves_the_fixed_faults_out():
    for tag, entry in BY_DESIGN.items():
        assert not (entry.get("where") or set()) & FIXED["where"], tag
        assert not set(entry.get("params", ())) & FIXED["params"], tag
        assert not set(entry.get("defaults", ())) & FIXED["params"], tag
        assert not set(entry.get("missing", ())) & FIXED["where"], tag


def test_the_sweep_sees_a_difference():
    """The comparison itself: a dropped parameter, a changed default and a
    swapped order are each reported."""
    def ref(x, a=1, b="hann", *, c=None):
        pass

    port = types.ModuleType("pqmf_tpu_torch._parity_probe")
    sys.modules["pqmf_tpu_torch._parity_probe"] = port
    try:
        port.f = lambda x, b="hann", a=1: None
        assert ("order", (("x", "a", "b"), ("x", "b", "a"))) in \
            differences("pqmf_tpu._parity_probe", "f", ref)
        port.f = lambda x, a=2, b="hann", c=None: None
        assert differences("pqmf_tpu._parity_probe", "f", ref) == [
            ("default", "a")]
        port.f = lambda x, a=1: None
        assert set(differences("pqmf_tpu._parity_probe", "f", ref)) == {
            ("param", "b"), ("param", "c")}
        port.f = lambda x, a=1, b="hann", c=None, extra=0: None
        assert differences("pqmf_tpu._parity_probe", "f", ref) == []
        assert differences("pqmf_tpu._parity_probe", "g", ref) == [
            ("missing", "g")]
    finally:
        del sys.modules["pqmf_tpu_torch._parity_probe"]
    assert _canon(jnp.float32) == _canon(torch.float32) == \
        _canon(np.float32)
    assert _canon(jnp.float32) != _canon(torch.float64)


# ---------------------------------------------------------------------------
# the non-default values against the JAX functions
# ---------------------------------------------------------------------------

FILTERS = [
    dict(window="kaiser"),
    dict(window="kaiser", beta=8.0),
    dict(lowpass_filter_width=16),
    dict(lowpass_filter_width=6, rolloff=0.9),
    dict(lowpass_filter_width=16, rolloff=0.95, window="kaiser"),
    dict(dtype=np.float64),
]
RATIOS = [(44100, 48000), (2756, 2067), (3, 5)]


def _fid(kw):
    return ",".join(f"{k}={getattr(v, '__name__', v)}"
                    for k, v in kw.items())


@pytest.mark.parametrize("orig,new", RATIOS)
@pytest.mark.parametrize("kw", FILTERS, ids=_fid)
def test_sinc_resample_kernel_bit_equal(orig, new, kw):
    ref = jrs.sinc_resample_kernel(orig, new, **kw)
    got = trs.sinc_resample_kernel(orig, new, **kw)
    assert got[1:] == ref[1:]
    assert got[0].dtype == ref[0].dtype == kw.get("dtype", np.float32)
    np.testing.assert_array_equal(got[0], ref[0])


def test_sinc_resample_kernel_refuses_an_unknown_window():
    for mod in (jrs, trs):
        with pytest.raises(ValueError, match="unknown window"):
            mod.sinc_resample_kernel(3, 5, window="blackman")


PLAN_FILTERS = [kw for kw in FILTERS if "dtype" not in kw and "beta" not in kw]


@pytest.mark.parametrize("orig,new,n_out", [(3, 5, 40), (2756, 2067, 600),
                                            (44100, 48000, 300)])
@pytest.mark.parametrize("kw", PLAN_FILTERS, ids=_fid)
def test_banded_resample_plan_bit_equal(orig, new, n_out, kw):
    ref = jrs.banded_resample_plan(orig, new, n_out, **kw)
    got = trs.banded_resample_plan(orig, new, n_out, **kw)
    assert got[2] == ref[2]
    for g, r in zip(got[:2], ref[:2]):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


def test_kaiser_plan_is_wider_than_hann():
    """The Kaiser taps at |t| = width are tiny but not zero: the plan's
    span takes them (no threshold), as the JAX plan does."""
    hann = trs.banded_resample_plan(3, 5, 40)[0]
    kaiser = trs.banded_resample_plan(3, 5, 40, window="kaiser")[0]
    assert kaiser.shape[1] > hann.shape[1]


@pytest.mark.parametrize("orig,new", [(3, 5), (2756, 2067), (5, 3)])
@pytest.mark.parametrize("kw", PLAN_FILTERS, ids=_fid)
def test_sinc_resample_matches_jax(orig, new, kw):
    x = (0.3 * np.random.default_rng(orig + new).standard_normal(
        (2, 900))).astype(np.float32)
    ref = np.asarray(jrs.sinc_resample(jnp.asarray(x), orig, new, **kw))
    got = trs.sinc_resample(torch.from_numpy(x), orig, new, **kw)
    assert got.shape == ref.shape == (2, math.ceil(900 * new / orig))
    assert snr_db(got.numpy(), ref) >= 90.0


def test_sinc_bank_cache_keys_every_filter_argument():
    x = torch.from_numpy((0.3 * np.random.default_rng(0).standard_normal(
        (1, 400))).astype(np.float32))
    outs = [trs.sinc_resample(x, 3, 5, **kw) for kw in
            (dict(), dict(window="kaiser"), dict(lowpass_filter_width=16),
             dict(rolloff=0.9))]
    for i in range(len(outs)):
        for j in range(i):
            assert not torch.equal(outs[i], outs[j]), (i, j)


@pytest.mark.parametrize("T,n_fft,hop", [(1000, 256, 64), (4096, 512, 128),
                                         (100, 64, 16), (511, 512, 128)])
@pytest.mark.parametrize("center", [True, False])
def test_frame_count_center(T, n_fft, hop, center):
    assert tS.frame_count(T, n_fft, hop, center=center) == \
        jS.frame_count(T, n_fft, hop, center=center)
    assert tS.frame_count(T, n_fft, hop, center) == \
        jS.frame_count(T, n_fft, hop, center)


def _np_hann(n):
    k = np.arange(n)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)


TABLES = {
    "hann_window": (lambda d: (tS.hann_window(96, d),),
                    lambda: (jS.hann_window(96),),
                    lambda: (_np_hann(96),)),
    "dft_basis": (lambda d: tS.dft_basis(64, d), lambda: jS.dft_basis(64),
                  lambda: jS._dft_basis_np(64)),
    "idft_basis": (lambda d: tS.idft_basis(64, d), lambda: jS.idft_basis(64),
                   lambda: jS._idft_basis_np(64)),
    "phase_advance": (
        lambda d: (tpv.phase_advance(33, 16, 64, d),),
        lambda: (jpv.phase_advance(33, 16, 64),),
        lambda: (2.0 * np.pi * np.arange(33) * 16 / 64,)),
    "phase_advance_reference": (
        lambda d: (tpv.phase_advance_reference(257, 128, 512, d),),
        lambda: (jpv.phase_advance_reference(257, 128, 512),),
        lambda: ((np.float32(2.0 * math.pi) * np.arange(257,
                                                       dtype=np.float32)
                  * np.float32(128)) / np.float32(512),)),
}


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("dtype", [torch.float32, np.float32, jnp.float32],
                         ids=["torch", "numpy", "jax"])
def test_tables_f32_bit_equal_to_jax(table, dtype):
    port, jax_fn, _ = TABLES[table]
    got = port(dtype)
    for g, r in zip(got, jax_fn()):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("dtype", [torch.float64, np.float64],
                         ids=["torch", "numpy"])
def test_tables_f64_bit_equal_to_numpy(table, dtype):
    port, _, construction = TABLES[table]
    for g, r in zip(port(dtype), construction()):
        assert g.dtype == torch.float64
        np.testing.assert_array_equal(g.numpy(), np.asarray(r, np.float64))


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("bad", [torch.device("cpu"), "cpu", "cuda",
                                 torch.int32],
                         ids=["device", "cpu", "cuda", "int"])
def test_a_device_in_the_dtype_place_raises(table, bad):
    port, _, _ = TABLES[table]
    with pytest.raises(TypeError, match="device="):
        port(bad)


def test_tables_take_the_device_by_keyword():
    assert tS.hann_window(8, device="cpu").device.type == "cpu"
    assert tS.dft_basis(8, device=torch.device("cpu"))[0].dtype == \
        torch.float32
    assert tpv.phase_advance(5, 2, 8, torch.float64,
                             device="cpu").dtype == torch.float64


@pytest.mark.parametrize("M", [4, 16])
@pytest.mark.parametrize("fuse_mask", [True, False])
def test_k4_fuse_mask_matches_jax(M, fuse_mask):
    p = jfb.build_filterbank(100, M)
    x = (0.3 * np.random.default_rng(M).standard_normal(
        (2, 1, M * 96))).astype(np.float32)
    ref = np.asarray(jpk.polyphase_analysis(jnp.asarray(x), p["hk_poly"],
                                            fuse_mask=fuse_mask))
    hp = torch.from_numpy(np.asarray(p["hk_poly"]))
    got = pk.polyphase_analysis(torch.from_numpy(x), hp,
                                fuse_mask=fuse_mask)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=1e-4)
    masked = pk.polyphase_analysis(torch.from_numpy(x), hp)
    same = torch.equal(got, masked)
    assert same == fuse_mask


def test_k4_plain_route_without_mask_is_the_plain_conv():
    from pqmf_tpu_torch.ops import filterbank as tfb

    p = jfb.build_filterbank(100, 8)
    hp = torch.from_numpy(np.asarray(p["hk_poly"]))
    x = torch.from_numpy((0.3 * np.random.default_rng(1).standard_normal(
        (1, 1, 8 * 50))).astype(np.float32))
    want = tfb.polyphase_forward(x, hp)
    torch.testing.assert_close(
        pk.polyphase_analysis_plain(x, hp, fuse_mask=False), want,
        rtol=0, atol=0)
    # the kernel route over K1's plain version (what a card runs, here on
    # the CPU tensors)
    torch.testing.assert_close(
        pk.analysis_over_k1(x, pk.analysis_weights(hp), 8, fuse_mask=False),
        want, atol=2e-5, rtol=1e-4)


def test_kernels_package_exports_the_public_ops():
    from pqmf_tpu_torch import kernels
    from pqmf_tpu_torch.kernels import (polyphase_analysis,
                                        polyphase_roundtrip,
                                        polyphase_synthesis,
                                        roundtrip_supported)

    assert polyphase_analysis is pk.polyphase_analysis
    assert polyphase_synthesis is pk.polyphase_synthesis
    assert polyphase_roundtrip is pk.polyphase_roundtrip
    assert roundtrip_supported is pk.roundtrip_supported
    assert {"cached_conv", "polyphase"} <= set(kernels.__all__)


def test_native_build_quiet_false_prints_the_report(tmp_path, monkeypatch,
                                                    capsys):
    from pqmf_tpu_torch import native

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_library_path",
                        lambda: tmp_path / "libprobe.so")
    fake = tmp_path / "cc"
    fake.write_text("#!/bin/sh\necho 'probe: compiler report' >&2\n"
                    "exit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CC", str(fake))
    assert native.build() is None
    assert "compiler report" not in capsys.readouterr().err
    assert native.build(quiet=False) is None
    assert "probe: compiler report" in capsys.readouterr().err
    assert "compiler report" in (tmp_path / "libprobe.log").read_text()
