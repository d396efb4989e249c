"""``pqmf_tpu_torch/entry.py`` against ``__graft_entry__.py`` on the CPU.

Bars: the entry step's ``y`` and carried tail >= 90 dB against the JAX
entry's step (the flagship's bar, ``tests/test_torch_pipeline.py``) over
three carried steps on seeded audio blocks, with the same shapes and
dtypes; on the entry's own example input (a pure sine, ill-conditioned for
the reference's phase rule: one ulp on JAX's own input moves JAX's output
below 90 dB, pinned here) at ``entry.EXAMPLE_FLOOR_DB``.
``dryrun_multichip(4, device="cpu")`` runs its four steps in a subprocess
(which imports no JAX) inside 180 s.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from pqmf_tpu_torch import entry as tentry
from pqmf_tpu_torch.utils.metrics import snr_db

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAR_DB = 90.0
DRYRUN_LIMIT = 180  # seconds


STEPS = 3


@pytest.fixture(scope="module")
def jax_entry():
    """The JAX entry's step and example arguments."""
    import jax

    with pytest.MonkeyPatch.context() as mp:
        # the suite's compilation cache stays the one in use (the JAX
        # entry points its own at the home directory otherwise)
        mp.setenv("JAX_COMPILATION_CACHE_DIR",
                  str(jax.config.jax_compilation_cache_dir))
        return jentry.entry()


def _blocks():
    rng = np.random.default_rng(23)
    return [(0.3 * rng.standard_normal((1, 1, 8192))).astype(np.float32)
            for _ in range(STEPS)]


def _carried(fn, tail, xs, to=np.asarray):
    outs = []
    for x in xs:
        tail, y = fn(tail, x)
        outs.append((to(tail), to(y)))
    return outs


def test_entry_args_match_jax(jax_entry):
    _, (tail0, x) = jax_entry
    _, (t_tail0, t_x) = tentry.entry(device="cpu")
    assert t_x.dtype == torch.float32 and tuple(t_x.shape) == x.shape
    np.testing.assert_array_equal(t_x.numpy(), np.asarray(x))
    assert t_tail0.dtype == torch.float32
    assert tuple(t_tail0.shape) == tail0.shape
    assert not t_tail0.any() and not np.asarray(tail0).any()


def _hold(ref, got, bar):
    for i, ((j_tail, j_y), (t_tail, t_y)) in enumerate(zip(ref, got)):
        assert t_y.shape == j_y.shape and t_y.dtype == j_y.dtype
        assert t_tail.shape == j_tail.shape
        assert t_tail.dtype == j_tail.dtype
        assert snr_db(j_y, t_y) >= bar, (i, snr_db(j_y, t_y))
        assert snr_db(j_tail, t_tail) >= bar, (i, snr_db(j_tail, t_tail))


def test_entry_steps_match_jax(jax_entry):
    fn, (tail, _) = jax_entry
    ref = _carried(fn, tail, [jnp.asarray(b) for b in _blocks()])
    t_fn, (t_tail, _) = tentry.entry(device="cpu")
    got = _carried(t_fn, t_tail, [torch.from_numpy(b) for b in _blocks()],
                   lambda t: t.numpy())
    _hold(ref, got, BAR_DB)


def test_entry_example_steps_match_jax(jax_entry):
    fn, (tail, x) = jax_entry
    ref = _carried(fn, tail, [x] * STEPS)
    t_fn, (t_tail, t_x) = tentry.entry(device="cpu")
    got = _carried(t_fn, t_tail, [t_x] * STEPS, lambda t: t.numpy())
    _hold(ref, got, tentry.EXAMPLE_FLOOR_DB)


@pytest.mark.parametrize("change", [
    dict(shifts_in_semitones=[0] * 16), dict(attenuation=70),
    dict(phase_rule="accumulate")], ids=["no_shift", "atten70", "rule"])
def test_example_floor_catches_a_wrong_configuration(jax_entry, change):
    """The example input's floor still tells a wrong wrapper from the
    entry's: another shift, bank or phase rule falls far below it."""
    from pqmf_tpu_torch.pipelines import PQMFPitchShiftWrapper

    fn, (tail, x) = jax_entry
    _, y = fn(tail, x)
    args = {**dict(attenuation=100, n_band=16, m_buffer_size=8192,
                   device="cpu"), **change}
    w = PQMFPitchShiftWrapper(**args)
    _, t_y = w.pitchshift_fn(w.init_state(),
                             torch.from_numpy(np.asarray(x)))
    assert snr_db(np.asarray(y), t_y.numpy()) < tentry.EXAMPLE_FLOOR_DB


def test_example_input_is_ill_conditioned(jax_entry):
    """Why the example input has its own floor: one ulp on the JAX entry's
    own input moves the JAX entry's output below the 90 dB bar."""
    fn, (tail, x) = jax_entry
    _, y = fn(tail, x)
    _, y1 = fn(tail, x * np.float32(1 + 2 ** -23))
    assert snr_db(np.asarray(y), np.asarray(y1)) < BAR_DB


def test_entry_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tentry.entry(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tentry.dryrun_multichip(2)


def test_dryrun_refuses_no_ranks():
    with pytest.raises(ValueError, match="n_devices"):
        tentry.dryrun_multichip(0, device="cpu")


def test_dryrun_multichip_on_cpu_ranks():
    code = ("import sys\n"
            "from pqmf_tpu_torch.entry import dryrun_multichip\n"
            "res = dryrun_multichip(4, device='cpu', timeout=150)\n"
            "bad = sorted(n for n in sys.modules if n == 'jax' "
            "or n.startswith(('jax.', 'pqmf_tpu.')))\n"
            "assert not bad, bad\n"
            "print('checks', res['checks'])\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True,
                         timeout=DRYRUN_LIMIT)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "mesh: {'data': 1, 'band': 4}", lines
    oks = [ln for ln in lines if " OK: " in ln]
    assert [ln.split(" OK: ")[0] for ln in oks] == \
        list(tentry.DRYRUN_STEPS), lines
