"""Nothing the benchmark loads is JAX or the JAX package, compared by
whole top-level names (``pqmf_tpu_torch`` begins with ``pqmf_tpu``), and
the plain reference loads nothing of the port. Each import runs in a
fresh interpreter, so what the test process holds cannot hide a leak."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "pqmf_tpu")


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted(sys.modules)))"],
        cwd=REPO, capture_output=True, text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def top(names) -> set:
    return {n.split(".")[0] for n in names}


def test_run_and_harness_load_no_jax():
    mods = loaded_after(
        "import importlib.util, sys\n"
        "sys.path.insert(0, '.')\n"
        "spec = importlib.util.spec_from_file_location('bench_run', "
        "'benchmark/run.py')\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        "from benchmark import harness, tracing, roofline\n"
        "for w in ('pvoc16.streams', 'pqmf16.files', 'pvoc16.live', "
        "'pqmf16.live'):\n"
        "    harness.load_cell(w)\n"
        "import pqmf_tpu_torch.pipelines, pqmf_tpu_torch.filterbank\n")
    assert "pqmf_tpu_torch" in top(mods)  # the program itself did load
    assert not top(mods) & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    mods = loaded_after(
        "import sys\nsys.path.insert(0, '.')\n"
        "from benchmark.reference import bank, pitch_shift\n"
        "from benchmark import audio, roofline\n"
        "import torch\n"
        "x = audio.rows(1, 8192, 1, 44100, 'cpu')\n"
        "hk = bank.design(100, 16)\n"
        "pitch_shift.step(x, None, hk, list(range(16)), "
        "pitch_shift.geometry(8192, 16))\n")
    assert not top(mods) & (set(FORBIDDEN) | {"pqmf_tpu_torch"})


@pytest.mark.parametrize("name, bad", [("jax", True), ("jaxlib.xla", True),
                                       ("pqmf_tpu", True),
                                       ("pqmf_tpu.ops", True),
                                       ("pqmf_tpu_torch", False),
                                       ("pqmf_tpu_torch.ops", False),
                                       ("jaxtyping", False)])
def test_forbidden_compares_whole_names(name, bad, monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(sys.modules, name, object())
    assert (name in harness.forbidden_modules()) is bad
