"""The control fails the check: the reference computed at TF32 (every
convolution's and DFT's operands rounded to 10 mantissa bits), put in the
program's place, on the answers a run keeps, at a size a CPU test holds.
The program on the same answers passes. On the card the same readings
come from ``benchmark/tools/calibrate.py`` at each cell's own size.

``test_cells_on_card`` runs each cell through ``run.py``; it needs a CUDA
device and skips without one."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import harness

SMALL = {"pvoc16.streams": {"rows": 4, "pool": 3, "warmup": 3},
         "pqmf16.files": {"rows": 2, "seconds_of_audio": 1, "warmup": 3},
         "pvoc16.live": {"pool": 4, "warmup": 3, "sample": 8},
         "pqmf16.live": {"pool": 4, "warmup": 3, "sample": 8}}
SEEDS = (2**31 + 1, 2**31 + 2, 2**33 + 3)


def readings(cell, seed):
    spec = harness.load_cell(cell)
    config, system = spec["config"], spec["system"]
    traffic = {**spec["traffic"], **SMALL[cell]}
    device = harness.device_of("cpu")
    prog = system.build(config, traffic, device)
    pool = harness.make_pool(prog, config, traffic, seed, device)
    g = harness.warm_up(prog, pool, traffic, device)
    _, _, kept = harness.measure(prog, pool, g, 0.2, traffic, seed, device)
    program = harness.judge(system, config, pool, kept, device)[0]
    control = harness.judge(system, config, pool, kept, device, tf32=True)[0]
    return program, control


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", list(SMALL))
def test_control_fails_and_program_passes(cell, seed):
    program, control = readings(cell, seed)
    assert all(c["value"] <= c["limit"] for c in program.values()), program
    assert any(c["value"] > 3 * c["limit"] for c in control.values()), \
        control


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(SMALL))
def test_cells_on_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2**31 + 7), "--seconds", "2", "--trace", "0"],
        cwd=harness.REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert set(r) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert list(r)[-1] == "check"


def test_no_card_no_result(tmp_path):
    """Without a CUDA device run.py exits non-zero and prints nothing on
    standard output."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "pvoc16.live",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
