"""The port's serving-scale tools run end to end on the CPU port
(``--cpu``, tiny sizes, in a subprocess with its own 120 s limit): exit 0,
every printed field present. Their numbers are host-clock numbers of the
CPU, a check of the tool, never a measurement of the card."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*args) -> tuple:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    return lines, json.loads(lines[-1])


def test_serving_scaling_runs_on_the_cpu():
    lines, result = _run("tools/gpu_serving_scaling.py", "--cpu",
                         "--streams", "1,2", "--n_blocks", "2")
    assert lines[0].startswith("device cpu")
    assert result["tool"] == "gpu_serving_scaling"
    assert [p["streams"] for p in result["points"]] == [1, 2]
    for p in result["points"]:
        assert set(p) == {"streams", "ms_per_step", "per_stream_rtf",
                          "aggregate_rtf", "realtime", "graph_pool_bytes"}
    assert any(ln.startswith("largest real-time S") for ln in lines)


def test_microbatch_curve_runs_on_the_cpu():
    lines, result = _run("tools/gpu_microbatch_curve.py", "--cpu", "--ks",
                         "1", "2", "--reps", "2")
    assert "dispatch_floor_ms=n/a" in lines[0]
    assert result["tool"] == "gpu_microbatch_curve"
    assert [p["K"] for p in result["points"]] == [1, 2]
    for p in result["points"]:
        assert set(p) == {"K", "wall_ms_per_call", "ms_per_block",
                          "budget_share", "added_latency_ms", "realtime"}
        assert p["wall_ms_per_call"] > 0


@pytest.mark.parametrize("tool", ["tools/gpu_serving_scaling.py",
                                  "tools/gpu_microbatch_curve.py"])
def test_tools_refuse_to_run_without_a_card(tool):
    """Without ``--cpu`` and without a card a tool fails: no silent CPU
    run under a card's name."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, tool], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
