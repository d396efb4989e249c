"""The port's entry points run on the card unless the caller asks for the
CPU: built with no ``device`` they target ``cuda`` and, on a machine
without a card, raise rather than run on the CPU. The CLIs default
``--device`` to ``cuda`` and keep ``--device cpu``."""

import importlib
import inspect

import numpy as np
import pytest
import torch

from pqmf_tpu_torch import (PQMF, PQMFPitchShiftWrapper,
                            PQMFPitchShiftWrapperTA, PQMFWrapper,
                            StreamingPQMF, load_artifact, save_artifact)
from pqmf_tpu_torch.parallel import training

# each entry point's constructor and the arguments it is built with here
ENTRY_POINTS = {
    "StreamingPQMF": (StreamingPQMF, (100, 16), {}),
    "PQMF": (PQMF, (100, 16), {}),
    "PQMFWrapper": (PQMFWrapper, (100, 16, 1024), {}),
    "PQMFPitchShiftWrapper": (PQMFPitchShiftWrapper, (100, 16, 2048), {}),
    "PQMFPitchShiftWrapperTA": (PQMFPitchShiftWrapperTA, (100, 8, 2048),
                                {"shifts_in_semitones": [0] * 8}),
    "TrainablePQMF": (training.TrainablePQMF, (70, 4), {}),
}

# each CLI's required arguments
CLIS = {"vocoder": ["in.wav", "out.wav"], "ps_torchaudio": ["in.wav"],
        "blocks": ["in.wav"], "export_pvoc": ["--input", "in.wav"],
        "export_pqmf": ["--input", "in.wav"],
        "finetune_bank": ["--n_band", "16", "--out", "hk.npz"]}


def _targets_the_card(build):
    """Without a card, building raises naming CUDA; with one, the object
    lives on it."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
        return
    assert build().device.type == "cuda"


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_cuda(name):
    cls, args, kwargs = ENTRY_POINTS[name]
    assert inspect.signature(cls).parameters["device"].default == "cuda"
    _targets_the_card(lambda: cls(*args, **kwargs))


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_runs_on_the_cpu_when_asked(name):
    cls, args, kwargs = ENTRY_POINTS[name]
    assert cls(*args, **kwargs, device="cpu").device == torch.device("cpu")


def test_load_artifact_defaults_to_cuda(tmp_path):
    path = str(tmp_path / "art")
    save_artifact(PQMFWrapper(100, 16, 1024, device="cpu"), path)
    _targets_the_card(lambda: load_artifact(path)[0])
    wrapper, _ = load_artifact(path, device="cpu")
    x = np.zeros((1, 1, 1024), np.float32)
    assert wrapper.device == torch.device("cpu")
    assert wrapper.forward(x).device == torch.device("cpu")


@pytest.mark.parametrize("module", sorted(CLIS))
def test_cli_device_defaults_to_cuda(module):
    parser = importlib.import_module(
        f"pqmf_tpu_torch.cli.{module}").build_parser()
    assert parser.parse_args(CLIS[module]).device == "cuda"
    assert parser.parse_args([*CLIS[module], "--device", "cpu"]).device \
        == "cpu"


@pytest.mark.parametrize("module", sorted(CLIS))
def test_cli_without_device_refuses_to_run_without_a_card(module, tmp_path):
    """A CLI given only its input runs on the card: without one it raises
    naming CUDA instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py's "
                    "test_cli_runs_on_the_card runs the CLIs there")
    from pqmf_tpu_torch.utils.audio import write_wav

    wav = str(tmp_path / "in.wav")
    write_wav(wav, np.zeros((1, 4096), np.float32), 44100)
    out = str(tmp_path / "out")
    args = {"vocoder": [wav, str(tmp_path / "out.wav")],
            "ps_torchaudio": [wav, "--out_dir", out],
            "blocks": [wav, "--out_dir", out],
            "export_pvoc": ["--input", wav, "--out_dir", out,
                            "--audio_dir", out],
            "export_pqmf": ["--input", wav, "--out_dir", out,
                            "--audio_dir", out],
            "finetune_bank": ["--n_band", "8", "--attenuation", "70",
                              "--steps", "1", "--length", "1024", "--wav",
                              wav, "--out", str(tmp_path / "hk.npz")]}[module]
    main = importlib.import_module(f"pqmf_tpu_torch.cli.{module}").main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(args)


@pytest.mark.parametrize("build", [
    lambda **kw: training.finetune_filterbank(70, 8, steps=1, length=1024,
                                              **kw),
    lambda **kw: training.make_train_step(**kw)[0](np.zeros((4, 64),
                                                            np.float32)).hk,
], ids=["finetune_filterbank", "make_train_step"])
def test_training_defaults_to_cuda(build):
    """Fine-tuning runs on the card unless asked for the CPU: without a
    card the default raises naming CUDA."""
    for fn in (training.finetune_filterbank, training.make_train_step):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    else:
        build()
    build(device="cpu")
