"""The 64-band fine-tuned bank on the port's offline path, on the CPU.

``PQMF(100, 64)`` with a bank installed by ``set_weights`` (seeded random
banks [64, 2048], which no design could give, and the committed
``hk64_atten100_finetuned``) against the benchmark's plain reference
(``benchmark/reference/tuned_bank.py`` reads the committed file by path,
``bank.polyphase_roundtrip`` takes any bank): within float32 round-off,
while the designed 64-band bank in the reference's place is far outside
it. And ``cached_conv.CLUSTERS``: each round trip whose geometry runs in
thread-block clusters on the card (M >= 32) counts one, under the kernel
of its tier, beside its one in ``KERNELS``; M <= 16 counts none; a graph
replay adds what its capture counted.
"""

import numpy as np
import pytest
import torch

import test_torch_graphs as tg
from benchmark import audio
from benchmark.reference import bank, tuned_bank
from pqmf_tpu_torch import PQMF, StreamingPQMF, graphs
from pqmf_tpu_torch.kernels import cached_conv as cc
from pqmf_tpu_torch.kernels import polyphase as pk
from pqmf_tpu_torch.ops import filterbank as fb
from pqmf_tpu_torch.parallel.training import BANK_DIR, load_pretrained_bank

NAME = "hk64_atten100_finetuned"
SR = 44100
# the f32 gap of two summation orders (the port's polyphase convs against
# the reference's), well under the pqmf64 cell's limit of 2e-5
TOL = 1e-5
LIMIT = 2e-5  # the pqmf64 cell's rel_err_max


def rel(a, b) -> float:
    return float((a.reshape(-1) - b.reshape(-1)).norm() / b.norm())


def clips(n, T, seed):
    return audio.rows(n, T, seed, SR, "cpu")


def random_bank(seed, M=64, P=2048):
    """A seeded bank of unit-scale taps in no cosine modulation: each row
    a Hann-windowed random filter."""
    rng = np.random.default_rng(seed)
    w = np.hanning(P + 2)[1:-1]
    return (rng.standard_normal((M, P)) * w / np.sqrt(P / 2)).astype(
        np.float32)


def port_roundtrip(hk, x, h=None):
    pq = PQMF(100, hk.shape[0], device="cpu")
    pq.set_weights(fb.params_from_hk(hk, h=h))
    return pq.roundtrip(x[:, None])[:, 0]


def test_reference_reads_the_committed_file():
    hk = tuned_bank.load(NAME)
    assert tuned_bank.path(NAME) == BANK_DIR / f"{NAME}.npz"
    assert hk.shape == (64, 2048) and hk.dtype == np.float32
    np.testing.assert_array_equal(hk, load_pretrained_bank(NAME)["hk"])
    # a learnt bank: no longer the design's cosine modulation (0.18% of
    # its norm away)
    designed = bank.design(100, 64)
    assert np.linalg.norm(hk - designed) > 1e-3 * np.linalg.norm(designed)


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 5])
def test_random_64_band_banks_match_the_reference(seed):
    hk = random_bank(seed)
    x = clips(2, 64 * 96, seed + 11)
    y = port_roundtrip(hk, x)
    assert y.shape == x.shape
    for b in range(2):
        assert rel(y[b], bank.polyphase_roundtrip(x[b:b + 1], hk)) <= TOL


@pytest.mark.parametrize("T", [64 * 40, 64 * 257])
def test_committed_bank_matches_the_reference(T):
    params = load_pretrained_bank(NAME)
    pq = PQMF(100, 64, device="cpu")
    pq.set_weights(params)
    x = clips(3, T, T + 7)
    y = pq.roundtrip(x[:, None])[:, 0]
    hk = tuned_bank.load(NAME)
    for b in range(3):
        assert rel(y[b], bank.polyphase_roundtrip(x[b:b + 1], hk)) <= TOL


def test_designed_bank_fails_the_bound():
    """The comparison tells the banks apart: the designed 64-band bank fed
    to the reference in the tuned one's place misses the port by about
    1e-3, a hundred times the bound and ten times the cell's limit."""
    pq = PQMF(100, 64, device="cpu")
    pq.set_weights(load_pretrained_bank(NAME))
    x = clips(2, 64 * 257, 3)
    y = pq.roundtrip(x[:, None])[:, 0]
    designed = bank.design(100, 64)
    for b in range(2):
        assert rel(y[b], bank.polyphase_roundtrip(x[b:b + 1],
                                                  designed)) > 10 * LIMIT


def _k3_call(M, precision, seed=0):
    """One round trip through K6's route (K3 / K3t's operator) at M bands
    of the committed (M >= 8) bank."""
    params = load_pretrained_bank(f"hk{M}_atten100_finetuned")
    hp = torch.from_numpy(params["hk_poly"])
    hi = torch.from_numpy(params["hk_ipoly"])
    x = clips(1, M * 64, seed)[:, None]
    return pk.roundtrip_over_k3(x, pk.analysis_weights(hp), hi, M, precision)


@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
@pytest.mark.parametrize("M", [16, 32, 64])
def test_clusters_count_round_trips_of_32_bands_and_more(M, precision):
    kernel = "K3" if precision == "highest" else "K3t"
    cc.reset_launches()
    _k3_call(M, precision)
    assert cc.KERNELS == {**dict.fromkeys(cc.KERNELS, 0), kernel: 1}
    assert cc.CLUSTERS == {**dict.fromkeys(cc.CLUSTERS, 0),
                           **({kernel: 1} if M >= 32 else {})}
    cc.reset_launches()
    assert cc.CLUSTERS == {"K3": 0, "K3t": 0}


def test_streaming_round_trip_counts_a_cluster():
    """``StreamingPQMF.roundtrip`` at M = 64 (one K3) counts one in each."""
    pq = StreamingPQMF(100, 64, device="cpu")
    cc.reset_launches()
    pq.roundtrip(clips(1, 64 * 64, 1))
    assert cc.KERNELS["K3"] == 1 and cc.CLUSTERS == {"K3": 1, "K3t": 0}


def test_a_replay_adds_the_captured_clusters(monkeypatch):
    """``CLUSTERS`` is one of the counters a replay adds to: the eager call
    counts, the capture adds nothing, each replay adds the captured one."""
    cap = tg.StandIn()
    monkeypatch.setattr(graphs, "_graphed", lambda device: True)
    monkeypatch.setattr(graphs, "_capture", cap)
    monkeypatch.setattr(graphs, "_capturing", lambda: cap.capturing)
    # the stand-in's replay runs the body again: keep every counter there
    monkeypatch.setattr(tg, "_counts", graphs._counts)
    monkeypatch.setattr(tg, "_restore", lambda counts: [
        c.update(b) for c, b in zip(graphs._ALL, counts)])
    assert cc.CLUSTERS in graphs._ALL
    assert graphs._ALL[-1] is graphs.COLLECTIVES

    def body(x):
        return _k3_call(64, "highest") + x

    cc.reset_launches()
    cache, key = {}, ("clusters", 64, "highest", torch.device("cpu"), 0)
    for n in range(1, 4):
        graphs.call(cache, key, body, torch.zeros(1, 1, 64 * 64))
        assert cc.CLUSTERS == {"K3": n, "K3t": 0}
        assert cc.KERNELS["K3"] == n
    assert cap.events == ["capture", "replay", "replay"]
