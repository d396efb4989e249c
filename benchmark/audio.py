"""The benchmark's audio, made from the seed on the device that asks.

Music-like rows rather than a lone sine (whose near-empty STFT bins make
the reference phase rule ill-conditioned): per row, ``voices`` notes of
``harmonics`` partials each (fundamentals log-uniform over
``f0_range``, partial amplitudes ~ 1/h, random phases), each voice under
a slow tremolo, plus noise shaped to fall 3 dB an octave (pink), scaled
to ``rms``. Drawn with one ``torch.Generator`` on ``device`` in a few
large calls; the same seed gives the same rows on the same device.
"""

from __future__ import annotations

import math

import torch

__all__ = ["DEFAULT", "rows", "pool"]

DEFAULT = {"voices": 3, "harmonics": 8, "f0_range": [55.0, 880.0],
           "tremolo_hz": [0.5, 3.0], "noise_share": 0.2, "rms": 0.1}


def _uniform(g, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


def rows(n_rows: int, n_samples: int, seed: int, sample_rate: int,
         device, params: dict | None = None, chunk: int = 1 << 20):
    """``n_rows`` rows of ``n_samples`` float32 samples on ``device``."""
    p = {**DEFAULT, **(params or {})}
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    V, H = int(p["voices"]), int(p["harmonics"])
    lo, hi = (math.log(f) for f in p["f0_range"])
    f0 = torch.exp(_uniform(g, (n_rows, V, 1), lo, hi, device))
    h = torch.arange(1, H + 1, device=device, dtype=torch.float32)
    freq = f0 * h                                          # [R, V, H]
    amp = _uniform(g, (n_rows, V, H), 0.5, 1.0, device) / h
    amp = amp * (freq < 0.45 * sample_rate)                # below Nyquist
    phase = _uniform(g, (n_rows, V, H), 0.0, 2 * math.pi, device)
    trem_f = _uniform(g, (n_rows, V, 1), *p["tremolo_hz"], device)
    trem_p = _uniform(g, (n_rows, V, 1), 0.0, 2 * math.pi, device)
    tone = torch.empty((n_rows, n_samples), device=device)
    w = 2 * math.pi / sample_rate
    for s in range(0, n_samples, chunk):
        # float64 time keeps the phase exact over minutes of audio
        t = torch.arange(s, min(s + chunk, n_samples), device=device,
                         dtype=torch.float64)[None, None, None, :]
        arg = (w * freq[..., None] * t + phase[..., None]).remainder(
            2 * math.pi).float()
        part = (amp[..., None] * torch.sin(arg)).sum(2)    # [R, V, n]
        env = 0.6 + 0.4 * torch.sin(
            (w * trem_f[..., None] * t + trem_p[..., None]).float())[:, :, 0]
        tone[:, s:s + t.shape[-1]] = (part * env).sum(1)
    noise = torch.randn((n_rows, n_samples), generator=g, device=device)
    spec = torch.fft.rfft(noise, dim=-1)
    f = torch.arange(spec.shape[-1], device=device, dtype=torch.float32)
    spec = spec / torch.sqrt(f.clamp_min(20.0 * n_samples / sample_rate))
    noise = torch.fft.irfft(spec, n=n_samples, dim=-1)

    def unit(v):
        return v / v.pow(2).mean(-1, keepdim=True).sqrt().clamp_min(1e-12)

    share = float(p["noise_share"])
    x = (1 - share) * unit(tone) + share * unit(noise)
    return (float(p["rms"]) * unit(x)).contiguous()


def pool(n_rows: int, block: int, n_items: int, seed: int, sample_rate: int,
         device, placement: str, params: dict | None = None) -> list:
    """The inputs a window cycles through: ``n_items`` consecutive blocks
    [n_rows, block] of each row's audio, on ``device`` (``placement``
    "device") or as pageable host tensors ("host")."""
    x = rows(n_rows, n_items * block, seed, sample_rate, device, params)
    items = [x[:, i * block:(i + 1) * block].contiguous()
             for i in range(n_items)]
    if placement == "host":
        items = [t.cpu() for t in items]
    elif placement != "device":
        raise ValueError(f"unknown placement {placement!r}")
    return items
