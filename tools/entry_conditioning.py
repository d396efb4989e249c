"""How well-conditioned the flagship entry step is on its example input.

Runs on the CPU, both packages:

    JAX_PLATFORMS=cpu python tools/entry_conditioning.py

Prints, as one JSON line:
- ``jax_1ulp_db``: the JAX entry's output against itself with its example
  input (``sin(linspace(0, 800 pi, 8192))``) moved by one ulp;
- ``example_y_db`` / ``example_tail_db``: ``pqmf_tpu_torch.entry.entry
  (device="cpu")``'s step against ``__graft_entry__.entry()``'s on that
  input, three carried steps (the lowest);
- ``blocks_y_db`` / ``blocks_tail_db``: the same on three seeded audio
  blocks (``tests/test_torch_entry.py``'s);
- ``wrong_config_db``: the example input through wrappers configured
  otherwise (no shift, attenuation 70, the accumulating phase rule)
  against the JAX entry;
- ``stft``: for the band that carries the sine, each package's f32 STFT
  of the same sub-band against the float64 DFT: the largest error, how
  many bins sit at noise level (under 1e-5 of the peak), and the median
  error relative to the bin's magnitude there.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> None:
    import jax.numpy as jnp
    import torch

    import __graft_entry__ as jentry
    from pqmf_tpu.ops import stft as jS
    from pqmf_tpu.pipelines import PQMFPitchShiftWrapper as JW
    from pqmf_tpu_torch import entry as tentry
    from pqmf_tpu_torch.ops import stft as tS
    from pqmf_tpu_torch.utils.metrics import snr_db

    fn, (tail, x) = jentry.entry()
    t_fn, (t_tail, t_x) = tentry.entry(device="cpu")
    _, y0 = fn(tail, x)
    _, y1 = fn(tail, x * np.float32(1 + 2 ** -23))
    out = {"jax_1ulp_db": snr_db(np.asarray(y0), np.asarray(y1))}

    def carried(xs_j, xs_t):
        tj, tt, ys, tails = tail, t_tail, [], []
        for xj, xt in zip(xs_j, xs_t):
            tj, yj = fn(tj, xj)
            tt, yt = t_fn(tt, xt)
            ys.append(snr_db(np.asarray(yj), yt.numpy()))
            tails.append(snr_db(np.asarray(tj), tt.numpy()))
        return min(ys), min(tails)

    out["example_y_db"], out["example_tail_db"] = carried([x] * 3,
                                                          [t_x] * 3)
    rng = np.random.default_rng(23)
    blocks = [(0.3 * rng.standard_normal((1, 1, 8192))).astype(np.float32)
              for _ in range(3)]
    out["blocks_y_db"], out["blocks_tail_db"] = carried(
        [jnp.asarray(b) for b in blocks], [torch.from_numpy(b)
                                           for b in blocks])

    # the example input against a wrapper configured otherwise than the
    # entry (tests/test_torch_entry.py's cases)
    from pqmf_tpu_torch.pipelines import PQMFPitchShiftWrapper as TW

    out["wrong_config_db"] = {}
    for name, change in (("no_shift", dict(shifts_in_semitones=[0] * 16)),
                         ("atten70", dict(attenuation=70)),
                         ("rule", dict(phase_rule="accumulate"))):
        w = TW(**{**dict(attenuation=100, n_band=16, m_buffer_size=8192,
                         device="cpu"), **change})
        _, yw = w.pitchshift_fn(w.init_state(), t_x)
        out["wrong_config_db"][name] = snr_db(np.asarray(y0), yw.numpy())

    jw = JW(attenuation=100, n_band=16, m_buffer_size=8192)
    band = np.array(jw.decompose(x))[0, 1][None]  # the sine's band
    n_fft, hop, win = jw.n_fft, jw.hop, jw.win
    jre, jim = (np.asarray(a, np.float64) for a in jS.stft_ri(
        jnp.asarray(band), n_fft, hop, jS.hann_window(win),
        normalized=True))
    tb = torch.from_numpy(band)
    tre, tim = (a.double().numpy() for a in tS.stft_ri(
        tb, n_fft, hop, tS.hann_window(win), normalized=True))
    ere, eim = (a.numpy() for a in tS.stft_ri(
        tb.double(), n_fft, hop, tS.hann_window(win, torch.float64),
        normalized=True))
    ej = np.hypot(jre - ere, jim - eim)
    et = np.hypot(tre - ere, tim - eim)
    mag = np.hypot(ere, eim)
    noise = mag < 1e-5 * mag.max()
    out["stft"] = {
        "peak_magnitude": float(mag.max()),
        "jax_max_err": float(ej.max()), "port_max_err": float(et.max()),
        "noise_level_bins": int(noise.sum()),
        "noise_level_share": float(noise.mean()),
        # at those bins an error of |X| turns the phase by up to a radian
        "jax_median_err_over_mag_there": float(np.median(ej[noise]
                                                         / mag[noise])),
        "port_median_err_over_mag_there": float(np.median(et[noise]
                                                          / mag[noise]))}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
