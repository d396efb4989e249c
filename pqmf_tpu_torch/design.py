"""L0 — Prototype filter design (host-side numerics, pure NumPy).

TPU-native rebuild of the reference's filter-design layer
(reference: pqmf.py:66-112 — ``kaiser_filter``, ``loss_wc``, ``get_prototype``).

The reference relies on ``scipy.signal.kaiserord/firwin/kaiser_beta`` and
``scipy.optimize.fmin``. This module reimplements that design chain in pure
NumPy so the framework has no SciPy runtime dependency, while remaining
float-tolerance comparable with SciPy's output (verified in
``tests/test_design.py`` against SciPy when it is importable).

Everything here runs ONCE on the host at model-construction/trace time and
never inside the jitted TPU compute path.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "kaiser_beta",
    "kaiserord",
    "kaiser_window",
    "firwin_lowpass",
    "kaiser_filter",
    "loss_wc",
    "nelder_mead",
    "get_prototype",
]


def kaiser_beta(a: float) -> float:
    """Kaiser window beta parameter for ``a`` dB of stopband attenuation.

    Matches ``scipy.signal.kaiser_beta`` (Kaiser's empirical formula).
    """
    if a > 50:
        return 0.1102 * (a - 8.7)
    if a > 21:
        return 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21)
    return 0.0


def kaiserord(ripple: float, width: float) -> tuple[int, float]:
    """Kaiser filter-order estimate.

    Matches ``scipy.signal.kaiserord``: given ripple (dB, positive) and
    transition width as a fraction of the Nyquist rate, return
    ``(numtaps, beta)``.
    """
    a = abs(ripple)
    if a < 8:
        raise ValueError(
            "Requested maximum ripple attenuation is too small for the "
            "Kaiser formula."
        )
    beta = kaiser_beta(a)
    numtaps = (a - 7.95) / 2.285 / (np.pi * width) + 1
    return int(np.ceil(numtaps)), beta


def kaiser_window(numtaps: int, beta: float) -> np.ndarray:
    """Symmetric Kaiser window (same formula as ``np.kaiser`` /
    ``scipy.signal.windows.kaiser(sym=True)``)."""
    if numtaps == 1:
        return np.ones(1)
    n = np.arange(0, numtaps)
    alpha = (numtaps - 1) / 2.0
    return np.i0(beta * np.sqrt(1 - ((n - alpha) / alpha) ** 2)) / np.i0(beta)


def firwin_lowpass(
    numtaps: int, cutoff, beta: float, fs: float = 2 * np.pi
) -> np.ndarray:
    """Kaiser-windowed sinc lowpass FIR, equivalent to
    ``scipy.signal.firwin(numtaps, cutoff, window=('kaiser', beta),
    scale=False, fs=fs)`` for the single-cutoff lowpass case.
    """
    cutoff = float(np.asarray(cutoff).reshape(-1)[0])
    nyq = fs / 2.0
    c = cutoff / nyq  # normalized to Nyquist, band is [0, c]
    if not 0 < c < 1:
        raise ValueError(f"cutoff must be in (0, nyquist); got {cutoff}")
    alpha = 0.5 * (numtaps - 1)
    m = np.arange(0, numtaps) - alpha
    h = c * np.sinc(c * m)  # right edge; left edge (0) contributes nothing
    h *= kaiser_window(numtaps, beta)
    # scale=False in the reference: no passband-gain normalization
    return h


def kaiser_filter(wc, atten: float, N: int | None = None) -> np.ndarray:
    """Kaiser-window lowpass design (reference: pqmf.py:66-85).

    Parameters
    ----------
    wc : float
        Angular cutoff frequency in (0, pi).
    atten : float
        Stopband attenuation in dB (positive).
    N : int, optional
        Forced (odd) filter length. If None, the minimal odd length
        satisfying the attenuation is used.
    """
    wc = float(np.asarray(wc).reshape(-1)[0])
    N_, beta = kaiserord(atten, wc / np.pi)
    N_ = 2 * (N_ // 2) + 1  # force odd
    N = N if N is not None else N_
    return firwin_lowpass(N, wc, beta, fs=2 * np.pi)


def loss_wc(wc, atten: float, M: int, N: int | None = None) -> float:
    """Amplitude-distortion objective from Lin & Vaidyanathan (IEEE 681427)
    (reference: pqmf.py:88-95): autocorrelate the prototype, sample every
    ``2M`` lags from the center, skip lag 0, return the max magnitude.
    """
    h = kaiser_filter(wc, atten, N)
    g = np.convolve(h, h[::-1], "full")
    g = np.abs(g[g.shape[-1] // 2 :: 2 * M][1:])
    return float(np.max(g))


def nelder_mead(
    func,
    x0,
    xtol: float = 1e-4,
    ftol: float = 1e-4,
    maxiter: int | None = None,
    maxfun: int | None = None,
) -> np.ndarray:
    """Nelder–Mead simplex minimization, matching ``scipy.optimize.fmin``'s
    algorithm and default tolerances step-for-step (so the optimized cutoff
    — and therefore the designed filter — is identical to the reference's).
    """
    x0 = np.asarray(x0, dtype=float).flatten()
    n = len(x0)
    if maxiter is None:
        maxiter = n * 200
    if maxfun is None:
        maxfun = n * 200

    rho, chi, psi, sigma = 1.0, 2.0, 0.5, 0.5
    nonzdelt, zdelt = 0.05, 0.00025

    sim = np.empty((n + 1, n), dtype=float)
    sim[0] = x0
    for k in range(n):
        y = x0.copy()
        if y[k] != 0:
            y[k] = (1 + nonzdelt) * y[k]
        else:
            y[k] = zdelt
        sim[k + 1] = y

    fsim = np.full(n + 1, np.inf)
    for k in range(n + 1):
        fsim[k] = func(sim[k])
    fcalls = n + 1

    ind = np.argsort(fsim)
    fsim = np.take(fsim, ind, 0)
    sim = np.take(sim, ind, 0)

    iterations = 1
    while fcalls < maxfun and iterations < maxiter:
        if (
            np.max(np.ravel(np.abs(sim[1:] - sim[0]))) <= xtol
            and np.max(np.abs(fsim[0] - fsim[1:])) <= ftol
        ):
            break

        xbar = np.add.reduce(sim[:-1], 0) / n
        xr = (1 + rho) * xbar - rho * sim[-1]
        fxr = func(xr)
        fcalls += 1
        doshrink = False

        if fxr < fsim[0]:
            xe = (1 + rho * chi) * xbar - rho * chi * sim[-1]
            fxe = func(xe)
            fcalls += 1
            if fxe < fxr:
                sim[-1] = xe
                fsim[-1] = fxe
            else:
                sim[-1] = xr
                fsim[-1] = fxr
        else:  # fsim[0] <= fxr
            if fxr < fsim[-2]:
                sim[-1] = xr
                fsim[-1] = fxr
            else:  # fxr >= fsim[-2]
                if fxr < fsim[-1]:
                    xc = (1 + psi * rho) * xbar - psi * rho * sim[-1]
                    fxc = func(xc)
                    fcalls += 1
                    if fxc <= fxr:
                        sim[-1] = xc
                        fsim[-1] = fxc
                    else:
                        doshrink = True
                else:
                    xcc = (1 - psi) * xbar + psi * sim[-1]
                    fxcc = func(xcc)
                    fcalls += 1
                    if fxcc < fsim[-1]:
                        sim[-1] = xcc
                        fsim[-1] = fxcc
                    else:
                        doshrink = True
                if doshrink:
                    for j in range(1, n + 1):
                        sim[j] = sim[0] + sigma * (sim[j] - sim[0])
                        fsim[j] = func(sim[j])
                        fcalls += 1

        ind = np.argsort(fsim)
        sim = np.take(sim, ind, 0)
        fsim = np.take(fsim, ind, 0)
        iterations += 1

    return sim[0]


@functools.lru_cache(maxsize=64)
def _get_prototype_cached(atten: float, M: int, N: int | None):
    wc = nelder_mead(lambda w: loss_wc(w, atten, M, N), 1.0 / M)[0]
    h = kaiser_filter(wc, atten, N)
    h.setflags(write=False)
    return h


def get_prototype(atten: float, M: int, N: int | None = None) -> np.ndarray:
    """Design the PQMF prototype filter (reference: pqmf.py:98-112):
    Nelder–Mead over the cutoff, initialized at ``1/M``, minimizing
    :func:`loss_wc`; return the Kaiser filter at the optimum.

    The design is deterministic, so results are memoized per
    ``(atten, M, N)`` — the reference re-runs the whole Nelder–Mead chain on
    every module construction.
    """
    return _get_prototype_cached(float(atten), int(M), N).copy()
