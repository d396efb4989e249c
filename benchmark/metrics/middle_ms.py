"""Device ms a call of the kernels that are not the port's PQMF kernels
(``metrics.PQMF_KERNELS``): the flagship's middle (STFT, stretch, ISTFT,
resample, crossfade) and the graph's input and output copies' kernels."""

from benchmark.metrics import PQMF_KERNELS, per_call_ms


def read(t):
    if not t.count("kernel"):
        return None
    return per_call_ms(t, t.seconds("kernel", exclude=PQMF_KERNELS))
