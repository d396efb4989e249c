"""Per-layer metrics, one reader a file (``<name>.py``, or the family's
``<name up to the first dot>.py`` that serves every cell's variant of a
metric, as ``idle_share.py`` serves ``idle_share.live``): ``read(t)`` of a
traced slice ``t`` (``tracing.Traced``; ``t.context`` holds the cell's
configuration, traffic, rows and block, and the untraced ``window`` of
the same run) returns the value, or None when the slice holds nothing it
reads."""

# the PQMF kernels of pqmf_tpu_torch/csrc (analysis K1/K1t, synthesis
# K2/K2t, round trip K3/K3t and its clusters); every other kernel of a
# flagship step is the middle's (STFT, stretch, ISTFT, resample, crossfade)
PQMF_KERNELS = ("analysis_kernel", "synthesis_kernel", "roundtrip_kernel",
                "roundtrip_cluster_kernel", "conv_tc_kernel",
                "roundtrip_tc_kernel")


def per_call_ms(t, seconds: float):
    return seconds / t.calls * 1e3 if t.calls else None
