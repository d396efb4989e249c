"""Linear resampling of the flagship's stretched bands.

PyTorch counterpart of ``pqmf_tpu/ops/resample.py``'s
``interpolate_linear_dynamic``, lowered as a plain gather lerp (the JAX
package's one-hot, chunked and prefolded forms exist only for the TPU).
"""

from __future__ import annotations

import torch

__all__ = ["interpolate_linear_dynamic"]


def interpolate_linear_dynamic(x: torch.Tensor, src_len: torch.Tensor,
                               size: int) -> torch.Tensor:
    """``F.interpolate(mode='linear', align_corners=False)`` of the valid
    prefix ``x[..., :src_len]`` to ``size`` samples.

    x: [..., T]; src_len: int tensor broadcastable to ``x.shape[:-1]`` (one
    length per row of a padded buffer). Returns [..., size]. Source
    coordinate of output i: ``(i + 0.5) * src_len/size - 0.5`` clamped to
    [0, src_len - 1].

    Agrees with the JAX one-hot matmul form to the last bit except where
    the clamp makes i0 == i1 (the last output sample of some lengths):
    there the one-hot form sums the weights first, ``((1-a)+a)*x`` against
    ``x*(1-a) + x*a`` here, which can differ by one ulp."""
    T = x.shape[-1]
    sl = src_len.unsqueeze(-1)
    slf = sl.to(torch.float32)
    pos = torch.arange(size, dtype=torch.float32, device=x.device)
    src = (pos + 0.5) * (slf / size) - 0.5
    src = torch.minimum(src.clamp_min(0.0), (slf - 1).clamp_min(0.0))
    i0 = torch.floor(src).to(torch.int64)
    i1 = torch.minimum(i0 + 1, (sl - 1).clamp_min(0))
    i0 = i0.clamp(0, T - 1)
    i1 = i1.clamp(0, T - 1)
    a = (src - i0.to(torch.float32)).to(x.dtype)
    shape = (*x.shape[:-1], size)
    x0 = torch.gather(x, -1, i0.expand(shape))
    x1 = torch.gather(x, -1, i1.expand(shape))
    return x0 * (1 - a) + x1 * a
