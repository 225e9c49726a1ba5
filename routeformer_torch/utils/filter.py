"""Time-series filters (counterpart of ``routeformer_tpu/utils/filter.py``)."""

import torch


def median_downsampler(tensor: torch.Tensor, target_length: int) -> torch.Tensor:
    """Lower median of each ``time_steps // target_length`` window.

    ``(B, T, C) -> (B, target_length, C)``; trailing samples beyond
    ``target_length * stride`` are dropped, as in the reference.
    """
    batch, time_steps, channels = tensor.shape
    if target_length >= time_steps:
        raise ValueError("Target length must be less than the current time steps.")
    stride = time_steps // target_length
    windows = tensor[:, : target_length * stride].reshape(
        batch, target_length, stride, channels
    )
    return torch.sort(windows, dim=2).values[:, :, (stride - 1) // 2, :]
