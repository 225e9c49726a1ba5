"""Utility layer: config base, device rule, vector math, filters, logging."""

from routeformer_torch.utils.config import BaseConfig
from routeformer_torch.utils.device import init_on_cpu, resolve_device
from routeformer_torch.utils.filter import median_downsampler
from routeformer_torch.utils.logging import set_logger_config
from routeformer_torch.utils.vector import estimate_angle, estimate_angle_and_norm, rotate

__all__ = ["BaseConfig", "estimate_angle", "estimate_angle_and_norm", "init_on_cpu",
           "median_downsampler", "resolve_device", "rotate", "set_logger_config"]
