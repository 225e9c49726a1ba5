"""Serving bundles (counterpart of ``routeformer_tpu/serve.py``).

A bundle is one ``torch.save`` file holding the model's config (as nested
plain dicts), the name of its video backbone class and its ``state_dict``.
``load_serving_bundle`` rebuilds the model, backbone class included, in
eval mode on a device (CUDA by default) and wraps it in a
``ServingModel`` that answers ``(gps, dense_features)`` for a batch of
numpy arrays or tensors. StableHLO export has no counterpart here.
"""

import dataclasses
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from routeformer_torch.models import Routeformer, RouteformerConfig
from routeformer_torch.models.gps_backbone import GPSBackboneConfig
from routeformer_torch.models.video_backbone import VIDEO_BACKBONES, TimmBackboneConfig
from routeformer_torch.utils.device import DeviceLike, resolve_device

BUNDLE_FILE = "model.pt"


def _from_dict(cls, d):
    names = {f.name for f in dataclasses.fields(cls) if f.init}
    return cls(**{k: v for k, v in d.items() if k in names})


def config_from_dict(d: dict) -> RouteformerConfig:
    d = dict(d)
    d["gps_backbone_config"] = _from_dict(GPSBackboneConfig, d["gps_backbone_config"])
    if d.get("video_backbone_config") is not None:
        d["video_backbone_config"] = _from_dict(TimmBackboneConfig,
                                                d["video_backbone_config"])
    return _from_dict(RouteformerConfig, d)


def save_serving_bundle(path, model: Routeformer) -> None:
    """Write ``path/model.pt``: the config, the video backbone's class name
    and the ``state_dict``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    backbone = getattr(model, "video_backbone", None)
    torch.save({"config": model.configs.to_dict(), "state_dict": state,
                "video_backbone": None if backbone is None else type(backbone).__name__},
               path / BUNDLE_FILE)


class ServingModel:
    """An eval-mode model on one device; ``__call__(batch)`` returns
    ``(gps (B, pred_len, 2), dense (B, pred_len, emb))``."""

    def __init__(self, model: Routeformer, device: torch.device):
        self.model = model.eval()
        self.device = device

    def _to_device(self, value):
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(np.ascontiguousarray(value))
        return value.to(self.device, non_blocking=True)

    def __call__(self, batch: dict) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.inference_mode():
            return self.model({k: self._to_device(v) for k, v in batch.items()})


def load_serving_bundle(path, device: DeviceLike = None) -> ServingModel:
    dev = resolve_device(device)
    payload = torch.load(Path(path) / BUNDLE_FILE, map_location="cpu",
                         weights_only=True)
    backbone = VIDEO_BACKBONES[payload.get("video_backbone") or "SwinV2Backbone"]
    model = Routeformer(config_from_dict(payload["config"]), video_backbone=backbone)
    model.load_state_dict(payload["state_dict"])
    return ServingModel(model.to(dev), dev)
