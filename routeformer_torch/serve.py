"""Serving bundles (counterpart of ``routeformer_tpu/serve.py``).

A bundle is one ``torch.save`` file holding the model's config (as nested
plain dicts), the names of its GPS and video backbone classes and of their
config classes, and its ``state_dict`` (with the Fourier blocks' mode
indices and the HRNet BatchNorm statistics). ``load_serving_bundle``
rebuilds the model, backbone classes included, in
eval mode on a device (CUDA by default) and wraps it in a
``ServingModel`` that answers ``(gps, dense_features)`` for a batch of
numpy arrays or tensors. StableHLO export has no counterpart here.
"""

import dataclasses
import io
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from routeformer_torch.models import Routeformer, RouteformerConfig
from routeformer_torch.models.gps_backbone import GPS_BACKBONES, GPS_CONFIGS
from routeformer_torch.models.video_backbone import VIDEO_BACKBONES, VIDEO_CONFIGS
from routeformer_torch.utils import profiling
from routeformer_torch.utils.device import DeviceLike, resolve_device

BUNDLE_FILE = "model.pt"


def _as_tensor(value, device) -> torch.Tensor:
    if isinstance(value, np.ndarray):
        value = torch.from_numpy(np.ascontiguousarray(value))
    return value.to(device, non_blocking=True)


def _place(batch: dict, device) -> dict:
    """A request's tensors on ``device``."""
    with profiling.span("rf.place"):
        return {k: _as_tensor(v, device) for k, v in batch.items()}


class _Forward(torch.nn.Module):
    """``(leaves, batch) -> prediction`` of an eval-mode model whose state
    is given as leaves in ``names`` order. The model is held outside the
    module tree, so the exported program carries no weights of its own.
    Each module's own parameter and buffer slots take their leaves for the
    call and get their tensors back after it, one module object at a time:
    a tied module (FEDformer's shared encoder block, reached by several
    paths) is set and restored once (swapped per path, as
    ``torch.func.functional_call`` does, its second path's restore put
    export's fake stand-in back)."""

    def __init__(self, model: torch.nn.Module, names: List[str]):
        super().__init__()
        self.model = [model]
        leaf = {id(t): i for i, t in enumerate(
            dict([*model.named_parameters(), *model.named_buffers()])[n] for n in names)}
        self.slots = [(m, table, k, leaf[id(t)]) for m in model.modules()
                      for table in ("_parameters", "_buffers")
                      for k, t in getattr(m, table).items() if t is not None]

    def forward(self, leaves: List[torch.Tensor], batch: Dict[str, torch.Tensor]):
        saved = [getattr(m, table)[k] for m, table, k, _ in self.slots]
        try:
            for m, table, k, i in self.slots:
                getattr(m, table)[k] = leaves[i]
            out = self.model[0](batch)
        finally:
            for (m, table, k, _), t in zip(self.slots, saved):
                getattr(m, table)[k] = t
        return out[0] if isinstance(out, tuple) else out


def _eval_forward(model: torch.nn.Module):
    """The eval-mode model as a pure forward over its FLAT state leaves:
    ``(forward, leaves)``, the leaves its parameters and then its buffers
    (non-persistent ones too), in module order, as the JAX package's
    ``_eval_forward`` flattens the nnx state."""
    model.eval()
    state = dict(model.named_parameters())
    state.update(model.named_buffers())
    return _Forward(model, list(state)), [t.detach() for t in state.values()]


def export_model(model: torch.nn.Module, example_batch: dict, platforms=None) -> bytes:
    """Export the eval-mode forward, traced at ``example_batch``'s shapes and
    dtypes, to a serialized ``torch.export`` program.

    The program is traced on the device the model lies on (its kernels are
    the registered ops of that device); ``platforms``, the JAX signature's
    list of targets, may only name that device's type. Every model of the
    zoo exports, FEDformer's spectral blocks included (their arithmetic is
    real: ``models/layers/fourier.py``).
    """
    forward, leaves = _eval_forward(model)
    device = leaves[0].device
    if platforms is not None and set(platforms) != {device.type}:
        raise ValueError(f"the program is traced on {device.type}; platforms={platforms!r} "
                         f"names another target")
    batch = {k: _as_tensor(v, device) for k, v in example_batch.items()}
    with torch.no_grad():
        program = torch.export.export(forward, (leaves, batch))
    program.example_inputs = None  # else the bytes would carry the weights
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


class ExportedModel:
    """A deserialized serving artifact with the weight leaves given at load
    time (in ``_eval_forward``'s order); ``__call__(batch)`` returns the
    prediction on the leaves' device. A batch whose shapes or dtypes differ
    from the exported example's is refused."""

    def __init__(self, data: bytes, leaves):
        self._program = torch.export.load(io.BytesIO(data)).module()
        self._leaves = list(leaves)
        self.device = self._leaves[0].device

    def __call__(self, batch: dict) -> torch.Tensor:
        with profiling.span("rf.serve.request"), torch.inference_mode():
            return self._program(self._leaves, _place(batch, self.device))


def _from_dict(cls, d):
    names = {f.name for f in dataclasses.fields(cls) if f.init}
    return cls(**{k: v for k, v in d.items() if k in names})


def config_from_dict(d: dict, gps_config: str = "GPSBackboneConfig",
                     video_config: str = "TimmBackboneConfig") -> RouteformerConfig:
    """A config from its nested dict; ``gps_config``/``video_config`` name
    the backbone configs' classes."""
    d = dict(d)
    d["gps_backbone_config"] = _from_dict(GPS_CONFIGS[gps_config], d["gps_backbone_config"])
    if d.get("video_backbone_config") is not None:
        d["video_backbone_config"] = _from_dict(VIDEO_CONFIGS[video_config],
                                                d["video_backbone_config"])
    return _from_dict(RouteformerConfig, d)


def save_serving_bundle(path, model: Routeformer) -> None:
    """Write ``path/model.pt``: the config, the backbones' and their
    configs' class names and the ``state_dict``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    backbone = getattr(model, "video_backbone", None)
    cfg = model.configs
    torch.save({"config": cfg.to_dict(), "state_dict": state,
                "gps_backbone": type(model.gps_backbone).__name__,
                "gps_config": type(cfg.gps_backbone_config).__name__,
                "video_backbone": None if backbone is None else type(backbone).__name__,
                "video_config": None if backbone is None
                else type(cfg.video_backbone_config).__name__},
               path / BUNDLE_FILE)


class ServingModel:
    """An eval-mode model on one device; ``__call__(batch)`` returns
    ``(gps (B, pred_len, 2), dense (B, pred_len, emb))``."""

    def __init__(self, model: Routeformer, device: torch.device):
        self.model = model.eval()
        self.device = device

    def __call__(self, batch: dict) -> Tuple[torch.Tensor, torch.Tensor]:
        with profiling.span("rf.serve.request"), torch.inference_mode():
            return self.model(_place(batch, self.device))


def load_serving_bundle(path, device: DeviceLike = None) -> ServingModel:
    dev = resolve_device(device)
    payload = torch.load(Path(path) / BUNDLE_FILE, map_location="cpu",
                         weights_only=True)
    config = config_from_dict(payload["config"],
                              payload.get("gps_config") or "GPSBackboneConfig",
                              payload.get("video_config") or "TimmBackboneConfig")
    model = Routeformer(config,
                        gps_backbone=GPS_BACKBONES[payload.get("gps_backbone") or "Informer"],
                        video_backbone=VIDEO_BACKBONES[
                            payload.get("video_backbone") or "SwinV2Backbone"])
    model.load_state_dict(payload["state_dict"])
    return ServingModel(model.to(dev), dev)
