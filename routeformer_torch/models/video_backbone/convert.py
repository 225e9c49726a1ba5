"""Torch checkpoints into the port's video backbones (counterpart of
``routeformer_tpu/models/video_backbone/convert.py``).

Weights arrive as files (there is no hub download): a torch ``state_dict``
(or a dict of numpy arrays) is mapped onto a module whose names follow the
flax paths.

- ``load_torch_state_dict``: name matching after the JAX package's
  normalisation (``kernel``/``scale`` -> ``weight``, ``mean``/``var`` ->
  ``running_mean``/``running_var``), with its fuzzy fallback (suffix
  matching when prefixes differ) and its layouts: a tensor loads in torch
  layout, a 4-D one also in flax's HWIO, a 3-D one in flax's KIO. Returns
  ``(loaded, total)`` over the module's ``convert.flax_state`` entries
  (parameters and BatchNorm statistics), visited in flax's sorted path
  order; unmatched entries keep their values.
- ``load_timm_vit`` / ``load_timm_swin``: the timm layouts onto
  ``TimmBackbone`` / ``SwinV2Backbone``, counting a per-layer family
  (``blocks.{i}.norm1.weight`` for every i) once, as the JAX package counts
  its stacked parameter.
- ``load_hrnet_torch``: the hrnetv2/LightHRNet names (``hr16s_4k_slim.pth``)
  onto ``HighResolutionNet16`` (``_translate_hrnet_key``).
- ``load_torch_checkpoint``: a ``.pth``/``.pt`` file, a Lightning
  ``state_dict`` inside it unwrapped. Files are read with
  ``torch.load(weights_only=True)`` only.
"""

import re
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from routeformer_torch.convert import flax_state
from routeformer_torch.utils.logging import get_logger

logger = get_logger("video_backbone.convert")

_RENAMES = (("kernel", "weight"), ("scale", "weight"), ("mean", "running_mean"),
            ("var", "running_var"))


def _to_numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _norm(name: str) -> str:
    name = name.replace("/", ".")
    for old, new in _RENAMES:
        if name.endswith("." + old):
            return name[: -len(old)] + new
    return name


def _layout(arr: np.ndarray, shape: Tuple[int, ...]):
    """``arr`` in the target's torch layout, or None."""
    if arr.shape == shape:
        return arr
    if arr.ndim == 4 and arr.transpose(3, 2, 0, 1).shape == shape:  # HWIO -> OIHW
        return arr.transpose(3, 2, 0, 1)
    if arr.ndim == 3 and arr.transpose(2, 1, 0).shape == shape:  # KIO -> OIK
        return arr.transpose(2, 1, 0)
    return None


def _flax_order(name: str):
    return tuple((0, int(p), "") if p.isdigit() else (1, 0, p) for p in name.split("."))


def load_torch_state_dict(module: nn.Module, state_dict: Dict, fuzzy: bool = True
                          ) -> Tuple[int, int]:
    """Load a state dict into ``module`` in place; ``(loaded, total)``."""
    state = flax_state(module)
    available = {k: _to_numpy(v) for k, v in state_dict.items()}
    loaded = 0
    with torch.no_grad():
        for name in sorted(state, key=_flax_order):
            target = state[name]
            candidates = [k for k in available if _norm(k) == name]
            if not candidates and fuzzy:
                candidates = [k for k in available
                              if _norm(k).endswith(name) or name.endswith(_norm(k))]
            for cand in candidates:
                arr = _layout(available[cand], tuple(target.shape))
                if arr is not None:
                    target.copy_(torch.from_numpy(np.ascontiguousarray(arr)).to(target.dtype))
                    available.pop(cand)
                    loaded += 1
                    break
            else:
                logger.info("no checkpoint match for %s %s", name, tuple(target.shape))
    logger.info("loaded %d/%d params from checkpoint", loaded, len(state))
    return loaded, len(state)


class _Loader:
    """Copies timm tensors into parameters, counting each family once."""

    def __init__(self, state_dict: Dict):
        self.sd = {k: _to_numpy(v) for k, v in state_dict.items()}
        self.loaded = 0

    def put(self, params, arrays) -> None:
        """One family: ``params`` and ``arrays`` per layer (or one each)."""
        if isinstance(params, torch.Tensor):
            params, arrays = [params], [arrays]
        with torch.no_grad():
            for p, a in zip(params, arrays):
                a = np.asarray(a)
                assert a.shape == tuple(p.shape), (a.shape, tuple(p.shape))
                p.copy_(torch.from_numpy(np.ascontiguousarray(a)).to(p.dtype))
        self.loaded += 1


def load_timm_vit(backbone, state_dict: Dict) -> int:
    """A timm ViT state dict (``patch_embed.proj``, ``pos_embed``,
    ``blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}``,
    ``norm``) into a ``TimmBackbone``; returns the families loaded."""
    ld = _Loader(state_dict)
    sd = ld.sd
    ld.put(backbone.patch_embed.weight, sd["patch_embed.proj.weight"])
    ld.put(backbone.patch_embed.bias, sd["patch_embed.proj.bias"])
    pos = sd["pos_embed"]
    if pos.shape[1] == backbone.pos_embed.shape[1] + 1:
        pos = pos[:, 1:]  # drop the cls token's position
    ld.put(backbone.pos_embed, pos)
    ld.put(backbone.norm.weight, sd["norm.weight"])
    ld.put(backbone.norm.bias, sd["norm.bias"])
    blocks = backbone.blocks
    for ours, theirs in (("norm1", "norm1"), ("norm2", "norm2"), ("qkv", "attn.qkv"),
                         ("proj", "attn.proj"), ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
        for leaf in ("weight", "bias"):
            ld.put([getattr(getattr(b, ours), leaf) for b in blocks],
                   [sd[f"blocks.{i}.{theirs}.{leaf}"] for i in range(len(blocks))])
    logger.info("loaded %d ViT params (depth %d)", ld.loaded, len(blocks))
    return ld.loaded


_SWIN_BLOCK = (("norm1.weight", "norm1.weight"), ("norm1.bias", "norm1.bias"),
               ("norm2.weight", "norm2.weight"), ("norm2.bias", "norm2.bias"),
               ("attn.qkv.weight", "attn.qkv.weight"), ("attn.q_bias", "attn.q_bias"),
               ("attn.v_bias", "attn.v_bias"), ("attn.logit_scale", "attn.logit_scale"),
               ("attn.proj.weight", "attn.proj.weight"), ("attn.proj.bias", "attn.proj.bias"),
               ("attn.cpb_fc1.weight", "attn.cpb_mlp.0.weight"),
               ("attn.cpb_fc1.bias", "attn.cpb_mlp.0.bias"),
               ("attn.cpb_fc2.weight", "attn.cpb_mlp.2.weight"),
               ("fc1.weight", "mlp.fc1.weight"), ("fc1.bias", "mlp.fc1.bias"),
               ("fc2.weight", "mlp.fc2.weight"), ("fc2.bias", "mlp.fc2.bias"))


def load_timm_swin(backbone, state_dict: Dict) -> int:
    """A timm SwinV2 state dict into a ``SwinV2Backbone``: timm block
    ``2p`` is pair ``p``'s ``block_a``, ``2p+1`` its ``block_b``. timm's
    patch merging concatenates the 2x2 group as (0,0), (1,0), (0,1), (1,1)
    and this build as (0,0), (0,1), (1,0), (1,1): the reduction's input
    groups are permuted [0, 2, 1, 3]. Returns the families loaded."""
    ld = _Loader(state_dict)
    sd = ld.sd
    ld.put(backbone.patch_embed.weight, sd["patch_embed.proj.weight"])
    ld.put(backbone.patch_embed.bias, sd["patch_embed.proj.bias"])
    ld.put(backbone.patch_norm.weight, sd["patch_embed.norm.weight"])
    ld.put(backbone.patch_norm.bias, sd["patch_embed.norm.bias"])
    ld.put(backbone.final_norm.weight, sd["norm.weight"])
    ld.put(backbone.final_norm.bias, sd["norm.bias"])
    for si, stage in enumerate(backbone.stages):
        for offset, half in ((0, "block_a"), (1, "block_b")):
            blocks = [getattr(pair, half) for pair in stage.pairs]
            for ours, theirs in _SWIN_BLOCK:
                ld.put([b.get_parameter(ours) for b in blocks],
                       [sd[f"layers.{si}.blocks.{2 * p + offset}.{theirs}"]
                        for p in range(len(blocks))])
        if str(si) in backbone.merges:
            merge = backbone.merges[str(si)]
            red = sd[f"layers.{si}.downsample.reduction.weight"]  # (2C, 4C)
            c = red.shape[1] // 4
            red = red.reshape(red.shape[0], 4, c)[:, (0, 2, 1, 3), :]
            ld.put(merge.reduction.weight, red.reshape(red.shape[0], 4 * c))
            ld.put(merge.norm.weight, sd[f"layers.{si}.downsample.norm.weight"])
            ld.put(merge.norm.bias, sd[f"layers.{si}.downsample.norm.bias"])
    logger.info("loaded %d SwinV2 params", ld.loaded)
    return ld.loaded


_HRNET_TRANSITION_CHAIN = re.compile(r"^(transition\d)\.(\d+)\.(\d+)\.([01])\.(.+)$")
_HRNET_TRANSITION_SIMPLE = re.compile(r"^(transition\d)\.(\d+)\.([01])\.(.+)$")
_HRNET_FUSE_CHAIN = re.compile(r"^(stage\d\.\d+)\.fuse_layers\.(\d+)\.(\d+)\.(\d+)\.([01])\.(.+)$")
_HRNET_FUSE_SIMPLE = re.compile(r"^(stage\d\.\d+)\.fuse_layers\.(\d+)\.(\d+)\.([01])\.(.+)$")


def _translate_hrnet_key(key: str) -> str:
    """A torch hrnetv2 name -> this build's HRNet-16 path: torch nests
    Sequential(Sequential(conv, bn, relu), ...) where this build has one
    indexed conv/bn dict, and fuse layer (i, j) is the key ``i_j``."""
    for prefix in ("model.", "module.", "backbone."):
        if key.startswith(prefix):
            key = key[len(prefix):]
    m = _HRNET_TRANSITION_CHAIN.match(key)
    if m:
        t, i, k, c, rest = m.groups()
        return f"{t}.mods.{i}.mods.{2 * int(k) + int(c)}.{rest}"
    m = _HRNET_TRANSITION_SIMPLE.match(key)
    if m:
        t, i, c, rest = m.groups()
        return f"{t}.mods.{i}.mods.{c}.{rest}"
    m = _HRNET_FUSE_CHAIN.match(key)
    if m:
        stage, i, j, k, c, rest = m.groups()
        return f"{stage}.fuse_layers.{i}_{j}.mods.{2 * int(k) + int(c)}.{rest}"
    m = _HRNET_FUSE_SIMPLE.match(key)
    if m:
        stage, i, j, c, rest = m.groups()
        return f"{stage}.fuse_layers.{i}_{j}.{c}.{rest}"
    return key


def load_hrnet_torch(module: nn.Module, state_dict: Dict) -> Tuple[int, int]:
    """A torch hrnetv2/LightHRNet state dict into ``HighResolutionNet16``
    (the segmentation heads' entries are dropped); ``(loaded, total)``."""
    translated = {
        _translate_hrnet_key(k): v for k, v in state_dict.items()
        if "num_batches_tracked" not in k
        and not any(p in k for p in ("hrhead", "aux_head", "edge", "ocr"))
    }
    return load_torch_state_dict(module, translated, fuzzy=False)


def load_torch_checkpoint(module: nn.Module, path, fuzzy: bool = True) -> Tuple[int, int]:
    """A ``.pth``/``.pt`` file into ``module``; ``(loaded, total)``."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return load_torch_state_dict(module, state, fuzzy=fuzzy)
