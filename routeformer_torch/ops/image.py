"""Frame conversion and conditioning (counterpart of
``routeformer_tpu/ops/image.py`` ``to_float16`` and ``dequantize_videos``,
and of the backbones' shared input conditioning: pad to square, resize to
the native size, normalise)."""

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def to_float16(frames: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float16 [0, 1]: divide in f32, round once.

    Bit-exact with the JAX package for all 256 values.
    """
    return (frames.float() / 255.0).to(torch.float16)


def dequantize_videos(batch: dict) -> dict:
    """uint8 ``*video*`` entries -> float16 [0, 1]; everything else as is."""
    return {
        k: (
            dequantize_videos(v)
            if isinstance(v, dict)
            else to_float16(v)
            if "video" in k and getattr(v, "dtype", None) == torch.uint8
            else v
        )
        for k, v in batch.items()
    }


def resize_bilinear(images: torch.Tensor, size: int) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")`` on (N, H, W, C): half-pixel
    centres, antialiased when downsampling; computed in f32."""
    x = images.float().permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1).to(images.dtype)


def condition_frames(images: torch.Tensor, size: int, mean=IMAGENET_MEAN,
                     std=IMAGENET_STD, pad_to_square: bool = True) -> torch.Tensor:
    """The video backbones' input conditioning on (N, H, W, C) frames, as
    both JAX backbones do it: uint8 -> f16, pad to square (bottom/right),
    bilinear resize to ``size``, normalise in the frames' dtype."""
    if images.dtype == torch.uint8:
        images = to_float16(images)
    n, h, w, c = images.shape
    if pad_to_square and h != w:
        side = max(h, w)
        images = F.pad(images, (0, 0, 0, side - w, 0, side - h))
    if images.shape[1] != size or images.shape[2] != size:
        images = resize_bilinear(images, size)
    mean = torch.tensor(mean, dtype=images.dtype, device=images.device)
    std = torch.tensor(std, dtype=images.dtype, device=images.device)
    return (images - mean) / std
