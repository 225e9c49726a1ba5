"""Frame dtype conversion (counterpart of ``routeformer_tpu/ops/image.py``
``to_float16`` and ``dequantize_videos``)."""

import torch


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
