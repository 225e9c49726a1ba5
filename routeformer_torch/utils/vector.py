"""2-D trajectory vector utilities (counterpart of
``routeformer_tpu/utils/vector.py``): float32 compute, original dtype out."""

import torch


def rotate(tensor: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotate ``(B, L, 2)`` vectors by per-batch angles ``(B, 1)`` or ``(B,)``."""
    t = tensor.float()
    a = angle.float().reshape(t.shape[0])
    cos, sin = torch.cos(a), torch.sin(a)
    rot = torch.stack(
        [torch.stack([cos, -sin], -1), torch.stack([sin, cos], -1)], dim=-2
    )  # (B, 2, 2)
    return torch.einsum("bij,blj->bli", rot, t).to(tensor.dtype)


def estimate_angle(tensor: torch.Tensor) -> torch.Tensor:
    """Angle (radians) of ``(*, 2)`` vectors, ``(*, 1)`` f32."""
    t = tensor.float()
    return torch.atan2(t[..., 1], t[..., 0])[..., None]


def estimate_angle_and_norm(tensor: torch.Tensor):
    """Angle (radians) and L2 norm of ``(*, 2)`` vectors, each ``(*, 1)`` f32."""
    t = tensor.float()
    angle = torch.atan2(t[..., 1], t[..., 0])
    norm = torch.linalg.vector_norm(t, dim=-1)
    return angle[..., None], norm[..., None]
