"""Photometric train-time augment of the video backbones (counterpart of
``routeformer_tpu/ops/augment.py``), applied to [0, 1] frames when the
backbone trains (``train_backbone`` and training mode):
RandomAdjustSharpness(2, p=0.5) -> RandomAutocontrast(p=0.5) ->
ColorJitter(brightness=0.2, contrast=0.2, saturation=0.2, hue=0.1, its four
ops in a random order) -> RandomErasing(p=1, scale=(0.02, 0.2),
ratio=(0.3, 3.3), value=0), each op the torchvision float formula (blend
and clamp, ITU-R 601 grayscale, log-uniform erase aspect).

As in the JAX package, every draw is per frame, and the erased rectangle
is clamped into the frame instead of torchvision's retry loop. The work is
split in two: ``draw_augment`` makes every frame's random decisions (from
an explicit generator, the device's default one when None), and
``apply_augment`` applies them to the whole batch at once (each op on
every frame, kept where the frame's draw says so). The ops compute in f32
and the result returns in the frames' dtype.
"""

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_SHARPEN = torch.tensor([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]]) / 13.0


def rgb_to_grayscale(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 1), ITU-R 601 weights."""
    return (0.2989 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])[..., None]


def rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    safe_delta = torch.where(delta == 0, torch.ones_like(delta), delta)
    s = torch.where(maxc == 0, torch.zeros_like(maxc),
                    delta / torch.where(maxc == 0, torch.ones_like(maxc), maxc))
    rc, gc, bc = (maxc - r) / safe_delta, (maxc - g) / safe_delta, (maxc - b) / safe_delta
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta == 0, torch.zeros_like(h), h)
    return torch.stack([(h / 6.0) % 1.0, s, maxc], dim=-1)


def hsv_to_rgb(img: torch.Tensor) -> torch.Tensor:
    h, s, v = img[..., 0], img[..., 1], img[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))
    i = i.to(torch.int32) % 6
    table = torch.stack([torch.stack(c, dim=-1) for c in
                         ((v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q))])
    return torch.gather(table, 0, i.long()[None, ..., None].expand(1, *i.shape, 3))[0]


def _per_frame(x: torch.Tensor, ndim: int = 4) -> torch.Tensor:
    """(N,) factors broadcast over (N, H, W, C)."""
    return x.reshape(-1, *([1] * (ndim - 1)))


def _blend(img1, img2, ratio):
    return torch.clamp(ratio * img1 + (1.0 - ratio) * img2, 0.0, 1.0)


def adjust_brightness(img: torch.Tensor, factor) -> torch.Tensor:
    return _blend(img, torch.zeros_like(img), factor)


def adjust_contrast(img: torch.Tensor, factor) -> torch.Tensor:
    mean = rgb_to_grayscale(img).mean(dim=(-3, -2, -1), keepdim=True)
    return _blend(img, mean.expand_as(img), factor)


def adjust_saturation(img: torch.Tensor, factor) -> torch.Tensor:
    return _blend(img, rgb_to_grayscale(img).expand_as(img), factor)


def adjust_hue(img: torch.Tensor, shift) -> torch.Tensor:
    """``shift``: a number, or a tensor that broadcasts over (..., H, W)."""
    hsv = rgb_to_hsv(img)
    return hsv_to_rgb(torch.stack([(hsv[..., 0] + shift) % 1.0, hsv[..., 1], hsv[..., 2]],
                                  dim=-1))


def adjust_sharpness(img: torch.Tensor, factor) -> torch.Tensor:
    """(N, H, W, C): torchvision's [[1,1,1],[1,5,1],[1,1,1]]/13 blur, the
    border rows and columns keeping the original pixels."""
    n, h, w, c = img.shape
    x = img.permute(0, 3, 1, 2)
    kernel = _SHARPEN.to(img.device, img.dtype).expand(c, 1, 3, 3)
    blurred = F.conv2d(F.pad(x, (1, 1, 1, 1), mode="replicate"), kernel, groups=c)
    blurred = blurred.permute(0, 2, 3, 1)
    rows = torch.arange(h, device=img.device)[:, None, None]
    cols = torch.arange(w, device=img.device)[None, :, None]
    interior = (rows > 0) & (rows < h - 1) & (cols > 0) & (cols < w - 1)
    degenerate = torch.where(interior, torch.clamp(blurred, 0.0, 1.0), img)
    return _blend(img, degenerate, factor)


def autocontrast(img: torch.Tensor) -> torch.Tensor:
    minimum = img.amin(dim=(-3, -2), keepdim=True)
    maximum = img.amax(dim=(-3, -2), keepdim=True)
    same = maximum == minimum
    scale = torch.where(same, torch.ones_like(maximum), 1.0 / (maximum - minimum))
    offset = torch.where(same, torch.zeros_like(minimum), minimum)
    return torch.clamp((img - offset) * scale, 0.0, 1.0)


def draw_augment(n: int, h: int, w: int, generator: Optional[torch.Generator] = None,
                 device=None, sharpness_p: float = 0.5, autocontrast_p: float = 0.5,
                 brightness: float = 0.2, contrast: float = 0.2, saturation: float = 0.2,
                 hue: float = 0.1, erase_scale: Tuple[float, float] = (0.02, 0.2),
                 erase_ratio: Tuple[float, float] = (0.3, 3.3)) -> dict:
    """Every frame's draws for ``apply_augment``: the two coin flips, the
    four jitter factors and their order, the erased rectangle."""
    if generator is not None:
        device = generator.device

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=generator, device=device)

    eh, ew = _erase_size(h, w, uniform, erase_scale, erase_ratio)
    draws = {
        "sharp": uniform(0.0, 1.0) < sharpness_p,
        "auto": uniform(0.0, 1.0) < autocontrast_p,
        "brightness": uniform(max(0.0, 1.0 - brightness), 1.0 + brightness),
        "contrast": uniform(max(0.0, 1.0 - contrast), 1.0 + contrast),
        "saturation": uniform(max(0.0, 1.0 - saturation), 1.0 + saturation),
        "hue": uniform(-hue, hue),
        "order": torch.argsort(torch.rand(n, 4, generator=generator, device=device), dim=1),
        "erase_h": eh, "erase_w": ew,
    }
    draws["erase_top"], draws["erase_left"] = _erase_corner(h, w, eh, ew, generator, device)
    return draws


def _erase_size(h: int, w: int, uniform, scale, ratio):
    """The erased rectangle's height and width per frame (torchvision's
    sampling, clamped rather than retried)."""
    area = h * w * uniform(*scale)
    aspect = torch.exp(uniform(math.log(ratio[0]), math.log(ratio[1])))
    eh = torch.clamp(torch.round(torch.sqrt(area * aspect)), 1, h).long()
    ew = torch.clamp(torch.round(torch.sqrt(area / aspect)), 1, w).long()
    return eh, ew


def _erase_corner(h: int, w: int, eh, ew, generator, device):
    """Its top-left corner, moved in so the rectangle fits."""
    n = eh.shape[0]
    top = torch.randint(0, h, (n,), generator=generator, device=device)
    left = torch.randint(0, w, (n,), generator=generator, device=device)
    return torch.minimum(top, h - eh), torch.minimum(left, w - ew)


def erase_rectangle(img: torch.Tensor, draws: dict, value: float = 0.0) -> torch.Tensor:
    """(N, H, W, C) frames with each frame's rectangle of ``draws``
    (``erase_top``, ``erase_left``, ``erase_h``, ``erase_w``) set to
    ``value``."""
    _, h, w, _ = img.shape
    pf = _per_frame
    rows = torch.arange(h, device=img.device)[None, :, None, None]
    cols = torch.arange(w, device=img.device)[None, None, :, None]
    top, left = pf(draws["erase_top"]), pf(draws["erase_left"])
    inside = ((rows >= top) & (rows < top + pf(draws["erase_h"]))
              & (cols >= left) & (cols < left + pf(draws["erase_w"])))
    return torch.where(inside, torch.full_like(img, value), img)


def random_erase(img: torch.Tensor, generator: Optional[torch.Generator] = None,
                 scale: Tuple[float, float] = (0.02, 0.2),
                 ratio: Tuple[float, float] = (0.3, 3.3), value: float = 0.0) -> torch.Tensor:
    """Set a random rectangle of an (H, W, C) image, or of each frame of
    (N, H, W, C) frames, to ``value`` (the counterpart of the JAX
    package's ``random_erase``, its key replaced by ``generator``; the
    draws are ``draw_augment``'s)."""
    frames = img if img.dim() == 4 else img[None]
    n, h, w, _ = frames.shape
    device = frames.device if generator is None else generator.device

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=generator, device=device)

    eh, ew = _erase_size(h, w, uniform, scale, ratio)
    top, left = _erase_corner(h, w, eh, ew, generator, device)
    out = erase_rectangle(frames, {"erase_top": top, "erase_left": left,
                                   "erase_h": eh, "erase_w": ew}, value)
    return out if img.dim() == 4 else out[0]


def apply_augment(images: torch.Tensor, draws: dict) -> torch.Tensor:
    """Apply ``draws`` to (N, H, W, 3) frames in [0, 1]."""
    img = images.float()
    pf = _per_frame
    img = torch.where(pf(draws["sharp"]), adjust_sharpness(img, 2.0), img)
    img = torch.where(pf(draws["auto"]), autocontrast(img), img)
    jitter = (lambda x: adjust_brightness(x, pf(draws["brightness"])),
              lambda x: adjust_contrast(x, pf(draws["contrast"])),
              lambda x: adjust_saturation(x, pf(draws["saturation"])),
              lambda x: adjust_hue(x, pf(draws["hue"], 3)))
    order = draws["order"]
    for step in range(4):
        for op_index, op in enumerate(jitter):
            img = torch.where(pf(order[:, step] == op_index), op(img), img)
    return erase_rectangle(img, draws).to(images.dtype)


def photometric_augment(images: torch.Tensor, generator: Optional[torch.Generator] = None,
                        **kwargs) -> torch.Tensor:
    """The train-time pipeline on (N, H, W, 3) frames in [0, 1]."""
    n, h, w, _ = images.shape
    return apply_augment(images, draw_augment(n, h, w, generator, images.device, **kwargs))
