"""Seeded weights, made by the benchmark on the device and handed by name to
the program and to the reference alike.

The names and shapes are those of the reference model built on the meta
device. The values are drawn in one call on the device's generator and
cut into leaves: matrices and kernels normal(0, 1/fan_in), the view
embeddings normal(0, 1), the ViT's position embedding normal(0, 0.02),
SwinV2's logit scales log(10), LayerNorm and BatchNorm scales 1, every
other vector 0.
"""

import math

import torch

from benchmark.reference.model import Routeformer


def shapes(config: dict) -> dict:
    """{name: shape} of every parameter."""
    with torch.device("meta"):
        model = Routeformer(config)
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def make_weights(config: dict, seed: int, device) -> dict:
    """{name: float32 tensor on ``device``}."""
    table = shapes(config)
    drawn = [n for n, s in table.items() if len(s) >= 2]
    total = sum(math.prod(table[n]) for n in drawn)
    gen = torch.Generator(device=device).manual_seed(seed)
    noise = torch.randn(total, generator=gen, device=device)
    out, offset = {}, 0
    for name, shape in table.items():
        leaf = name.rsplit(".", 1)[-1]
        if name in drawn:
            size = math.prod(shape)
            value = noise[offset:offset + size].view(shape)
            offset += size
            if name.endswith("_embedding") and shape[:2] == (1, 1):
                out[name] = value
            elif leaf == "pos_embed":
                out[name] = 0.02 * value
            elif leaf == "logit_scale":
                out[name] = torch.full(shape, math.log(10.0), device=device)
            else:
                out[name] = value / math.sqrt(math.prod(shape[1:]))
        elif leaf == "weight" and ("norm" in name):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
