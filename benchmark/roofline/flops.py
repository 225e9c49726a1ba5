"""The operations a step or a request needs: the plain reference run once
on the meta device at the cell's shapes under ``FlopCounterMode`` (matrix
products and convolutions; the reference recomputes nothing)."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.model import Routeformer
from benchmark.reference.train import training_loss


def _meta(shapes: dict) -> dict:
    """{key: (shape, dtype)} -> meta tensors."""
    return {k: torch.empty(shape, dtype=dtype, device="meta") for k, (shape, dtype) in shapes.items()}


def train_step_flops(config: dict, inp: dict, tgt: dict, epoch: int) -> float:
    """Forward (input and target pass) and backward of one training step."""
    with torch.device("meta"):
        model = Routeformer(config)
    model.train()
    for name, p in model.named_parameters():
        p.requires_grad_("video_backbone" not in name)
    with FlopCounterMode(display=False) as counter:
        total = training_loss(model, _meta(inp), _meta(tgt), epoch, config["model"])[0]
        total.backward()
    return float(counter.get_total_flops())


def request_flops(config: dict, request: dict) -> float:
    """The eval forward of one request."""
    with torch.device("meta"):
        model = Routeformer(config)
    model.eval()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(_meta(request), model.draws("meta", False), decisions=False)
    return float(counter.get_total_flops())
