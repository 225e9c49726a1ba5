"""The reference's training step: the future-discounted smooth-l1 loss on
the trajectory and, from epoch 10, on the dense visual features against
the detached target pass; clipping to a global norm; AdamW with its rate
from a linear warmup and cosine annealing, one update per epoch, the
video backbone in a group of its own. Float32 throughout.

``ReferenceTrainer.step`` seeds torch's generators as the benchmark seeded
them before the program's step of the same index, so that the forward
draws what the program's drew (``model.Draws``).
"""

import numpy as np
import torch

from benchmark.reference.model import Routeformer, float32_matmuls

BETAS, EPS = (0.9, 0.999), 1e-8


def discount(schedule: dict, epoch: int) -> float:
    """The schedule's value at the largest key not above ``epoch``."""
    keys = sorted(int(k) for k in schedule)
    gamma = schedule[str(keys[0])]
    for k in keys:
        if epoch >= k:
            gamma = schedule[str(k)]
    return float(np.float32(gamma))


def discounted_smooth_l1(pred, true, gamma: float):
    """mean over (B, T, C) of smooth-l1 (beta 1) weighted by gamma^t."""
    t = torch.arange(pred.shape[1], dtype=torch.float32, device=pred.device)
    factors = torch.pow(torch.tensor(gamma, dtype=torch.float32, device=pred.device), t)
    diff = (pred - true).abs()
    loss = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
    return (loss * factors.reshape(1, -1, 1)).mean()


def learning_rate(base: float, warmup: int, max_epochs: int, step: int) -> float:
    """Linear warmup from 0 (reaching ``base`` one epoch before warmup ends)
    then cosine annealing to 0, in float32."""
    f = np.float32
    epoch = f(step)
    if epoch < warmup:
        return float(epoch * f(base) / f(max(1, warmup - 1)))
    progress = (epoch - f(warmup)) / f(max(1, max_epochs - warmup))
    return float(f(0.5) * f(base) * (f(1.0) + np.cos(f(np.pi) * progress)))


def training_loss(model: Routeformer, inp: dict, tgt: dict, epoch: int, cfg: dict,
                  rows=None):
    """(total loss, trajectory loss, outputs): the input pass with view and
    gaze dropout, the target pass without them (its layers still drop
    out); the outputs are the future GPS, the predicted and the target
    visual features, over every row.
    ``rows`` takes both losses over that many first rows alone, the
    forward run on all of them (a fault)."""
    device = inp["gps"].device
    future_gps, future_visual = model(inp, model.draws(device, True), decisions=True)
    with torch.no_grad():
        _, target_visual = model.preprocess(tgt, model.draws(device, True), decisions=False)
    target_visual = target_visual[:, :future_visual.shape[1]]
    outputs = (future_gps, future_visual, target_visual)
    target_gps = tgt["gps"].float()
    if rows is not None:
        future_gps, future_visual = future_gps[:rows], future_visual[:rows]
        target_gps, target_visual = target_gps[:rows], target_visual[:rows]
    total, traj = loss_of(future_gps, future_visual, target_gps, target_visual, epoch, cfg)
    return total, traj, outputs


def loss_of(future_gps, future_visual, target_gps, target_visual, epoch: int, cfg: dict):
    """(total loss, trajectory loss) of a forward's outputs against the
    targets, each (B, pred_len, C)."""
    gamma = discount(cfg["discount_factor"], epoch)
    traj = discounted_smooth_l1(future_gps.float(), target_gps.float(), gamma)
    dense = discounted_smooth_l1(future_visual.float(), target_visual.float(), gamma)
    weight = cfg["dense_loss_ratio"] * traj.detach() / torch.clamp(dense.detach(), min=1e-6)
    if epoch < 10:
        weight = torch.zeros_like(weight)
    return traj + weight * dense, traj


class ReferenceTrainer:
    """The reference model and its optimizer state. ``count`` is the
    number of updates so far, as the program's optimizer counts them."""

    def __init__(self, config: dict, weights: dict, device, precision: str = "f32",
                 count: int = 0):
        float32_matmuls()
        self.config, self.cfg, self.opt = config, config["model"], config["optimizer"]
        self.model = Routeformer(config, precision).to(device)
        self.model.load_state_dict(weights, strict=False)
        self.model.train()
        for name, p in self.model.named_parameters():
            p.requires_grad_("video_backbone" not in name)  # frozen, as the program's
        self.state = {n: (torch.zeros_like(p), torch.zeros_like(p))
                      for n, p in self.model.named_parameters()}
        self.count, self.t = count, 0

    def step(self, inp: dict, tgt: dict, epoch: int, generator_seed: int,
             loss_rows=None) -> dict:
        """One step; returns the total loss, the global gradient norm before
        clipping, the clipped gradient of every parameter (the frozen ones'
        zero) and the forward's outputs (``training_loss``). ``loss_rows``:
        as ``training_loss``'s ``rows``."""
        torch.manual_seed(generator_seed)
        total, _, outputs = training_loss(self.model, inp, tgt, epoch, self.cfg, loss_rows)
        params = dict(self.model.named_parameters())
        trained = [n for n, p in params.items() if p.requires_grad]
        grads = torch.autograd.grad(total, [params[n] for n in trained], allow_unused=True)
        grad_of = {n: g for n, g in zip(trained, grads) if g is not None}
        grads = {n: grad_of.get(n, torch.zeros_like(p)) for n, p in params.items()}
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads.values()]))
        clip = self.opt["gradient_clip_val"]
        scale = 1.0 if norm < clip else clip / norm
        grads = {n: g * scale for n, g in grads.items()}
        self.t += 1
        o = self.opt
        rates = {group: learning_rate(base, o["warmup_epochs"], o["max_epochs"], self.count)
                 for group, base in (("default", o["learning_rate"]),
                                     ("video_backbone", o["video_backbone_lr"]))}
        b1, b2 = BETAS
        with torch.no_grad():
            for n, p in params.items():
                lr = rates["video_backbone" if "video_backbone" in n else "default"]
                m, v = self.state[n]
                p.mul_(1.0 - lr * o["weight_decay"])
                m.lerp_(grads[n], 1.0 - b1)
                v.mul_(b2).addcmul_(grads[n], grads[n], value=1.0 - b2)
                denom = v.sqrt() / np.sqrt(1.0 - b2 ** self.t) + EPS
                p.addcdiv_(m, denom, value=-lr / (1.0 - b1 ** self.t))
        self.count += 1
        return {"total_loss": float(total.detach()), "grad_norm": float(norm), "grads": grads,
                "outputs": [t.detach() for t in outputs]}
