"""The system under test for the Routeformer configurations: the port's
``Routeformer`` built from a configuration file, with the benchmark's
weights, as ``flagship.build_flagship_training`` (a train step: model,
the grouped clipped AdamW, the training loss) or as
``serve.ServingModel`` (the eval forward) assembles it.

Only this module and the cells' loops touch the program.
"""

import os

import torch

from benchmark.weights import make_weights


def _program_config(config: dict):
    from routeformer_torch.models import RouteformerConfig
    from routeformer_torch.models.gps_backbone import GPSBackboneConfig
    from routeformer_torch.models.video_backbone import TimmBackboneConfig

    m, g, v = dict(config["model"]), config["gps_backbone"], config["video_backbone"]
    m["discount_factor"] = {int(k): x for k, x in m["discount_factor"].items()}
    gps = GPSBackboneConfig(**{k: g[k] for k in (
        "seq_len", "label_len", "pred_len", "embed", "freq", "moving_avg", "factor", "distil",
        "dropout", "activation", "individual", "d_model", "n_heads", "e_layers", "d_layers",
        "d_ff")})
    video = TimmBackboneConfig(model_type=v["model_type"], gelu=v["gelu"],
                               compute_dtype=v["compute_dtype"], cache_enabled=False)
    return RouteformerConfig(gps_backbone_config=gps, video_backbone_config=video,
                             with_video=True, with_gaze=True, dense_prediction=True,
                             decoder_mode="smart", **m)


def _model(config: dict, seed: int, device):
    """The port's model on ``device`` with the benchmark's weights."""
    from routeformer_torch.models import Routeformer
    from routeformer_torch.models.gps_backbone import Informer
    from routeformer_torch.models.video_backbone import DinoV2, SwinV2Backbone

    for key, value in config.get("env", {}).items():
        os.environ[key] = value
    video = SwinV2Backbone if config["video_backbone"]["kind"] == "swinv2" else DinoV2
    with torch.device(device):
        model = Routeformer(_program_config(config), gps_backbone=Informer, video_backbone=video)
    model = model.to(device)
    weights = make_weights(config, seed, device)
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise RuntimeError("the program's parameters differ from the reference's: "
                           f"{sorted(set(params) ^ set(weights))[:8]}")
    with torch.no_grad():
        for name, p in params.items():
            if p.shape != weights[name].shape:
                raise RuntimeError(f"{name}: program {tuple(p.shape)}, "
                                   f"reference {tuple(weights[name].shape)}")
            p.copy_(weights[name])
    return model


def build_train(config: dict, seed: int, device):
    """``(model, optimizer, step)``; ``step(input, target, epoch) -> metrics``."""
    from routeformer_torch.optimizers import build_optimizer
    from routeformer_torch.parallel import make_train_step
    from routeformer_torch.train import TrainingLosses, routeformer_training_loss

    model = _model(config, seed, device)
    o = config["optimizer"]
    optimizer = build_optimizer(
        model, learning_rate=o["learning_rate"], weight_decay=o["weight_decay"],
        video_backbone_lr=o["video_backbone_lr"], warmup_epochs=o["warmup_epochs"],
        max_epochs=o["max_epochs"], gradient_clip_val=o["gradient_clip_val"])
    losses = TrainingLosses.from_config(model.configs)

    def loss_fn(m, input_batch, target_batch, epoch):
        return routeformer_training_loss(m, input_batch, target_batch, epoch, losses)

    return model, optimizer, make_train_step(model, optimizer, loss_fn)


def build_serve(config: dict, seed: int, device):
    """``serve.ServingModel``: ``(batch) -> (gps, dense)`` on ``device``."""
    from routeformer_torch.serve import ServingModel

    return ServingModel(_model(config, seed, device), torch.device(device))


def launch_counters() -> dict:
    """The port's launch counters: K1 blocks, K3a and K3b layers, K4 calls."""
    from routeformer_torch.ops import flash_attention, fusion_stack, swin_block_fusion

    return {"K1": swin_block_fusion.launches, "K3a": fusion_stack.launches_fwd,
            "K3b": fusion_stack.launches_bwd, "K4": flash_attention.dense_launches}
