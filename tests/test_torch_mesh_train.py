"""The ``(data, model)`` mesh on 4 gloo CPU ranks against one process and
the JAX trainer.

One launch of 4 ranks (``parallel.dryrun.launch``, a module fixture) runs
every rank-side check once: the lockstep trainer over the small
Routeformer of ``test_torch_trainer.py`` (exhaustive ProbSparse, dropout 0,
no motion noise) and ``stationary_baseline``, from the same weights, two
steps at batch 4 on each mesh: (data, model) = (4, 1), (2, 2) and (2, 2)
with FSDP (``min_shard_dim=32``, so the Routeformer's matrices shard);
the MC eval before and after the FSDP mesh's steps (the second after an
optimizer step, so a stale derived weight would show); PatchTST's
BatchNorm at ``data=2``; a snapshot under FSDP restored on a fresh mesh;
the mesh loader's order, rows and frame store; the mesh memo; at (4, 1),
Autoformer's training-mode delays and InverseForm's train-mode BatchNorm
(each rank's rows against the one process's global batch); at (2, 2) with
FSDP and at (1, 4), the per-unit gathers: the gradients against a gather
of the whole model (the Routeformer, and a small SwinV2 trained under
remat), and the gathered bytes a rank holds at once; and the split layers
(the ``model`` axis computing tensor-parallel): each rank's FLOPs in them
against its one-process twin's on the same rows, the weights they never
gather whole, a small exact-gelu SwinV2 and an Informer with its distil
convolution against one process (features and gradients), and at (1, 4)
the Informer with dropout 0.1 from the same generator state; the
Autoformer, FEDformer Fourier and FEDformer Wavelets GPS backbones at tiny
widths, their layers split (dropout 0 and 0.1): against one process, each
split layer's FLOPs, no split weight gathered over ``model``, the
gradients still whole over ``data`` held at once under FSDP. On every
mesh of ``MESHES``, the data reductions launched during the backward
against the post-backward reduction; at (2, 2) with FSDP, the split
FEDformer Fourier backbone against ``jax.grad`` of the JAX model. While
the ranks run, the parent computes the references: the port's trainer in
one process on the global batch, the JAX trainer on the conftest's
virtual mesh at (2, 2) with FSDP (one JAX mesh: its compile takes a
minute; JAX's own tests hold its meshes to its one device), and the JAX
FEDformer's gradients.

Tolerances: losses, grad norms and eval metrics 1e-5 relative (f32; the
ranks' sums only reorder the one process's); split layers' features and
gradients 1e-5 relative to the largest (a row split sums partial
products in another order); parameters by
``test_torch_trainer``'s rule (1e-3 lr where the gradient is firm, else
2 lr: AdamW moves a gradient that is 0 up to rounding by lr times its
sign)."""

import contextlib
import functools
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

N = 4
MESHES = {"dp": ((4, 1), False), "dp_tp": ((2, 2), False), "fsdp": ((2, 2), True)}
UNIT_MESHES = {"fsdp": ((2, 2), True), "tp": ((1, 4), False)}
EPOCHS = (3, 12)
MIN_SHARD = 32
WINDOW, POOL, LOADER_B = 4, 12, 8


# ---------------------------------------------------------- rank side -- #


class Windows:
    """Overlapping uint8 windows of a small frame pool and a float64 leaf."""

    def __init__(self, n=40):
        self.n = n
        self.pool = np.random.default_rng(0).integers(0, 255, (POOL, 6, 8, 3), dtype=np.uint8)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"left_video": self.pool[(i + np.arange(WINDOW)) % POOL],
                "gps": np.full((3, 2), float(i))}


def _models(arg, seed_noise=None):
    from routeformer_torch.convert import load_flax_params
    from routeformer_torch.models import Routeformer, RouteformerConfig
    from routeformer_torch.models.gps_backbone import GPSBackboneConfig, StationaryBaseline
    from routeformer_torch.models.layers import ProbAttention
    from routeformer_torch.models.video_backbone import TimmBackboneConfig

    gps, video, top = arg["kwargs"]
    model = Routeformer(RouteformerConfig(gps_backbone_config=GPSBackboneConfig(**gps),
                                          video_backbone_config=TimmBackboneConfig(**video),
                                          **top))
    for m in model.modules():
        if isinstance(m, ProbAttention):
            m.factor = arg["exhaustive"]
    load_flax_params(model, arg["flat"])
    if seed_noise is not None:  # other weights, for a restore to overwrite
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.01)
    baseline = Routeformer(
        RouteformerConfig(gps_backbone_config=GPSBackboneConfig(**gps),
                          discount_factor=top["discount_factor"], epsilon=1.0),
        gps_backbone=StationaryBaseline)
    return {"routeformer": model, "stationary_baseline": baseline}


def _trainer(models, arg, mesh=None, fsdp=False):
    from routeformer_torch.optimizers import build_optimizer
    from routeformer_torch.train import ParallelTrainer

    return ParallelTrainer(models, lambda m: build_optimizer(m, **arg["opt"]),
                           models["routeformer"].configs, device="cpu", unfreeze_epoch=None,
                           mesh=mesh, fsdp=fsdp, min_shard_dim=MIN_SHARD)


def _floats(metrics):
    return {k: float(v) for k, v in metrics.items()}


def _steps(trainer, arg, after_first=None):
    steps = []
    for i, (epoch, batch) in enumerate(zip(EPOCHS, arg["train"])):
        trainer.epoch = epoch
        steps.append(dict(_floats(trainer.training_step(batch)),
                          grad_norm=float(trainer.grad_norm)))
        if i == 0 and after_first is not None:
            after_first()
    return steps


def _params(trainer, name="routeformer"):
    from routeformer_torch.train.checkpoints import model_state

    state = model_state(trainer, name)
    return {k: state[k].numpy() for k, _ in trainer.models[name].named_parameters()}


def _patchtst(arg):
    from routeformer_torch.flagship import init_weights
    from routeformer_torch.models import Routeformer, RouteformerConfig
    from routeformer_torch.models.gps_backbone import PatchTST, PatchTSTBackboneConfig

    gps, _, top = arg["kwargs"]
    cfg = RouteformerConfig(gps_backbone_config=PatchTSTBackboneConfig(**gps, fc_dropout=0.0),
                            decoder_mode="smart", discount_factor=top["discount_factor"],
                            epsilon=1.0)
    model = Routeformer(cfg, gps_backbone=PatchTST)
    init_weights(model, seed=5)
    return {"routeformer": model}


def _patchtst_step(trainer, batch):
    trainer.epoch = EPOCHS[0]
    loss = float(trainer.training_step(batch)["train_total_loss"])
    stats = {k: v.numpy().copy() for k, v in trainer.models["routeformer"].state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return {"loss": loss, "stats": stats, "params": _params(trainer)}


ZOO_ROWS = 8


def _zoo_run(arg, rows=slice(None), group=None):
    """Train-mode forwards of a small Autoformer (its delays are the batch
    mean's) and InverseForm (BatchNorm's batch statistics) on ``rows`` of
    the global batch, the data shards' ``group`` set on the modules that
    take one; their outputs and InverseForm's running statistics."""
    from routeformer_torch.models.gps_backbone import Autoformer, GPSBackboneConfig
    from routeformer_torch.models.video_backbone import InverseForm, InverseFormBackboneConfig

    torch.manual_seed(11)
    auto = Autoformer(GPSBackboneConfig(seq_len=20, label_len=20, pred_len=10, d_model=32,
                                        n_heads=4, e_layers=2, d_layers=1, d_ff=64,
                                        dropout=0.0, factor=2, moving_avg=5, _enc_in=7,
                                        _c_out=3)).train()
    inv = InverseForm(InverseFormBackboneConfig()).train()
    for m in (*auto.modules(), *inv.modules()):
        if hasattr(m, "data_group"):
            m.data_group = group
    with torch.no_grad():
        out = {"auto": auto(torch.from_numpy(arg["zoo"]["series"][rows])).numpy(),
               "inv": inv(torch.from_numpy(arg["zoo"]["frames"][rows])).numpy()}
    out["stats"] = {k: v.numpy().copy() for k, v in inv.state_dict().items()
                    if k.endswith(("running_mean", "running_var"))}
    return out


def _whole_gather_grads(layout, model, closure):
    """The sharded parameters' gradients as a gather of the whole model
    gives them: every sharded weight gathered whole before ``closure`` (the
    forward and backward) runs, each whole gradient averaged over the data
    shards, then cut to this rank's block."""
    import torch.distributed as dist

    from routeformer_torch.parallel.mesh import DATA_AXIS, spec_block, spec_gather

    with torch.no_grad():
        fulls = {p: spec_gather(p.detach(), spec, layout.mesh).requires_grad_(p.requires_grad)
                 for p, spec in layout.sharded.items()}
    owners = [(m, k, p) for m in model.modules() for k, p in m._parameters.items()
              if p is not None and p in layout.sharded]
    for m, k, p in owners:
        m._parameters[k] = fulls[p]
    try:
        closure()
    finally:
        for m, k, p in owners:
            m._parameters[k] = p
    out = {}
    for name, p in model.named_parameters():
        g = fulls[p].grad if p in fulls else None
        if g is None:
            continue
        if layout.n_data > 1:
            dist.all_reduce(g, group=layout.mesh.get_group(DATA_AXIS))
            g = g / layout.n_data
        out[name] = spec_block(g, layout.sharded[p], layout.mesh).clone()
    return out


def _unit_grads(layout, model, closure):
    """The sharded parameters' gradients from the per-unit gathers."""
    for p in model.parameters():
        p.grad = None
    with layout.gathered():
        closure()
        layout.reduce_grads()
    return {name: p.grad.clone() for name, p in model.named_parameters()
            if p in layout.sharded and p.grad is not None}


def _same(got, want):
    return sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)


def _rel(got, want) -> float:
    """Max absolute difference over the max of ``want``."""
    return float((got - want).abs().max()) / float(want.abs().max())


def _errs(got, want):
    """Each gradient's max absolute difference over the largest gradient
    (a gradient that is 0 up to rounding, a key bias's, has no scale of its
    own), or None where the keys differ."""
    if sorted(got) != sorted(want):
        return None
    scale = max(float(w.abs().max()) for w in want.values())
    return {k: float((got[k] - want[k]).abs().max()) / scale for k in want}


def _probe_loss(out):
    """``out`` against a fixed random probe. (Not ``out.square().sum()``:
    through SwinV2's final LayerNorm at weight 1 and bias 0 its gradient
    cancels to rounding noise, which no reordered sum holds.)"""
    return (out * torch.randn(out.shape, generator=torch.Generator().manual_seed(5))).sum()


def _layer_flops(model, names, fn) -> dict:
    """The matmul and convolution FLOPs that ``fn`` spends in the forward
    calls of each layer of ``model`` named in ``names``
    (``layout.counting_flops``)."""
    from routeformer_torch.parallel.layout import counting_flops

    with counting_flops(model, names) as counts:
        fn()
    return counts


def _split_vs_one(make, x, mesh, min_shard, fsdp, flops=False):
    """A module laid out on ``mesh`` (its split layers computing on their
    blocks) against its one-process twin, both from ``make()`` and run on
    the same input from the same generator state: the output's ``_rel``
    and each parameter's gradient's error over the twin's largest gradient
    (a sharded gradient against the twin's cut to this rank's block), the
    split layers by kind, the split weights and the sharded ones gathered
    over ``model`` through the step, the data-whole gradients' high-water
    beside the largest unit's; with ``flops``, each split layer's forward
    FLOPs on both sides (no grad)."""
    from routeformer_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, MeshParams, spec_block

    one, split = make(), make()
    layout = MeshParams(split, mesh, min_shard, fsdp)
    rng = torch.get_rng_state()
    gathered_over_model = set()
    gather = layout._gather

    def watched(p, *a, axes=(DATA_AXIS, MODEL_AXIS), **k):
        if MODEL_AXIS in axes and MODEL_AXIS in layout.sharded[p]:
            gathered_over_model.add(layout._names[p])
        return gather(p, *a, axes=axes, **k)

    def run(m):
        torch.set_rng_state(rng)
        out = m(x)
        _probe_loss(out).backward()
        return out.detach()

    want = run(one)
    layout._gather = watched
    with layout.gathered():
        got = run(split)
        launched = layout.launched_in_backward
        layout.reduce_grads()
    del layout._gather
    errs = {"out": _rel(got, want)}
    scale = max(float(q.grad.abs().max()) for q in one.parameters() if q.grad is not None)
    for (n, p), q in zip(split.named_parameters(), one.parameters()):
        if q.grad is not None:
            g = spec_block(q.grad, layout.sharded[p], mesh) if p in layout.sharded else q.grad
            errs[n] = float((p.grad - g).abs().max()) / scale
    kinds = sorted({(type(layer).__name__, sp.kind, sp.keep) for layer, sp in layout.splits.items()})
    rec = {"errs": errs, "kinds": kinds, "launched_in_backward": launched,
           "split_params": sorted(layout._names[p] for p in layout.split_params),
           "gathered_over_model": sorted(gathered_over_model),
           "grad_high_water": layout.grad_high_water,
           "largest_unit_grad": max(layout.unit_grad_bytes.values(), default=0)}
    if flops:
        names = {n for n, m in split.named_modules() if m in layout.splits}

        def forward(m):
            def go():
                torch.set_rng_state(rng)
                m(x)
            return go

        with torch.no_grad():
            rec["flops"] = _layer_flops(one, names, forward(one))
            with layout.gathered():
                rec["split_flops"] = _layer_flops(split, names, forward(split))
    return rec


def _split_informer(dropout):
    from routeformer_torch.models.gps_backbone import GPSBackboneConfig, Informer

    def make():
        torch.manual_seed(8)
        return Informer(GPSBackboneConfig(
            seq_len=8, label_len=8, pred_len=6, d_model=32, n_heads=4, e_layers=2, d_layers=1,
            d_ff=64, factor=1000, dropout=dropout, activation="gelu", distil=True, _enc_in=7,
            _c_out=3)).train()

    return make


# The GPS backbones whose layers split since the Autoformer layers left the
# whole-weight units: tiny widths (the square projections row-split, ff1
# column-split and kept into ff2, the decoder's trend convolution row-split;
# the FEDformer Wavelets blocks' Lk0/Lq/Lk/Lv column-split, Lk1/out and
# SparseKernelFT1d's spectral weights row-split).
ZOO_GPS = dict(seq_len=16, label_len=16, pred_len=8, d_model=MIN_SHARD, n_heads=4, e_layers=2,
               d_layers=1, d_ff=2 * MIN_SHARD, factor=2, moving_avg=5, activation="gelu",
               _enc_in=7, _c_out=3)
ZOO_SPLIT = ("autoformer", "fedformer_fourier", "fedformer_wavelets")
ZOO_DROPOUTS = (0.0, 0.1)


@contextlib.contextmanager
def _small_wavelets():
    """FEDformer's multiwavelet blocks at test widths: the transform's c 16,
    k 4, alpha 4 (c k = 64) and the cross block's c 8, k 8 (the model's own
    are c 128 and c 64 at k 8 whatever d_model is: ~200M spectral
    weights)."""
    from routeformer_torch.models.gps_backbone import fedformer as fed

    saved = fed.MultiWaveletTransform, fed.MultiWaveletCross
    fed.MultiWaveletTransform = functools.partial(saved[0], k=4, c=16, alpha=4)
    fed.MultiWaveletCross = functools.partial(saved[1], c=8, k=8)
    try:
        yield
    finally:
        fed.MultiWaveletTransform, fed.MultiWaveletCross = saved


def _zoo_model(name, dropout):
    from routeformer_torch.models.gps_backbone import (
        Autoformer,
        FEDformer,
        FEDFormerBackboneConfig,
        GPSBackboneConfig,
    )

    def make():
        torch.manual_seed(12)
        if name == "autoformer":
            return Autoformer(GPSBackboneConfig(**ZOO_GPS, dropout=dropout)).train()
        version = "Fourier" if name == "fedformer_fourier" else "Wavelets"
        cfg = FEDFormerBackboneConfig(**ZOO_GPS, dropout=dropout, modes=4, version=version)
        with _small_wavelets():
            return FEDformer(cfg, mode_rng=np.random.RandomState(7)).train()

    return make


def _zoo_split_checks(mesh, fsdp):
    """Each of ``ZOO_SPLIT`` against one process with dropout 0 (and its
    FLOPs) and 0.1, on a batch of 3 series."""
    series = torch.randn(3, ZOO_GPS["seq_len"], ZOO_GPS["_enc_in"],
                         generator=torch.Generator().manual_seed(13))
    return {(name, p): _split_vs_one(_zoo_model(name, p), series, mesh, MIN_SHARD, fsdp,
                                     flops=p == 0.0)
            for name in ZOO_SPLIT for p in ZOO_DROPOUTS}


def _split_swin():
    from routeformer_torch.models.video_backbone import SwinV2Backbone, TimmBackboneConfig

    torch.manual_seed(9)
    swin = SwinV2Backbone(TimmBackboneConfig(model_type="swinv2_tiny_test",
                                             compute_dtype="float32", gelu="exact",
                                             train_backbone=True)).eval()
    return swin


def _split_checks(mesh, fsdp):
    """A small exact-gelu SwinV2 (the unfused block: qkv gathered before
    K2's plain version) at ``min_shard_dim`` 16 and the Informer with its
    distil convolution at 32 against one process; at (1, 4) the Informer
    again with dropout 0.1."""
    frames = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(2))
    series = torch.randn(3, 8, 7, generator=torch.Generator().manual_seed(3))
    out = {"swin": _split_vs_one(_split_swin, frames, mesh, 16, fsdp),
           "informer": _split_vs_one(_split_informer(0.0), series, mesh, MIN_SHARD, fsdp)}
    if mesh.shape == (1, 4):
        out["informer_dropout"] = _split_vs_one(_split_informer(0.1), series, mesh, MIN_SHARD,
                                                fsdp)
    return out


def _unit_checks(arg, shape, fsdp):
    """On one mesh: the Routeformer's first-step gradients and a small
    SwinV2's (``train_backbone`` under remat) from the per-unit gathers
    against ``_whole_gather_grads`` on the same draws; the gathered bytes
    held at once through a trainer step and an MC eval, beside the largest
    unit's (``layout.largest_unit_bytes``) and the whole model's."""
    from routeformer_torch.models.video_backbone import SwinV2Backbone, TimmBackboneConfig
    from routeformer_torch.parallel import make_mesh
    from routeformer_torch.parallel.layout import largest_unit_bytes
    from routeformer_torch.parallel.mesh import MeshParams, whole_weights

    mesh = make_mesh(*shape, device="cpu")
    trainer = _trainer(_models(arg), arg, mesh, fsdp)
    model, layout = trainer.models["routeformer"], trainer.layouts["routeformer"]
    batch = arg["train"][0]
    inp, tgt = trainer._place(batch["train"]), trainer._place(batch["target"])
    rng = torch.get_rng_state()
    shared = trainer.shared_generator

    def step():
        torch.set_rng_state(rng)
        if shared is not None:
            shared.manual_seed(7)
        loss, _ = trainer._loss_fn("routeformer", model, inp, tgt, EPOCHS[0])
        loss.backward()

    gathered_over_model = set()
    gather = layout._gather

    def watched(p, *a, axes=("data", "model"), **k):
        if "model" in axes and "model" in layout.sharded[p]:
            gathered_over_model.add(layout._names[p])
        return gather(p, *a, axes=axes, **k)

    layout._gather = watched
    rec = {"routeformer_errs": _errs(_unit_grads(layout, model, step),
                                     _whole_gather_grads(layout, model, step))}
    del layout._gather
    rec["split_params"] = sorted(layout._names[p] for p in layout.split_params)
    rec["gathered_over_model"] = sorted(gathered_over_model)
    names = {n for n, m in model.named_modules() if m in layout.splits}
    twin = _models(arg)["routeformer"]

    def forward(m):
        def run():
            torch.set_rng_state(rng)
            if shared is not None:
                shared.manual_seed(7)
            trainer._loss_fn("routeformer", m, inp, tgt, EPOCHS[0])
        return run

    rec["flops"] = _layer_flops(twin, names, forward(twin))
    with layout.gathered():
        rec["split_flops"] = _layer_flops(model, names, forward(model))
    rec["split"] = _split_checks(mesh, fsdp)
    rec["zoo_split"] = _zoo_split_checks(mesh, fsdp)
    # 16: K1's pairs gathered whole beside the split patch merging, all
    # recomputed under remat; 96: only the pairs' weights shard
    for min_shard, key in ((16, "swin"), (96, "swin_pairs")):
        torch.manual_seed(3)
        swin = SwinV2Backbone(TimmBackboneConfig(model_type="swinv2_tiny_test",
                                                 compute_dtype="float32", gelu="tanh",
                                                 train_backbone=True, remat=True)).train()
        swin_layout = MeshParams(swin, mesh, min_shard, fsdp)
        frames = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
        rng_swin = torch.get_rng_state()

        def swin_step():
            torch.set_rng_state(rng_swin)
            _probe_loss(swin(frames)).backward()

        got = _unit_grads(swin_layout, swin, swin_step)
        want = _whole_gather_grads(swin_layout, swin, swin_step)
        rec[f"{key}_errs"], rec[f"{key}_same"] = _errs(got, want), _same(got, want)
        rec[f"{key}_sharded"] = len(swin_layout.sharded)
        rec[f"{key}_split"] = sum(  # split layers that compute on their blocks
            not whole_weights(swin_layout._unit_modules[sp.unit])
            for sp in swin_layout.splits.values())
        if key == "swin":
            rec["swin_high_water"] = swin_layout.high_water
            rec["swin_largest_unit"] = max(swin_layout.unit_bytes.values())
    rec["vit"] = _vit_unit_checks(arg, mesh, fsdp)
    rec["block_read"] = _block_read_check(mesh, fsdp)
    layout.reset_high_water()
    trainer.epoch = EPOCHS[0]
    trainer.training_step(batch)
    trainer.evaluate(arg["val"])
    rec["high_water"] = layout.high_water
    rec["largest_unit"] = largest_unit_bytes(_models(arg)["routeformer"], *shape, fsdp,
                                             MIN_SHARD)
    rec["largest_unit_unsplit"] = largest_unit_bytes(_models(arg)["routeformer"], *shape, fsdp,
                                                     MIN_SHARD, split=False)
    rec["whole"] = sum(int(np.prod(s)) * 4 for s in layout.full_shapes.values())
    rec["live_after"] = layout.live_bytes
    return rec


def _vit_unit_checks(arg, mesh, fsdp):
    """A Routeformer over the ViT (``vit_tiny_test``: width 32, so its
    positional embedding shards at ``MIN_SHARD``) with 32-wide stream
    embeddings (the gaze decoder takes them at the hidden width, so that is
    32 too), the backbone trained under remat and the dense loss on: the
    positional embedding is read in ``encode_frames``, the stream
    embeddings also in the loss's direct ``preprocess_batch`` call, neither
    inside a module call of their own. The first-step gradients from the
    per-unit gathers against a whole-model gather, and the gathered bytes
    held at once through a trainer step."""
    from routeformer_torch.models import Routeformer, RouteformerConfig
    from routeformer_torch.models.gps_backbone import GPSBackboneConfig
    from routeformer_torch.models.video_backbone import TimmBackbone, TimmBackboneConfig

    gps, video, top = arg["kwargs"]
    torch.manual_seed(5)
    model = Routeformer(
        RouteformerConfig(gps_backbone_config=GPSBackboneConfig(**gps),
                          video_backbone_config=TimmBackboneConfig(
                              **dict(video, model_type="vit_tiny_test", train_backbone=True,
                                     remat=True)),
                          **dict(top, image_embedding_size=MIN_SHARD,
                                 encoder_hidden_size=MIN_SHARD)),
        video_backbone=TimmBackbone)
    trainer = _trainer({"routeformer": model}, arg, mesh, fsdp)
    layout = trainer.layouts["routeformer"]
    batch = arg["train"][0]
    inp, tgt = trainer._place(batch["train"]), trainer._place(batch["target"])
    rng = torch.get_rng_state()
    shared = trainer.shared_generator

    def step():
        torch.set_rng_state(rng)
        if shared is not None:
            shared.manual_seed(7)
        loss, _ = trainer._loss_fn("routeformer", model, inp, tgt, EPOCHS[1])
        loss.backward()

    rec = {"errs": _errs(_unit_grads(layout, model, step),
                         _whole_gather_grads(layout, model, step)),
           "sharded": sorted(k for k, p in model.named_parameters() if hasattr(p, "mesh_spec")),
           "resident": sorted(layout.resident)}
    layout.reset_high_water()
    trainer.epoch = EPOCHS[1]
    trainer.training_step(batch)
    rec["high_water"] = layout.high_water
    rec["largest_unit"] = max(layout.unit_bytes.values())
    rec["live_after"] = layout.live_bytes
    return rec


class _ReadsChildWeight(torch.nn.Module):
    """Computes with its child's weight without calling the child."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(2 * MIN_SHARD, 2 * MIN_SHARD)

    def forward(self, x):
        return torch.nn.functional.linear(x, self.lin.weight)


def _block_read_check(mesh, fsdp):
    """Under ``gathered`` a read of a sharded weight outside its unit's
    call raises, naming the weight; the unit's own call still works, and
    the module holds its parameter again after the body."""
    from routeformer_torch.parallel.mesh import MeshParams

    torch.manual_seed(6)
    module = _ReadsChildWeight()
    layout = MeshParams(module, mesh, MIN_SHARD, fsdp)
    x = torch.ones(1, 2 * MIN_SHARD)
    rec = {"error": None}
    with layout.gathered():
        try:
            module(x)
        except RuntimeError as e:
            rec["error"] = str(e)
        rec["unit_call"] = tuple(module.lin(x).shape)
    rec["restored"] = module.lin.weight is next(iter(layout.sharded))
    return rec


def _post_backward_reduction(layout, model):
    """The data reduction as it ran before it moved under the backward,
    after the backward: each sharded gradient in parameter order (a
    reduce-scatter along the FSDP dim, else an all-reduce of the block),
    then the replicated gradients in one flat all-reduce per dtype."""
    import torch.distributed as dist

    from routeformer_torch.parallel.mesh import DATA_AXIS

    n_data, group = layout.n_data, layout.mesh.get_group(DATA_AXIS)
    pending, layout._pending = layout._pending, {}
    for p, spec in layout.sharded.items():
        g = pending.get(p)
        if g is None:
            continue
        if n_data > 1:
            if DATA_AXIS in spec:
                d = spec.index(DATA_AXIS)
                whole = g.movedim(d, 0).contiguous()
                out = whole.new_empty((whole.shape[0] // n_data,) + whole.shape[1:])
                dist.reduce_scatter_tensor(out, whole, group=group)
                g = out.movedim(0, d)
            else:
                g = g.contiguous()
                dist.all_reduce(g, group=group)
            g = g / n_data
        g = g.contiguous()
        p.grad = g if p.grad is None else p.grad + g
    if n_data == 1:
        return
    by_dtype = {}
    for p in model.parameters():
        if p.grad is not None and p not in layout.sharded:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for gs in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in gs])
        dist.all_reduce(flat, group=group)
        flat /= n_data
        offset = 0
        for g in gs:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def _reduction_check(arg, mesh, fsdp):
    """The Routeformer's first-step gradients (every parameter) with the
    data reduction under the backward against the post-backward one
    (``_post_backward_reduction``) on the same draws; the reductions
    launched before the backward returned; the data-whole gradients'
    high-water beside the largest unit's and the whole model's."""
    trainer = _trainer(_models(arg), arg, mesh, fsdp)
    model, layout = trainer.models["routeformer"], trainer.layouts["routeformer"]
    batch = arg["train"][0]
    inp, tgt = trainer._place(batch["train"]), trainer._place(batch["target"])
    rng = torch.get_rng_state()
    shared = trainer.shared_generator
    params = list(model.parameters())  # the parameters, not the blocks' stand-ins

    def backward():
        for p in params:
            p.grad = None
        torch.set_rng_state(rng)
        if shared is not None:
            shared.manual_seed(7)
        loss, _ = trainer._loss_fn("routeformer", model, inp, tgt, EPOCHS[0])
        loss.backward()

    def grads():
        return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}

    layout.reset_high_water()
    with layout.gathered():
        backward()
        rec = {"launched_in_backward": layout.launched_in_backward,
               "reductions": len(layout._reductions or ())}
        layout.reduce_grads()
    rec["grad_high_water"] = layout.grad_high_water
    rec["largest_unit_grad"] = max(layout.unit_grad_bytes.values(), default=0)
    rec["whole_grad"] = sum(layout.unit_grad_bytes.values())
    rec["live_after"] = layout.grad_live_bytes
    new = grads()
    with layout.gathered():
        layout._advance = lambda: None  # nothing launched under the backward
        backward()
        _post_backward_reduction(layout, model)
    del layout._advance
    ref = grads()
    rec["same"] = _same(new, ref)
    rec["errs"] = _errs(new, ref)
    return rec


def _fedformer_jax_check(arg, mesh, fsdp):
    """The FEDformer Fourier backbone of ``arg["fed"]`` (the JAX model's
    weights through ``load_flax_params``) split on ``mesh``: every
    gradient of the squared output's sum, gathered whole."""
    from routeformer_torch.convert import load_flax_params
    from routeformer_torch.models.gps_backbone import FEDformer, FEDFormerBackboneConfig
    from routeformer_torch.parallel.mesh import MeshParams, spec_gather

    fed = arg["fed"]
    model = FEDformer(FEDFormerBackboneConfig(**fed["cfg"]),
                      mode_rng=np.random.RandomState(fed["seed"])).train()
    load_flax_params(model, fed["flat"])
    layout = MeshParams(model, mesh, MIN_SHARD, fsdp)
    with layout.gathered():
        (model(torch.from_numpy(fed["x"])) ** 2).sum().backward()
        layout.reduce_grads()
    def whole(p):  # a projection FourierBlock does not read takes none: JAX's zeros
        if p.grad is None:
            return np.zeros(layout.full_shapes.get(p, p.shape), np.float32)
        g = spec_gather(p.grad, layout.sharded[p], mesh) if p in layout.sharded else p.grad
        return g.numpy()

    return {"grads": {n: whole(p) for n, p in model.named_parameters()},
            "kinds": sorted({(type(layer).__name__, sp.kind) for layer, sp in
                             layout.splits.items()})}


def rank_checks(rank, n, arg):
    """Every rank-side check; rank 0 returns its records, every rank its
    loader and memo records."""
    from routeformer_torch.io.loader import DataLoader
    from routeformer_torch.models.video_backbone.cache import (
        DeviceVideoFeaturePrecomputer,
        MeshDeviceVideoFeaturePrecomputer,
    )
    from routeformer_torch.parallel import make_mesh
    from routeformer_torch.parallel.dryrun import _model, tiny_flagship_config
    from routeformer_torch.parallel.mesh import row_block
    from routeformer_torch.train import CheckpointManager

    out = {"rank": rank, "mesh": {}}
    for key, (shape, fsdp) in MESHES.items():
        mesh = make_mesh(*shape, device="cpu")
        reduction = _reduction_check(arg, mesh, fsdp)
        trainer = _trainer(_models(arg), arg, mesh, fsdp)
        rec = {"sharded": {k: tuple(p.shape) for k, p in
                           trainer.models["routeformer"].named_parameters()
                           if hasattr(p, "mesh_spec")}}
        save = None
        if key == "fsdp":
            rec["eval_before"] = _floats(trainer.evaluate(arg["val"]))
            ckpt = CheckpointManager(Path(arg["dir"]) / "ckpt")
            save = lambda: ckpt.save_latest(trainer, EPOCHS[0], next_batch=1)  # noqa: E731
        rec["steps"] = _steps(trainer, arg, save)
        rec["params"] = _params(trainer)
        if key == "fsdp":
            from routeformer_torch.train.checkpoints import model_state

            rec["eval_after"] = _floats(trainer.evaluate(arg["val"]))
            rec["state"] = {k: v.numpy() for k, v in model_state(trainer, "routeformer").items()}
            restored = {}
            for again, (shape2, fsdp2) in (("same", MESHES["fsdp"]), ("dp", MESHES["dp"])):
                fresh = _trainer(_models(arg, seed_noise=1), arg,
                                 make_mesh(*shape2, device="cpu"), fsdp2)
                pos = ckpt.restore_latest(fresh)
                fresh.epoch = EPOCHS[1]
                loss = float(fresh.training_step(arg["train"][1])["train_total_loss"])
                restored[again] = {"pos": pos, "loss": loss, "params": _params(fresh)}
            rec["restored"] = restored
        rec["reduction"] = reduction
        out["mesh"][key] = rec

    out["units"] = {key: _unit_checks(arg, shape, fsdp)
                    for key, (shape, fsdp) in UNIT_MESHES.items()}

    mesh22 = make_mesh(2, 2, device="cpu")
    out["fed_jax"] = _fedformer_jax_check(arg, mesh22, True)
    from routeformer_torch.parallel import MeshParams, batch_spec, shard_params

    laid_out = _models(arg)["routeformer"]
    layout = shard_params(laid_out, mesh22, MIN_SHARD, fsdp=True)
    out["shard_params"] = {
        "is_layout": isinstance(layout, MeshParams), "batch_spec": batch_spec(),
        "specs": {k: tuple(p.mesh_spec) for k, p in laid_out.named_parameters()
                  if hasattr(p, "mesh_spec")}}
    out["patchtst"] = _patchtst_step(_trainer(_patchtst(arg), arg, mesh22), arg["patch_batch"])

    mesh41 = make_mesh(4, 1, device="cpu")
    from routeformer_torch.parallel.mesh import DATA_AXIS

    out["zoo"] = _zoo_run(arg, row_block(ZOO_ROWS, mesh41), mesh41.get_group(DATA_AXIS))
    out["zoo"]["rows"] = row_block(ZOO_ROWS, mesh41)
    orders = {}
    for dedup in (True, False):
        for shuffle in (True, False):
            loader = DataLoader(Windows(), batch_size=LOADER_B, shuffle=shuffle, seed=3,
                                mesh=mesh41, to_device=True, h2d_dedup=dedup, device="cpu")
            for epoch in range(3):
                loader.set_epoch(epoch)
                orders[(dedup, shuffle, epoch)] = loader._indices()
    out["orders"] = orders
    loader = DataLoader(Windows(), batch_size=LOADER_B, shuffle=True, seed=3, mesh=mesh41,
                        to_device=True, h2d_dedup=True, device="cpu", num_threads=2)
    ds, rows_ok, shipped = Windows(), True, []
    for epoch in range(2):
        loader.set_epoch(epoch)
        for idx, batch in zip(loader.batch_indices(), loader):
            want = [ds[int(i)] for i in idx[row_block(LOADER_B, mesh41)]]
            rows_ok &= np.array_equal(batch["left_video"].numpy(),
                                      np.stack([w["left_video"] for w in want]))
            rows_ok &= np.array_equal(batch["gps"].numpy(),
                                      np.stack([w["gps"] for w in want]).astype(np.float32))
        shipped.append({k: v["shipped"] for k, v in loader.frame_store_stats().items()})
    out["loader"] = {"rows_ok": bool(rows_ok), "shipped": shipped}

    cfg = tiny_flagship_config()
    model = _model(cfg, seed=4).eval()
    video = np.random.default_rng(rank * 0 + 5).uniform(size=(8, 8, 16, 24, 3)).astype(
        np.float32)
    got = MeshDeviceVideoFeaturePrecomputer(model, mesh41, device="cpu")
    first = got({"left_video": video, "gps": np.zeros((8, 3, 2))})
    again = got({"left_video": video})
    stats = got.stats()
    want = DeviceVideoFeaturePrecomputer(model, device="cpu")({"left_video": video})
    try:
        MeshDeviceVideoFeaturePrecomputer(model, mesh22, device="cpu")
        refused = None
    except ValueError as e:
        refused = str(e)
    out["memo"] = {
        "err": float((first["left_video_features"]
                      - want["left_video_features"][row_block(8, mesh41)]).abs().max()),
        "warm_same": bool(torch.equal(again["left_video_features"],
                                      first["left_video_features"])),
        "gps_passes": first["gps"].shape == (8, 3, 2), "stats": stats, "refused": refused}
    return out


# --------------------------------------------------------- parent side -- #


def _batch4(seed, pci):
    from test_torch_routeformer import PRED_LEN, _inputs

    def four(s):
        a, b = _inputs(s), _inputs(s + 50)
        return {k: np.concatenate([a[k], b[k]]) for k in a}

    tgt = {k: v if k == "gaze" else v[:, :PRED_LEN] for k, v in four(seed + 1).items()}
    return {"train": four(seed), "target": tgt, "pci": np.asarray(pci, np.float32)}


def _jax_model(kwargs):
    """The JAX package's small Routeformer of ``test_torch_trainer.py``."""
    from flax import nnx

    from test_torch_trainer import (
        EXHAUSTIVE,
        JaxConfig,
        JaxGPSConfig,
        JaxInformer,
        JaxPerceiveEncoder,
        JaxProbAttention,
        JaxRouteformer,
        JaxSwin,
        JaxTimmConfig,
    )

    gps, video, top = kwargs
    model = JaxRouteformer(
        JaxConfig(gps_backbone_config=JaxGPSConfig(**gps),
                  video_backbone_config=JaxTimmConfig(cache_enabled=False, **video), **top),
        gps_backbone=JaxInformer, video_backbone=JaxSwin, rngs=nnx.Rngs(0, dropout=1))
    for _, m in nnx.iter_modules(model):
        if isinstance(m, (JaxProbAttention, JaxPerceiveEncoder)):
            m.factor = EXHAUSTIVE
    return model


FED_SEED = 7  # FEDformer's Fourier modes: numpy's global generator (JAX), a RandomState (port)


def _fed_jax_model(cfg):
    """The JAX package's FEDformer at ``cfg``, its modes drawn from numpy's
    global generator seeded at ``FED_SEED``."""
    from flax import nnx

    from routeformer_tpu.models.gps_backbone.config import FEDFormerBackboneConfig
    from routeformer_tpu.models.gps_backbone.fedformer import FEDformer

    np.random.seed(FED_SEED)
    return FEDformer(FEDFormerBackboneConfig(**cfg), rngs=nnx.Rngs(0, dropout=1))


def _fed_jax_grads(arg):
    """``jax.grad`` of the squared output's sum of ``arg["fed"]``'s JAX
    FEDformer in train mode (dropout 0), in the port's names and layouts."""
    import jax
    import jax.numpy as jnp
    from flax import nnx

    from routeformer_torch.convert import flax_to_torch_names
    from test_torch_models import import_params

    fed = arg["fed"]
    model = _fed_jax_model(fed["cfg"])
    import_params(model, fed["flat"])
    model.train()
    graphdef, params, rest = nnx.split(model, nnx.Param, ...)
    x = jnp.asarray(fed["x"])

    def loss(p):
        return (nnx.merge(graphdef, p, rest)(x) ** 2).sum()

    grads = nnx.to_flat_state(jax.jit(jax.grad(loss))(params))
    return flax_to_torch_names({".".join(map(str, k)): np.asarray(v[...]) for k, v in grads})


def _arg(tmp_dir):
    from test_torch_autoformer import gps_kwargs
    from test_torch_models import export_params
    from test_torch_routeformer import EXHAUSTIVE
    from test_torch_train import OPT
    from test_torch_trainer import _configs

    flat = export_params(_jax_model(_configs()), np.random.default_rng(0))
    fed_cfg = gps_kwargs(version="Fourier", modes=4)
    fed = {"cfg": fed_cfg, "seed": FED_SEED,
           "flat": export_params(_fed_jax_model(fed_cfg), np.random.default_rng(2)),
           "x": np.random.RandomState(4).randn(3, fed_cfg["seq_len"],
                                                fed_cfg["_enc_in"]).astype(np.float32)}
    rng = np.random.default_rng(1)
    gps = np.cumsum(rng.normal(size=(4, 14, 2)) * 0.5, axis=1).astype(np.float32)
    return {"fed": fed, "kwargs": _configs(), "exhaustive": EXHAUSTIVE, "flat": flat, "opt": OPT,
            "train": [_batch4(7, [30.0] * 4), _batch4(11, [30.0] * 4)],
            "val": [_batch4(21, [23.0, 70.0, 45.0, 90.0])], "dir": str(tmp_dir),
            "patch_batch": {"train": {"gps": gps[:, :8]}, "target": {"gps": gps[:, 8:]}},
            "zoo": {"series": rng.normal(size=(ZOO_ROWS, 20, 7)).astype(np.float32),
                    "frames": rng.uniform(size=(ZOO_ROWS, 32, 32, 3)).astype(np.float32)}}


def _jax_fsdp_run(arg):
    """The JAX trainer at (2, 2) with FSDP on the virtual mesh: both steps'
    metrics, the first step's gradients (Adam's first moment) and the
    final parameters."""
    from flax import nnx

    from routeformer_tpu.parallel import make_mesh
    from test_torch_models import import_params
    from test_torch_trainer import (
        OPT,
        SCHEDULE,
        JaxConfig,
        JaxGPSConfig,
        JaxRouteformer,
        JaxStationary,
        JaxTrainer,
        _flat_torch,
        jax_build_optimizer,
    )

    gps, _, _ = arg["kwargs"]
    model = _jax_model(arg["kwargs"])
    import_params(model, arg["flat"])
    baseline = JaxRouteformer(
        JaxConfig(gps_backbone_config=JaxGPSConfig(**gps), discount_factor=SCHEDULE,
                  epsilon=1.0), gps_backbone=JaxStationary, rngs=nnx.Rngs(1, dropout=2))
    shape, fsdp = MESHES["fsdp"]
    trainer = JaxTrainer({"routeformer": model, "stationary_baseline": baseline},
                         jax_build_optimizer(**OPT), model.configs, unfreeze_epoch=None,
                         mesh=make_mesh(*shape), min_shard_dim=MIN_SHARD, fsdp=fsdp)
    steps, grads = [], None
    for epoch, batch in zip(EPOCHS, arg["train"]):
        trainer.epoch = epoch
        steps.append(_floats(trainer.training_step(batch)))
        if grads is None:
            grads = {}
            for group in trainer.opt_state[1].inner_states.values():
                grads.update(_flat_torch(group.inner_state[0].mu["routeformer"]))
    return steps, {k: g / 0.1 for k, g in grads.items()}, _flat_torch(
        trainer.params["routeformer"])


def _one_process(arg):
    """The port's trainer in one process on the global batches: steps,
    first-step gradients, parameters, evals; and PatchTST's step."""
    ref = _trainer(_models(arg), arg)
    out = {"eval_before": _floats(ref.evaluate(arg["val"]))}
    grads = {}

    def keep_grads():
        grads.update({k: p.grad.numpy().copy() for k, p in
                      ref.models["routeformer"].named_parameters()})

    out["steps"] = _steps(ref, arg, keep_grads)
    out["grads"] = grads
    out["params"] = _params(ref)
    out["patchtst"] = _patchtst_step(_trainer(_patchtst(arg), arg), arg["patch_batch"])
    out["zoo"] = _zoo_run(arg)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4 ranks' records (rank 0's and every rank's), the one-process
    references and the JAX trainer's run. The ranks run in a thread while
    the parent computes the references."""
    from routeformer_torch.parallel.dryrun import launch

    torch.set_num_threads(1)
    arg = _arg(tmp_path_factory.mktemp("mesh"))
    box = {}

    def ranks():
        try:
            box["ranks"] = launch("test_torch_mesh_train:rank_checks", N, arg,
                                  timeout_s=400, pythonpath=[Path(__file__).parent])
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["error"] = e

    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        one = _one_process(arg)
        jax_run = _jax_fsdp_run(arg)
        fed_grads = _fed_jax_grads(arg)
    finally:
        thread.join()
    if "error" in box:
        raise box["error"]
    return {"ranks": box["ranks"], "one": one, "jax": jax_run, "fed_jax": fed_grads, "arg": arg}


def _hold_params(got, want, grads, lr):
    scale = max(np.abs(g).max() for g in grads.values())
    assert set(got) == set(want)
    for k, w in want.items():
        diff = np.abs(got[k] - w)
        firm = np.abs(grads[k]) > 1e-3 * scale
        assert diff[firm].max(initial=0.0) <= 1e-3 * lr, k
        assert diff.max() <= 2 * lr, k


@pytest.mark.parametrize("key", list(MESHES))
def test_mesh_steps_match_one_process(runs, key):
    """Both steps' metrics and grad norms at 1e-5 relative, the parameters
    by the rule, and the layout: nothing sharded on (4, 1), matrices split
    over ``model`` on (2, 2), and with FSDP some over ``data`` too."""
    rec, one = runs["ranks"][0]["mesh"][key], runs["one"]
    for got, want in zip(rec["steps"], one["steps"]):
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=1e-5), (key, k)
    _hold_params(rec["params"], one["params"], one["grads"], runs["arg"]["opt"]["learning_rate"])
    full = {k: v.shape for k, v in one["params"].items()}
    if key == "dp":
        assert not rec["sharded"]
    else:
        assert len(rec["sharded"]) >= 10
        for k, block in rec["sharded"].items():
            assert np.prod(block) * (4 if key == "fsdp" else 2) >= np.prod(full[k]), k
        if key == "fsdp":
            assert any(np.prod(b) * 4 == np.prod(full[k]) for k, b in rec["sharded"].items())


def test_fsdp_mesh_matches_the_jax_trainer(runs):
    """(2, 2) with FSDP against the JAX trainer on its (2, 2) FSDP mesh:
    every metric of both steps at 1e-5 relative, the parameters by the
    rule (firm gradients from JAX's first step)."""
    rec = runs["ranks"][0]["mesh"]["fsdp"]
    want_steps, want_g, want_p = runs["jax"]
    for got, want in zip(rec["steps"], want_steps):
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=1e-5), k
    _hold_params(rec["params"], want_p, want_g, runs["arg"]["opt"]["learning_rate"])


def test_mesh_mc_eval_matches_one_process(runs):
    """The MC eval's bucketed metrics, gathered in global row order, at
    1e-5 relative: before the steps against the one process's; after them
    against one process evaluating the mesh's own weights (the derived
    weights the ranks cached before the steps followed the optimizer; the
    one process's own steps leave weights up to 2 lr apart)."""
    rec, arg = runs["ranks"][0]["mesh"]["fsdp"], runs["arg"]
    models = _models(arg)
    models["routeformer"].load_state_dict({k: torch.from_numpy(v)
                                           for k, v in rec["state"].items()})
    after = _trainer(models, arg)
    after.epoch = EPOCHS[1]
    want = {"eval_before": runs["one"]["eval_before"],
            "eval_after": _floats(after.evaluate(arg["val"]))}
    for when, values in want.items():
        assert set(rec[when]) == set(values)
        for k, v in values.items():
            assert rec[when][k] == pytest.approx(v, rel=1e-5, abs=1e-6), (when, k)


def test_patchtst_batchnorm_is_the_global_batch(runs):
    """PatchTST at ``data=2``: the loss, BatchNorm's running statistics and
    the parameters after one step equal the one process's on the global
    batch."""
    got, want = runs["ranks"][0]["patchtst"], runs["one"]["patchtst"]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert set(got["stats"]) == set(want["stats"]) and want["stats"]
    for k, v in want["stats"].items():
        np.testing.assert_allclose(got["stats"][k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    lr = runs["arg"]["opt"]["learning_rate"]
    for k, v in want["params"].items():
        assert np.abs(got["params"][k] - v).max() <= 2 * lr, k


@pytest.mark.parametrize("part", ["auto", "inv"])
def test_zoo_batch_coupling_is_the_global_batch(runs, part):
    """At (4, 1): Autoformer's training delays (chosen from the global
    batch's mean correlation) and InverseForm's train-mode BatchNorm
    (global statistics, and the running ones after the forward) give each
    rank the one process's rows of the global batch (f32: Autoformer at
    1e-4, InverseForm's output at 1e-3, its statistics' sums reordered
    through a 40-conv trunk, and its running statistics at 1e-4)."""
    want = runs["one"]["zoo"]
    tol = 1e-4 if part == "auto" else 1e-3
    for rec in runs["ranks"]:
        got = rec["zoo"]
        np.testing.assert_allclose(got[part], want[part][got["rows"]], rtol=tol, atol=tol)
        if part == "inv":
            assert set(got["stats"]) == set(want["stats"]) and want["stats"]
            for k, v in want["stats"].items():
                np.testing.assert_allclose(got["stats"][k], v, rtol=1e-4, atol=1e-5, err_msg=k)


def test_snapshot_restores_on_a_fresh_mesh(runs):
    """A snapshot under FSDP, restored on a fresh (2, 2) FSDP mesh: the
    next step gives the uninterrupted run's bits; restored on a (4, 1)
    mesh, the same step within 1e-5."""
    rec = runs["ranks"][0]["mesh"]["fsdp"]
    same, other = rec["restored"]["same"], rec["restored"]["dp"]
    assert same["pos"] == other["pos"] == (EPOCHS[0], 1)
    assert same["loss"] == rec["steps"][1]["train_total_loss"]
    for k, v in rec["params"].items():
        assert np.array_equal(same["params"][k], v), k
    assert other["loss"] == pytest.approx(rec["steps"][1]["train_total_loss"], rel=1e-5)


@pytest.mark.parametrize("key", list(UNIT_MESHES))
def test_unit_gathers_hold_at_most_the_largest_unit(runs, key):
    """Through a trainer step and an MC eval, the whole weights a rank
    holds at once never exceed the largest gather unit's (``layout.py``),
    which is below the whole model's; none is left after them."""
    for r in runs["ranks"]:
        rec = r["units"][key]
        assert 0 < rec["high_water"] <= rec["largest_unit"] < rec["whole"], (r["rank"], rec)
        assert 0 < rec["swin_high_water"] <= rec["swin_largest_unit"], (r["rank"], rec)
        assert rec["live_after"] == 0, (r["rank"], rec)


@pytest.mark.parametrize("key", list(UNIT_MESHES))
def test_unit_gathers_give_the_whole_gather_gradients(runs, key):
    """Cut to the rank's ``model`` block before the ``data`` reduction, the
    per-unit gradients are the whole-model gather's within 1e-5 of the
    largest gradient, for the Routeformer and for a SwinV2 trained under
    remat at ``min_shard_dim`` 16 (K1's pairs gathered whole beside its
    split patch merging; its forward gathers again inside the backward's
    recomputation): their split layers compute on their blocks, a row
    split's partial products summed in another order."""
    for r in runs["ranks"]:
        rec = r["units"][key]
        for name in ("routeformer_errs", "swin_errs"):
            assert rec[name] is not None, (r["rank"], name, rec)
            assert max(rec[name].values()) <= 1e-5, (r["rank"], name, rec[name])
        assert rec["swin_sharded"] >= 8 and rec["swin_split"] >= 1, rec


@pytest.mark.parametrize("key", list(UNIT_MESHES))
def test_unit_gathers_give_whole_pairs_the_whole_gather_bits(runs, key):
    """Where only K1's pairs shard (the remat SwinV2 at ``min_shard_dim``
    96: no split layer), the per-unit gradients are the bits of the
    whole-model gather's (each element's sum over at most 2 data shards is
    one addition either way)."""
    for r in runs["ranks"]:
        rec = r["units"][key]
        assert rec["swin_pairs_same"], (r["rank"], rec["swin_pairs_errs"])
        assert rec["swin_pairs_sharded"] >= 8 and rec["swin_pairs_split"] == 0, rec


@pytest.mark.parametrize("key", list(UNIT_MESHES))
def test_split_layers_compute_their_share_of_the_flops(runs, key):
    """Each rank's matmul and convolution FLOPs in every split layer of the
    Routeformer's training forward are exactly 1/n_model of its one-process
    twin's on the same rows (the layer's backward products take the same
    blocks)."""
    n_model = UNIT_MESHES[key][0][1]
    for r in runs["ranks"]:
        rec = r["units"][key]
        want, got = rec["flops"], rec["split_flops"]
        assert len(want) >= 20 and sum(want.values()) > 0, rec["flops"]
        assert {n: got[n] * n_model for n in want} == want, (r["rank"], got, want)


@pytest.mark.parametrize("key", list(UNIT_MESHES))
def test_split_weights_are_never_gathered_whole(runs, key):
    """No split layer's weight is gathered over ``model`` through a step,
    and the gathered bytes a rank holds at once stay within the largest
    unit's without the split weights, below that unit's whole bytes."""
    for r in runs["ranks"]:
        rec = r["units"][key]
        assert len(rec["split_params"]) >= 20, rec["split_params"]
        assert not set(rec["gathered_over_model"]) & set(rec["split_params"]), rec
        assert rec["high_water"] <= rec["largest_unit"] < rec["largest_unit_unsplit"], rec


@pytest.mark.parametrize("key,part", [(k, p) for k in UNIT_MESHES for p in ("swin", "informer")]
                         + [("tp", "informer_dropout")])
def test_split_layers_match_one_process(runs, key, part):
    """A small exact-gelu SwinV2 (qkv column-split and gathered before K2,
    proj, fc1 -> fc2 kept split, patch merging and the position-bias MLP)
    and the Informer (its square projections, ff1 -> ff2 kept split, the
    distil convolution row-split, the token convolutions column-split), on
    each rank: the output within 1e-5 of the one process's max, every
    gradient within 1e-5 of its largest gradient; at (1, 4) the Informer again with dropout 0.1 (each kept-split
    mask the one a single process draws, from the same generator state)."""
    for r in runs["ranks"]:
        rec = r["units"][key]["split"][part]
        kinds = {(k, s) for k, s, _ in rec["kinds"]}
        assert ("Linear", "column") in kinds and ("Linear", "row") in kinds, rec["kinds"]
        assert any(keep for _, _, keep in rec["kinds"]), rec["kinds"]
        if part != "swin":
            assert ("Conv1d", "row") in kinds and ("Conv1d", "column") in kinds, rec["kinds"]
        assert max(rec["errs"].values()) <= 1e-5, (r["rank"], part, rec["errs"])


@pytest.mark.parametrize("key", list(UNIT_MESHES))
def test_unit_gathers_reach_weights_read_outside_a_unit_call(runs, key):
    """A ViT Routeformer whose positional embedding and stream embeddings
    are sharded (read in ``encode_frames`` and in the loss's direct
    ``preprocess_batch``): the per-unit gradients are the whole-model
    gather's within 1e-5 of its largest gradient (its blocks' Linear layers
    split around K4's plain version), and the gathered bytes stay within
    its largest unit's, the resident embeddings included."""
    for r in runs["ranks"]:
        rec = r["units"][key]["vit"]
        for name in ("video_backbone.pos_embed", "video_backbone.patch_embed.weight",
                     "left_video_embedding", "gaze_video_embedding"):
            assert name in rec["sharded"], (name, rec["sharded"])
        assert rec["resident"] == ["", "video_backbone"], rec
        assert rec["errs"] is not None and max(rec["errs"].values()) <= 1e-5, (r["rank"], rec)
        assert 0 < rec["high_water"] <= rec["largest_unit"], (r["rank"], rec)
        assert rec["live_after"] == 0, (r["rank"], rec)


@pytest.mark.parametrize("key", list(UNIT_MESHES))
def test_unit_gathers_refuse_a_block_read_outside_its_unit(runs, key):
    """A module that computes with its child's sharded weight without
    calling the child raises under ``gathered``, naming the weight, where
    it would otherwise compute with this rank's block."""
    for r in runs["ranks"]:
        rec = r["units"][key]["block_read"]
        assert rec["error"] is not None and "lin.weight" in rec["error"], rec
        assert rec["unit_call"] == (1, 2 * MIN_SHARD) and rec["restored"], rec


def test_shard_params_and_batch_spec_match_jax(runs):
    """``shard_params`` at (2, 2) with FSDP lays the Routeformer out as
    JAX's ``param_spec`` does (mapped to the port's names and layouts), and
    ``batch_spec`` is JAX's ``P("data")``."""
    from routeformer_tpu.parallel.mesh import batch_spec as jax_batch_spec
    from test_torch_mesh import _jax_flat, _jax_specs_in_torch_layout

    rec = runs["ranks"][0]["shard_params"]
    assert rec["is_layout"] and rec["batch_spec"] == tuple(jax_batch_spec())
    want = _jax_specs_in_torch_layout(_jax_flat(lambda: _jax_model(runs["arg"]["kwargs"])),
                                      2, n_model=2, min_shard=MIN_SHARD)
    assert rec["specs"] == {k: v for k, v in want.items() if v}
    assert len(rec["specs"]) >= 10


def test_mesh_loader_order_matches_jax(runs):
    """The mesh loader's epoch order equals JAX's ``DataLoader(mesh=
    make_mesh(4, 1))``: shard-stable with the frame store, the plain
    order without, shuffle on and off, epochs 0-2."""
    from routeformer_tpu.io.loader import DataLoader as JaxLoader
    from routeformer_tpu.parallel import make_mesh

    for (dedup, shuffle, epoch), got in runs["ranks"][0]["orders"].items():
        jax_loader = JaxLoader(Windows(), batch_size=LOADER_B, shuffle=shuffle, seed=3,
                               mesh=make_mesh(4, 1), to_device=True, h2d_dedup=dedup)
        jax_loader.set_epoch(epoch)
        np.testing.assert_array_equal(got, jax_loader._indices(),
                                      err_msg=str((dedup, shuffle, epoch)))


def test_mesh_loader_rows_and_frame_store(runs):
    """Each rank reads its row block of every batch, the same bytes as the
    dataset's samples, and a warm epoch ships no frame (the sum over
    ranks)."""
    for r in runs["ranks"]:
        assert r["loader"]["rows_ok"], r["rank"]
        cold, warm = r["loader"]["shipped"]
        assert cold and warm == cold, (cold, warm)


def test_mesh_memo_matches_one_device(runs):
    """Each rank's memo features equal the one-device memo's rows; a warm
    pass encodes nothing; a model axis is refused with JAX's message."""
    for r in runs["ranks"]:
        memo = r["memo"]
        assert memo["err"] <= 1e-6 and memo["warm_same"] and memo["gps_passes"], memo
        assert memo["stats"]["encoded"] > 0 and memo["stats"]["seen"] == 2 * 4 * 2 * 4  # calls x ranks x rows x frames
        assert "pure data-parallel mesh (model axis is 2)" in memo["refused"]


@pytest.mark.parametrize("key,model,dropout", [(k, m, p) for k in UNIT_MESHES for m in ZOO_SPLIT
                                               for p in ZOO_DROPOUTS])
def test_zoo_layers_split_match_one_process(runs, key, model, dropout):
    """Autoformer, FEDformer Fourier and FEDformer Wavelets with their
    layers split over ``model`` (no unit of theirs gathered whole), against
    one process from the same weights and generator state, dropout 0 and
    0.1 (ff1's kept split draws the one process's mask): the output within
    1e-5 of its max, every gradient within 1e-5 of the largest gradient.
    The projections are row splits (the square weights' tie-break), ff1
    column-split and kept into ff2, the decoder's circular trend
    convolution row-split, and the Wavelets' spectral weights row-split."""
    for r in runs["ranks"]:
        rec = r["units"][key]["zoo_split"][(model, dropout)]
        kinds = set(rec["kinds"])
        assert {("Linear", "row", False), ("Linear", "column", True), ("Conv1d", "row", False),
                ("Conv1d", "column", False)} <= kinds, rec["kinds"]
        if model == "fedformer_wavelets":
            assert {("SparseKernelFT1d", "row", False), ("Linear", "column", False)} <= kinds
        assert max(rec["errs"].values()) <= 1e-5, (r["rank"], model, rec["errs"])


@pytest.mark.parametrize("key,model", [(k, m) for k in UNIT_MESHES for m in ZOO_SPLIT])
def test_zoo_split_layers_compute_their_share_of_the_flops(runs, key, model):
    """Each split layer of the zoo's GPS backbones, SparseKernelFT1d's
    three products included (its input channels' DFT and weight product,
    the scattered sum's inverse DFT), does exactly 1/n_model of its
    one-process twin's forward FLOPs on the same rows."""
    n_model = UNIT_MESHES[key][0][1]
    for r in runs["ranks"]:
        rec = r["units"][key]["zoo_split"][(model, 0.0)]
        want, got = rec["flops"], rec["split_flops"]
        assert len(want) >= 20 and all(want.values()), want
        if model == "fedformer_wavelets":
            assert any(n.endswith(".mwt_cz.0.A") for n in want), sorted(want)
        assert {n: got[n] * n_model for n in want} == want, (r["rank"], got, want)


@pytest.mark.parametrize("key,model", [(k, m) for k in UNIT_MESHES for m in ZOO_SPLIT])
def test_zoo_split_weights_are_never_gathered_whole(runs, key, model):
    """Through a step no split weight of the zoo's GPS backbones is gathered
    over ``model`` (the Autoformer layers gather nothing over it now); the
    data reductions start under the backward."""
    for r in runs["ranks"]:
        for dropout in ZOO_DROPOUTS:
            rec = r["units"][key]["zoo_split"][(model, dropout)]
            assert len(rec["split_params"]) >= 20, rec["split_params"]
            assert not rec["gathered_over_model"], (r["rank"], rec["gathered_over_model"])
            assert rec["launched_in_backward"] > 0, rec


@pytest.mark.parametrize("key", list(MESHES))
def test_reduction_under_the_backward_matches_the_post_backward_one(runs, key):
    """The Routeformer's gradients with each data reduction launched in the
    backward that completes its gradient (a fixed order on every rank)
    against the reduction after the backward, on the same draws: the same
    bits where two data shards sum (one addition either way), else within
    1e-6 of the largest gradient; at least one reduction launched before
    the backward returned, none left in flight."""
    n_data = MESHES[key][0][0]
    for r in runs["ranks"]:
        rec = r["mesh"][key]["reduction"]
        assert rec["errs"] is not None, rec
        if n_data == 2:
            assert rec["same"], (r["rank"], rec["errs"])
        else:
            assert max(rec["errs"].values()) <= 1e-6, (r["rank"], rec["errs"])
        assert 0 < rec["launched_in_backward"] <= rec["reductions"], rec
        assert rec["live_after"] == 0, rec


@pytest.mark.parametrize("model", ["routeformer"] + list(ZOO_SPLIT))
def test_data_whole_gradients_stay_within_the_largest_unit(runs, model):
    """Under FSDP ((2, 2)) the gradients still whole over ``data`` that a
    rank holds at once, from a gradient's first arrival to its
    reduce-scatter, stay within the largest unit's, below the whole
    model's."""
    for r in runs["ranks"]:
        if model == "routeformer":
            rec = r["mesh"]["fsdp"]["reduction"]
            assert rec["largest_unit_grad"] < rec["whole_grad"], rec
        else:
            rec = r["units"]["fsdp"]["zoo_split"][(model, 0.0)]
        assert 0 < rec["grad_high_water"] <= rec["largest_unit_grad"], (r["rank"], rec)


def test_split_fedformer_fourier_matches_jax_grad(runs):
    """The FEDformer Fourier backbone split on the (2, 2) FSDP mesh, the
    JAX model's weights carried by ``load_flax_params``: every gradient,
    gathered whole, within 1e-5 of the largest of ``jax.grad``'s (the key
    and value projections, which the Fourier blocks do not read, 0 on both
    sides)."""
    want = runs["fed_jax"]
    for r in runs["ranks"]:
        rec = r["fed_jax"]
        kinds = set(rec["kinds"])
        assert {("Linear", "row"), ("Linear", "column"), ("Conv1d", "row")} <= kinds, kinds
        assert set(rec["grads"]) == set(want)
        scale = max(np.abs(g).max() for g in want.values())
        for k, g in want.items():
            assert np.abs(rec["grads"][k] - g).max() <= 1e-5 * scale, (r["rank"], k)
