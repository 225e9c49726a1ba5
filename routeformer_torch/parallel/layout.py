"""Parameter and AdamW bytes per rank under the structural rule, and what
the ``model`` axis's split leaves gathered and computed per rank, for the
driver's flagship at full width and for the Autoformer, FEDformer Fourier
and FEDformer Wavelets GPS backbones at the flagship's GPS widths (built on
the meta device, no weights).

    python -m routeformer_torch.parallel.layout [n_data n_model]

For each model: the parameters' f32 bytes whole, and on each mesh (``(2,
2)`` and ``(1, 4)`` by default, else ``(n_data, n_model)``) the bytes one
rank stores of the parameters and of AdamW's two moments, without and with
FSDP, at ``min_shard_dim=512`` (``mesh.module_specs``: the rule on the JAX
package's layout); beside them the whole weights a rank holds gathered at
once while the model steps: the largest gather unit's without the split
layers' weights (``largest_unit_gathered_bytes``; ``MeshParams`` gathers
one unit at a time and never a split weight whole) and with them
(``largest_unit_gathered_bytes_unsplit``, the per-unit gathers alone),
against all the sharded weights whole (``sharded_whole_bytes``, what a
whole-model gather would hold); the split weights' whole bytes, never
gathered (``split_whole_bytes``); and each rank's share of the model's
Linear, convolution and spectral-operator FLOPs in an eval forward at
batch 16 (the flagship on ``full_comparison``'s synthetic GEM batch, a GPS backbone
on series of its config's length; ``rank_flop_share``: a split layer's
FLOPs over ``n_model`` ranks, every layer's rows over ``n_data``; counted
by ``counting_flops`` on the meta device).
"""

import contextlib
import json
import sys

import torch


def rank_bytes(module, n_data: int, n_model: int, fsdp: bool,
               min_shard_dim: int = 512) -> int:
    """f32 bytes of ``module``'s parameters one rank stores."""
    from routeformer_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, module_specs

    specs = module_specs(module, n_model, min_shard_dim, n_data if fsdp else 1)
    total = 0
    for name, p in module.named_parameters():
        split = 1
        for axis in specs[name]:
            split *= {DATA_AXIS: n_data, MODEL_AXIS: n_model}.get(axis, 1)
        total += p.numel() * 4 // split
    return total


def largest_unit_bytes(module, n_data: int, n_model: int, fsdp: bool,
                       min_shard_dim: int = 512, split: bool = True) -> int:
    """Bytes of the whole weights one rank holds gathered at once while the
    largest gather unit of ``module`` runs (``mesh.gather_units``, the
    resident units' weights included), on the ``(n_data, n_model)`` mesh:
    the split layers' weights not counted (their ``model`` blocks where FSDP
    gathers them over ``data``) unless ``split=False``, which counts every
    sharded weight whole (the gathers before the ``model`` axis computed
    split)."""
    from routeformer_torch.parallel.mesh import (
        gather_units,
        module_specs,
        resident_units,
        split_block_bytes,
        unit_gather_bytes,
    )

    specs = module_specs(module, n_model, min_shard_dim, n_data if fsdp else 1)
    sharded = {p for name, p in module.named_parameters() if specs[name]}
    units = gather_units(module, sharded)
    blocks = split_block_bytes(module, specs, units, n_model) if split else {}
    return max(unit_gather_bytes(units, resident_units(module, units), blocks).values(),
               default=0)


def sharded_whole_bytes(module, n_data: int, n_model: int, fsdp: bool,
                        min_shard_dim: int = 512) -> int:
    """Bytes of every sharded parameter of ``module`` whole."""
    from routeformer_torch.parallel.mesh import module_specs

    specs = module_specs(module, n_model, min_shard_dim, n_data if fsdp else 1)
    return sum(p.numel() * p.element_size() for name, p in module.named_parameters()
               if specs[name])


def split_whole_bytes(module, n_data: int, n_model: int, fsdp: bool,
                      min_shard_dim: int = 512) -> int:
    """Bytes of the split layers' weights and block biases whole: what the
    ``model`` axis's split never gathers (where their units run split)."""
    from routeformer_torch.parallel.mesh import gather_units, module_specs, split_block_bytes

    specs = module_specs(module, n_model, min_shard_dim, n_data if fsdp else 1)
    units = gather_units(module, {p for name, p in module.named_parameters() if specs[name]})
    return sum(p.numel() * p.element_size()
               for p in split_block_bytes(module, specs, units, n_model))


@contextlib.contextmanager
def counting_flops(model, names=None):
    """Yields ``{layer name: FLOPs}``, filled while the body runs: the
    matmul and convolution FLOPs (``torch.utils.flop_counter``'s formulas)
    spent in the forward calls of each ``nn.Conv2d`` and each layer the
    ``model`` axis can split (``mesh.split_weights``: ``nn.Linear``,
    ``nn.Conv1d``, ``SparseKernelFT1d``) of ``model`` (those in ``names``,
    else every one). A backward runs
    outside the layers' calls and is not counted."""
    import torch.nn as nn
    from torch.utils._python_dispatch import TorchDispatchMode

    from routeformer_torch.parallel.mesh import split_weights
    from torch.utils.flop_counter import flop_registry

    counts, current, handles = {}, [], []

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            count = flop_registry.get(func._overloadpacket)
            if count is not None and current and current[-1] is not None:
                counts[current[-1]] += int(count(*args, **kwargs, out_val=out))
            return out

    def enter(name):
        def hook(*_):
            current.append(name)
        return hook

    def leave(*_):
        current.pop()

    for name, m in model.named_modules():
        if isinstance(m, nn.Conv2d) or split_weights(m) is not None:
            mine = name if names is None or name in names else None
            if mine is not None:
                counts[mine] = 0
            handles += [m.register_forward_pre_hook(enter(mine)),
                        m.register_forward_hook(leave, always_call=True)]
    try:
        with Mode():
            yield counts
    finally:
        for h in handles:
            h.remove()


def layer_flops(model, batch_size: int = 16) -> dict:
    """``{layer name: FLOPs}`` of every ``nn.Linear`` and ``nn.Conv1d/2d``
    of ``model`` (on the meta device) in one eval forward of a batch of
    ``batch_size`` at the driver's synthetic GEM shapes (its ``Settings``,
    frames (54, 96))."""
    from routeformer_torch.experiments import full_comparison as fc
    from routeformer_torch.io.synthetic import synthetic_batch_numpy

    s = fc.Settings.from_env({"DATASET": "GEM", "MODEL_SET": "flagship"})
    cfg = model.configs
    shapes = synthetic_batch_numpy(0, 1, seq_len=s.seq_len, pred_len=s.pred_len,
                                   fps=s.output_fps, with_video=cfg.with_video,
                                   with_gaze=cfg.with_gaze, frame_hw=(54, 96))["train"]
    batch = {k: torch.empty((batch_size,) + v.shape[1:], device="meta")
             for k, v in shapes.items()}
    model = model.to("meta").eval()  # the buffers built from numpy too
    with torch.no_grad(), counting_flops(model) as counts:
        model(batch)
    return counts


def rank_flop_share(module, flops: dict, n_data: int, n_model: int, fsdp: bool,
                    min_shard_dim: int = 512) -> float:
    """One rank's share of ``flops`` (``layer_flops``): each layer's rows
    over the ``n_data`` data shards, a split layer's products over the
    ``n_model`` model ranks too."""
    from routeformer_torch.parallel.mesh import (
        gather_units,
        module_specs,
        split_block_bytes,
        split_weights,
    )

    specs = module_specs(module, n_model, min_shard_dim, n_data if fsdp else 1)
    units = gather_units(module, {p for name, p in module.named_parameters() if specs[name]})
    split = {id(p) for p in split_block_bytes(module, specs, units, n_model)}
    modules = dict(module.named_modules())

    def is_split(m):
        found = split_weights(m)
        return found is not None and id(getattr(m, found[0][0])) in split

    mine = sum(f / n_data / (n_model if is_split(modules[n]) else 1) for n, f in flops.items())
    return mine / sum(flops.values())


def flagships() -> dict:
    """The driver's flagship on the meta device (the serving flagship of
    ``flagship.py`` has the same parameters: only its gelu differs)."""
    from routeformer_torch.experiments import full_comparison as fc
    from routeformer_torch.models import Routeformer

    s = fc.Settings.from_env({"DATASET": "GEM", "MODEL_SET": "flagship"})
    config = fc.driver_configs(s)[fc.MODELS[fc.FLAGSHIP][3]]
    with torch.device("meta"):
        return {fc.FLAGSHIP: Routeformer(config)}


# The GPS backbones whose layers split since the Autoformer layers left the
# whole-weight units (``flagship.GPS_VARIANTS``).
ZOO_GPS = ("Autoformer", "FEDformer-Fourier", "FEDformer-Wavelets")


def gps_backbones() -> dict:
    """``{name: (backbone, its config)}``: ``ZOO_GPS`` at the flagship's
    GPS widths (d832, 8 heads, e6/d1, d_ff 3328; FEDformer's 32 modes,
    the Wavelets blocks' c 128, k 8) on the meta device."""
    from routeformer_torch.flagship import GPS_VARIANTS, variant_config

    out = {}
    for name in ZOO_GPS:
        cfg = variant_config(gps=name).gps_backbone_config
        with torch.device("meta"):
            out[name] = (GPS_VARIANTS[name][0](cfg), cfg)
    return out


def gps_layer_flops(model, cfg, batch_size: int = 16) -> dict:
    """``{layer name: FLOPs}`` of a GPS backbone's Linear, convolution and
    spectral layers (``counting_flops``) in one eval forward of a batch of
    ``batch_size`` series of the config's length and channels (on the meta
    device)."""
    x = torch.empty(batch_size, cfg.seq_len, cfg.enc_in, device="meta")
    model = model.to("meta").eval()  # the buffers built from numpy too
    with torch.no_grad(), counting_flops(model) as counts:
        model(x)
    return counts


MESHES = ((2, 2), (1, 4))


def table(meshes=MESHES) -> dict:
    models = {name: (model, layer_flops(model)) for name, model in flagships().items()}
    models.update({name: (model, gps_layer_flops(model, cfg))
                   for name, (model, cfg) in gps_backbones().items()})
    out = {}
    for name, (model, flops) in models.items():
        whole = sum(p.numel() * 4 for p in model.parameters())
        row = {"params_bytes": whole, "linear_conv_flops_batch16": sum(flops.values())}
        for n_data, n_model in meshes:
            for fsdp in (False, True):
                key = f"{n_data}x{n_model}" + ("_fsdp" if fsdp else "")
                b = rank_bytes(model, n_data, n_model, fsdp)
                row[key] = {
                    "params_bytes_per_rank": b, "adam_bytes_per_rank": 2 * b,
                    "share_of_whole": b / whole,
                    "largest_unit_gathered_bytes": largest_unit_bytes(
                        model, n_data, n_model, fsdp),
                    "largest_unit_gathered_bytes_unsplit": largest_unit_bytes(
                        model, n_data, n_model, fsdp, split=False),
                    "sharded_whole_bytes": sharded_whole_bytes(model, n_data, n_model, fsdp),
                    "split_whole_bytes": split_whole_bytes(model, n_data, n_model, fsdp),
                    "rank_flop_share": rank_flop_share(model, flops, n_data, n_model, fsdp)}
        out[name] = row
    return out


if __name__ == "__main__":
    meshes = ((int(sys.argv[1]), int(sys.argv[2])),) if len(sys.argv) > 2 else MESHES
    print(json.dumps({"meshes": [list(m) for m in meshes], "min_shard_dim": 512,
                      **table(meshes)}, indent=1))
