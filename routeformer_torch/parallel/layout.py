"""Parameter and AdamW bytes per rank under the structural rule, for the
driver's flagship at full width (built on the meta device, no weights).

    python -m routeformer_torch.parallel.layout [n_data n_model]

For each model: the parameters' f32 bytes whole, and on the ``(n_data,
n_model)`` mesh (default ``(2, 2)``) the bytes one rank stores of the
parameters and of AdamW's two moments, without and with FSDP, at
``min_shard_dim=512`` (``mesh.module_specs``: the rule on the JAX
package's layout); beside them the whole weights a rank holds gathered at
once while the model steps: the largest gather unit's
(``largest_unit_gathered_bytes``; ``MeshParams`` gathers one unit at a
time), against all the sharded weights whole (``sharded_whole_bytes``,
what a whole-model gather would hold).
"""

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
                       min_shard_dim: int = 512) -> int:
    """Bytes of the whole weights one rank holds gathered at once while the
    largest gather unit of ``module`` runs (``mesh.gather_units``, the
    resident units' weights included), on the ``(n_data, n_model)`` mesh."""
    from routeformer_torch.parallel.mesh import (
        gather_units,
        module_specs,
        resident_units,
        unit_gather_bytes,
    )

    specs = module_specs(module, n_model, min_shard_dim, n_data if fsdp else 1)
    sharded = {p for name, p in module.named_parameters() if specs[name]}
    units = gather_units(module, sharded)
    return max(unit_gather_bytes(units, resident_units(module, units)).values(), default=0)


def sharded_whole_bytes(module, n_data: int, n_model: int, fsdp: bool,
                        min_shard_dim: int = 512) -> int:
    """Bytes of every sharded parameter of ``module`` whole."""
    from routeformer_torch.parallel.mesh import module_specs

    specs = module_specs(module, n_model, min_shard_dim, n_data if fsdp else 1)
    return sum(p.numel() * p.element_size() for name, p in module.named_parameters()
               if specs[name])


def flagships() -> dict:
    """The driver's flagship on the meta device (the serving flagship of
    ``flagship.py`` has the same parameters: only its gelu differs)."""
    from routeformer_torch.experiments import full_comparison as fc
    from routeformer_torch.models import Routeformer

    s = fc.Settings.from_env({"DATASET": "GEM", "MODEL_SET": "flagship"})
    config = fc.driver_configs(s)[fc.MODELS[fc.FLAGSHIP][3]]
    with torch.device("meta"):
        return {fc.FLAGSHIP: Routeformer(config)}


def table(n_data: int = 2, n_model: int = 2) -> dict:
    out = {}
    for name, model in flagships().items():
        whole = sum(p.numel() * 4 for p in model.parameters())
        row = {"params_bytes": whole}
        for fsdp in (False, True):
            key = "fsdp" if fsdp else "no_fsdp"
            b = rank_bytes(model, n_data, n_model, fsdp)
            row[key] = {"params_bytes_per_rank": b, "adam_bytes_per_rank": 2 * b,
                        "share_of_whole": b / whole,
                        "largest_unit_gathered_bytes": largest_unit_bytes(
                            model, n_data, n_model, fsdp),
                        "sharded_whole_bytes": sharded_whole_bytes(model, n_data, n_model, fsdp)}
        out[name] = row
    return out


if __name__ == "__main__":
    shape = tuple(int(a) for a in sys.argv[1:3]) if len(sys.argv) > 2 else (2, 2)
    print(json.dumps({"mesh": list(shape), "min_shard_dim": 512, **table(*shape)}, indent=1))
