"""PCI-bucketed metric reporting (counterpart of
``routeformer_tpu/train/metrics.py``).

Per-model loss, ADE and FDE are bucketed by each sample's PCI into the
dataset's quartile buckets (<25%, 25-50%, 50-75%, 75-95%, >95%) and into
absolute PCI bins (<20i, 20-40i, 40-60i, 60-80i, >80i); each family also
reports the mean of its bucket means (``avg%``, ``avgi``). An empty bucket
reports 0. Masked reductions over f32 tensors; values are 0-d tensors.
"""

from typing import Dict

import torch

# PCI quartile cutoffs of the two datasets.
GEM_QUARTILES = {"25%": 24.84, "50%": 31.27, "75%": 41.19, "95%": 62.55}
DREYEVE_QUARTILES = {"25%": 26.79, "50%": 36.33, "75%": 50.77, "95%": 78.02}


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    count = mask.sum()
    return torch.where(count > 0, (x * mask).sum() / torch.clamp(count, min=1),
                       torch.zeros_like(count))


def quartile_buckets(pcis: torch.Tensor, quartiles: Dict[str, float]) -> dict:
    return {
        "<25%": pcis < quartiles["25%"],
        "25-50%": (pcis > quartiles["25%"]) & (pcis < quartiles["50%"]),
        "50-75%": (pcis > quartiles["50%"]) & (pcis < quartiles["75%"]),
        "75-95%": (pcis > quartiles["75%"]) & (pcis < quartiles["95%"]),
        ">95%": pcis >= quartiles["95%"],
    }


def absolute_buckets(pcis: torch.Tensor) -> dict:
    return {
        "<20i": pcis < 20,
        "20-40i": (pcis > 20) & (pcis < 40),
        "40-60i": (pcis > 40) & (pcis < 60),
        "60-80i": (pcis > 60) & (pcis < 80),
        ">80i": pcis >= 80,
    }


def report_split(prefix, metrics, buckets, losses, ades, fdes, final_suffix) -> None:
    """Masked per-bucket means and the mean of the bucket means."""
    means = {"loss": [], "ade": [], "fde": []}
    for suffix, mask in buckets.items():
        mask = mask.float()
        for name, values in (("loss", losses), ("ade", ades), ("fde", fdes)):
            value = _masked_mean(values, mask)
            means[name].append(value)
            metrics[f"{prefix}_{name}_{suffix}"] = value
    for name, values in means.items():
        metrics[f"{prefix}_{name}_{final_suffix}"] = torch.stack(values).mean()


def bucketed_eval_metrics(prefix: str, pcis, losses, ades, fdes,
                          quartiles: Dict[str, float]) -> Dict[str, torch.Tensor]:
    """The per-model eval metric dict, from per-sample ``(N,)`` values."""
    pcis, losses, ades, fdes = (torch.as_tensor(v, dtype=torch.float32)
                                for v in (pcis, losses, ades, fdes))
    metrics = {f"{prefix}_loss": losses.mean(), f"{prefix}_ade": ades.mean(),
               f"{prefix}_fde": fdes.mean()}
    report_split(prefix, metrics, quartile_buckets(pcis, quartiles), losses, ades,
                 fdes, "avg%")
    report_split(prefix, metrics, absolute_buckets(pcis), losses, ades, fdes, "avgi")
    return metrics
