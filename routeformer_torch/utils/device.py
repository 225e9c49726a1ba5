"""The port's device rule: CUDA unless the caller asks for something else.

Entry points (building a model, loading a serving bundle, making a batch)
take ``device=None`` and resolve it here. ``None`` means the first CUDA
device; when CUDA is asked for and absent, this raises instead of falling
back to the CPU. Under an initialised process group (one rank per card)
``None`` and ``"cuda"`` mean this rank's card, ``cuda:{LOCAL_RANK}``, made
the current device, so no rank lands on another rank's card.
"""

import contextlib
import os
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (this rank's card under a process group);
    raise if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was asked for (the default) but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU"
        )
    if dev.type == "cuda" and dev.index is None and _process_group():
        local = int(os.environ.get("LOCAL_RANK", "0"))
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local}: only {torch.cuda.device_count()} "
                               "CUDA devices are visible")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    return dev


def _process_group() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


@contextlib.contextmanager
def init_on_cpu():
    """Modules built under this context allocate their parameters on the
    CPU (the JAX package builds on the host CPU, then moves the weights in
    one transfer); move them with ``.to(device)`` afterwards."""
    with torch.device("cpu"):
        yield
