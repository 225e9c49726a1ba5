"""The port's device rule: CUDA unless the caller asks for something else.

Entry points (building a model, loading a serving bundle, making a batch)
take ``device=None`` and resolve it here. ``None`` means the first CUDA
device; when CUDA is asked for and absent, this raises instead of falling
back to the CPU.
"""

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was asked for (the default) but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU"
        )
    return dev
