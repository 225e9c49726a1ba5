"""Base class for configuration objects (the port's copy of
``routeformer_tpu/utils/config.py``): ``get`` with a default, deep ``copy``,
``override`` (a copy with fields replaced and ``__post_init__`` re-run) and
a nested-dict view for serving bundles."""

import copy
import dataclasses
from argparse import Namespace


class BaseConfig(Namespace):
    def get(self, item, default=None):
        return getattr(self, item, default)

    def copy(self):
        return copy.deepcopy(self)

    def override(self, **kwargs):
        """A copy with ``kwargs`` set and ``__post_init__`` re-run, so the
        derived fields follow the new values."""
        out = self.copy()
        for k, v in kwargs.items():
            setattr(out, k, v)
        if hasattr(out, "__post_init__"):
            out.__post_init__()
        return out

    def to_dict(self) -> dict:
        """Nested plain dict of the dataclass fields (the bundle stores it)."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name, None)
            out[f.name] = v.to_dict() if isinstance(v, BaseConfig) else v
        return out
