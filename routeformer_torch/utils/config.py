"""Base class for configuration objects (the port's copy of the parts of
``routeformer_tpu/utils/config.py`` that the port uses): deep ``copy`` and
a nested-dict view for serving bundles."""

import copy
import dataclasses
from argparse import Namespace


class BaseConfig(Namespace):
    def copy(self):
        return copy.deepcopy(self)

    def to_dict(self) -> dict:
        """Nested plain dict of the dataclass fields (the bundle stores it)."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name, None)
            out[f.name] = v.to_dict() if isinstance(v, BaseConfig) else v
        return out
