"""Attribute-access config nodes: the reference reads its configuration
(``port_bench/configs/<name>.json``) as nested ``CfgNode``s."""

from __future__ import annotations

import copy
from collections.abc import Mapping


class CfgNode(dict):
    """A dict with attribute access, recursively converting nested dicts."""

    def __init__(self, d=None):
        super().__init__()
        if d:
            for k, v in d.items():
                self[k] = self._convert(v)

    @classmethod
    def _convert(cls, v):
        if isinstance(v, CfgNode):
            return v
        if isinstance(v, Mapping):
            return cls(dict(v))
        if isinstance(v, (list, tuple)):
            return [cls._convert(x) for x in v]
        return v

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = self._convert(value)

    def __setitem__(self, name, value):
        super().__setitem__(name, self._convert(value))

    def __deepcopy__(self, memo):
        out = CfgNode()
        for k, v in self.items():
            dict.__setitem__(out, k, copy.deepcopy(v, memo))
        return out
