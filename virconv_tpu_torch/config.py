"""Attribute-access config nodes and the shipped configurations.

The JAX package loads its configs from YAML. The port ships the three
published ones as Python dicts (``configs/virconv_t.py``,
``configs/virconv_l.py``, ``configs/virconv_s.py``), so it needs no YAML
parser: ``merge_new_config``
merges a dict over a config and ``cfg_from_list`` applies the CLI's
``--set KEY VALUE`` overrides with a literal parser of its own.
"""

from __future__ import annotations

import ast
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


def virconv_t_config() -> CfgNode:
    """A fresh copy of the VirConv-T config (CLASS_NAMES, DATA_CONFIG,
    MODEL, OPTIMIZATION)."""
    from .configs.virconv_t import VIRCONV_T
    return CfgNode(copy.deepcopy(VIRCONV_T))


def virconv_l_config() -> CfgNode:
    """A fresh copy of the VirConv-L config."""
    from .configs.virconv_l import VIRCONV_L
    return CfgNode(copy.deepcopy(VIRCONV_L))


def virconv_s_config() -> CfgNode:
    """A fresh copy of the VirConv-S config (VirConv-T on the semi
    dataset)."""
    from .configs.virconv_s import VIRCONV_S
    return CfgNode(copy.deepcopy(VIRCONV_S))


# the shipped configurations by the name the command lines take
CONFIGS = {'virconv_t': virconv_t_config, 'virconv_l': virconv_l_config,
           'virconv_s': virconv_s_config}


def merge_new_config(config, new_config):
    """Recursively merge ``new_config`` into ``config`` (in place); the new
    keys win."""
    for key, val in new_config.items():
        if isinstance(val, Mapping):
            if not isinstance(config.get(key), Mapping):
                config[key] = CfgNode()
            merge_new_config(config[key], val)
        else:
            config[key] = val
    return config


_WORDS = {'true': True, 'false': False, 'null': None, 'none': None,
          '~': None}


def parse_value(text: str):
    """A ``--set`` value as YAML would read the usual cases: numbers,
    booleans, null, and ``[...]`` / ``{...}`` literals; anything else is
    the string itself."""
    word = text.strip()
    if word.lower() in _WORDS:
        return _WORDS[word.lower()]
    try:
        return ast.literal_eval(word)
    except (ValueError, SyntaxError):
        return text


def cfg_from_list(cfg_list, config):
    """Apply dotted-path overrides, e.g. ``['DATA_CONFIG.DATA_PATH',
    '/data/kitti']``. A key must exist, and a scalar keeps its type."""
    if len(cfg_list) % 2:
        raise ValueError('override list must be key/value pairs')
    for full_key, text in zip(cfg_list[0::2], cfg_list[1::2]):
        *parents, key = full_key.split('.')
        d = config
        for sub in parents:
            if sub not in d:
                raise KeyError(f'unknown config key: {full_key}')
            d = d[sub]
        value = parse_value(text)
        old = d.get(key)
        if isinstance(old, (int, float, str)) \
                and not isinstance(value, type(old)):
            raise TypeError(f'type mismatch for {full_key}: {value!r} is '
                            f'not a {type(old).__name__}')
        d[key] = value
    return config
