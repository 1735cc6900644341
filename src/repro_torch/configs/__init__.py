"""Architecture configs the port runs: the dense h2o-danube-1.8b.

Each module exposes ``CONFIG`` (full-scale) and ``smoke_config()``
(reduced, same family).  The other architectures of the reference
package come with ROADMAP queue 1, item 10.
"""

import importlib

from repro_torch.models.config import ModelConfig

# CLI ids use dashes, as in the reference package
_ALIASES = {
    "h2o-danube-1.8b": "h2o_danube_1p8b",
}


def arch_names():
    return list(_ALIASES)


def _module(name: str):
    mod = _ALIASES.get(name)
    if mod is None:
        raise KeyError(f"unknown architecture {name!r} (the port has "
                       f"{arch_names()})")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()
