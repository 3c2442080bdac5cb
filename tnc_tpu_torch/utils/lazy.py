"""Package exports resolved on first use.

A package whose exported names live in modules that import torch (or
much else) lists them in a table and sets ``__getattr__ =
lazy_getattr(__name__, table)``. ``from package import name`` then imports
the defining module only when the name is asked for, so a process that
imports one light submodule of the package (a spawn worker of the
planner, the benchmark CLI's host-only sweep) pulls in no torch.
"""

from __future__ import annotations

import importlib


def lazy_getattr(package: str, table: dict[str, str | None]):
    """A module ``__getattr__`` for ``package``: ``table`` maps each
    exported name to the module that defines it, or to ``None`` for the
    package's submodule of that name.

    >>> get = lazy_getattr("tnc_tpu_torch.utils", {
    ...     "UnionFind": "tnc_tpu_torch.utils.datastructures", "datastructures": None})
    >>> get("UnionFind").__name__, get("datastructures").__name__
    ('UnionFind', 'tnc_tpu_torch.utils.datastructures')
    """

    def __getattr__(name: str):
        if name not in table:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        module = table[name]
        if module is None:
            return importlib.import_module(f"{package}.{name}")
        return getattr(importlib.import_module(module), name)

    return __getattr__
