"""Alias for the ``repro_torch.core.tensor`` *module* (the package
attribute is shadowed by the ``tensor()`` factory re-export)."""
import importlib as _importlib
import sys as _sys

_sys.modules[__name__] = _importlib.import_module("repro_torch.core.tensor")
