"""torch.nn.Module analogue (paper §4.1: models are just Python programs).

Counterpart of ``repro/nn/module.py``.  Layers are Python classes whose
constructors create parameters and whose ``forward`` methods process
activations; Module provides the bookkeeping: named parameters/buffers,
train/eval mode, ``state_dict``/``load_state_dict`` (which also takes
numpy arrays, the form weights cross from the reference in), and
:func:`functional_call`, which runs ``forward`` with an explicit
parameter dict swapped in.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import torch.utils._pytree

from ..core.tensor import Tensor, _as_torch, _tensor_flatten, \
    _tensor_unflatten
from ..core.autograd import no_grad


class Parameter(Tensor):
    """A Tensor that is a module parameter (requires grad by default)."""

    def __init__(self, data: Any, requires_grad: bool = True):
        if isinstance(data, Tensor):
            super().__init__(data.data, requires_grad=requires_grad)
        else:
            super().__init__(data, requires_grad=requires_grad)

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()


# a Parameter flattens as a Tensor does (``named_parameters()`` passed to
# the jit bridge or ``torch.func``); it unflattens to a Tensor
torch.utils._pytree.register_pytree_node(
    Parameter, _tensor_flatten, _tensor_unflatten,
    serialized_type_name="repro_torch.nn.Parameter")


class Module:
    def __init__(self):
        object.__setattr__(self, "_parameters", OrderedDict())
        object.__setattr__(self, "_buffers", OrderedDict())
        object.__setattr__(self, "_modules", OrderedDict())
        object.__setattr__(self, "training", True)

    # -- attribute interception -----------------------------------------
    def __setattr__(self, name: str, value: Any) -> None:
        params = self.__dict__.get("_parameters")
        if params is None:
            raise RuntimeError(
                "cannot assign attributes before Module.__init__() call"
            )
        for d in (self._parameters, self._buffers, self._modules):
            d.pop(name, None)
        if isinstance(value, Parameter):
            self._parameters[name] = value
        elif isinstance(value, Module):
            self._modules[name] = value
        else:
            object.__setattr__(self, name, value)

    def __getattr__(self, name: str):
        for d in ("_parameters", "_buffers", "_modules"):
            sub = self.__dict__.get(d)
            if sub is not None and name in sub:
                return sub[name]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{name}'"
        )

    def register_buffer(self, name: str, tensor: Optional[Tensor]) -> None:
        self._buffers[name] = tensor

    def register_parameter(self, name: str, param: Optional[Parameter]) -> None:
        self._parameters[name] = param

    def add_module(self, name: str, module: "Module") -> None:
        self._modules[name] = module

    # -- iteration --------------------------------------------------------
    def named_modules(self, prefix: str = "") -> Iterator[Tuple[str, "Module"]]:
        yield prefix, self
        for name, mod in self._modules.items():
            if mod is None:
                continue
            sub = f"{prefix}.{name}" if prefix else name
            yield from mod.named_modules(sub)

    def modules(self) -> Iterator["Module"]:
        for _, m in self.named_modules():
            yield m

    def children(self) -> Iterator["Module"]:
        yield from self._modules.values()

    def named_parameters(self, prefix: str = "") -> Iterator[Tuple[str, Parameter]]:
        for mod_name, mod in self.named_modules(prefix):
            for p_name, p in mod._parameters.items():
                if p is not None:
                    full = f"{mod_name}.{p_name}" if mod_name else p_name
                    yield full, p

    def parameters(self) -> Iterator[Parameter]:
        for _, p in self.named_parameters():
            yield p

    def named_buffers(self, prefix: str = "") -> Iterator[Tuple[str, Tensor]]:
        for mod_name, mod in self.named_modules(prefix):
            for b_name, b in mod._buffers.items():
                if b is not None:
                    full = f"{mod_name}.{b_name}" if mod_name else b_name
                    yield full, b

    def buffers(self) -> Iterator[Tensor]:
        for _, b in self.named_buffers():
            yield b

    # -- state dict ---------------------------------------------------------
    def state_dict(self) -> "OrderedDict[str, Tensor]":
        out: "OrderedDict[str, Tensor]" = OrderedDict()
        for name, p in self.named_parameters():
            out[name] = p
        for name, b in self.named_buffers():
            out[name] = b
        return out

    def load_state_dict(self, state: Dict[str, Any], strict: bool = True) -> None:
        own = self.state_dict()
        missing = [k for k in own if k not in state]
        unexpected = [k for k in state if k not in own]
        if strict and (missing or unexpected):
            raise KeyError(
                f"load_state_dict mismatch: missing={missing[:5]}, "
                f"unexpected={unexpected[:5]}"
            )
        with no_grad():
            for k, v in state.items():
                if k in own:
                    data = v.data if isinstance(v, Tensor) else \
                        _as_torch(v, own[k].device)
                    own[k]._data = data.to(device=own[k].device,
                                           dtype=own[k].dtype)
                    own[k]._version.bump()

    # -- modes ---------------------------------------------------------------
    def train(self, mode: bool = True) -> "Module":
        for m in self.modules():
            object.__setattr__(m, "training", mode)
        return self

    def eval(self) -> "Module":
        return self.train(False)

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.parameters():
            p.grad = None if set_to_none else (
                None if p.grad is None else p.grad.zero_())

    def apply(self, fn: Callable[["Module"], None]) -> "Module":
        for m in self.modules():
            fn(m)
        return self

    def requires_grad_(self, flag: bool = True) -> "Module":
        for p in self.parameters():
            p.requires_grad = flag
        return self

    # -- call ------------------------------------------------------------------
    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    def __repr__(self):
        lines = [type(self).__name__ + "("]
        for name, mod in self._modules.items():
            mod_repr = repr(mod).replace("\n", "\n  ")
            lines.append(f"  ({name}): {mod_repr}")
        lines.append(")")
        return "\n".join(lines)

    def num_parameters(self) -> int:
        return sum(p.numel() for p in self.parameters())


# ----------------------------------------------------------------------
# functional bridge (module → function of an explicit parameter dict)
# ----------------------------------------------------------------------

def functional_call(module: Module,
                    params_and_buffers: Dict[str, Any],
                    *args, **kwargs):
    """Run ``module.forward`` with parameters/buffers replaced by
    ``params_and_buffers`` (name → Tensor or raw array), restoring the
    originals afterwards.
    """
    entries: List[Tuple[Dict[str, Any], str, Any, Any]] = []
    for mod_name, mod in module.named_modules():
        for store in (mod._parameters, mod._buffers):
            for local, current in store.items():
                full = f"{mod_name}.{local}" if mod_name else local
                if full in params_and_buffers:
                    new = params_and_buffers[full]
                    if not isinstance(new, Tensor):
                        new = Tensor(new)
                    entries.append((store, local, current, new))
    try:
        for store, local, _current, new in entries:
            store[local] = new
        return module.forward(*args, **kwargs)
    finally:
        for store, local, current, _new in entries:
            store[local] = current


def param_dict(module: Module, dtype=None) -> Dict[str, Tensor]:
    """Extract {name: Tensor} for all params+buffers."""
    out = {}
    for name, p in module.named_parameters():
        out[name] = p.astype(dtype) if dtype is not None else p
    for name, b in module.named_buffers():
        out[name] = b
    return out


# ----------------------------------------------------------------------
# containers
# ----------------------------------------------------------------------

class Sequential(Module):
    def __init__(self, *mods: Module):
        super().__init__()
        for i, m in enumerate(mods):
            self.add_module(str(i), m)

    def __iter__(self):
        return iter(self._modules.values())

    def __getitem__(self, idx: int) -> Module:
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)

    def append(self, mod: Module) -> "Sequential":
        self.add_module(str(len(self._modules)), mod)
        return self

    def forward(self, x):
        for m in self._modules.values():
            x = m(x)
        return x


class ModuleList(Module):
    def __init__(self, mods: Optional[List[Module]] = None):
        super().__init__()
        for i, m in enumerate(mods or []):
            self.add_module(str(i), m)

    def append(self, mod: Module) -> "ModuleList":
        self.add_module(str(len(self._modules)), mod)
        return self

    def __iter__(self):
        return iter(self._modules.values())

    def __getitem__(self, idx: Union[int, slice]):
        mods = list(self._modules.values())
        return mods[idx]

    def __len__(self):
        return len(self._modules)


class ModuleDict(Module):
    def __init__(self, mods: Optional[Dict[str, Module]] = None):
        super().__init__()
        for k, m in (mods or {}).items():
            self.add_module(k, m)

    def __getitem__(self, key: str) -> Module:
        return self._modules[key]

    def __setitem__(self, key: str, mod: Module) -> None:
        self.add_module(key, mod)

    def keys(self):
        return self._modules.keys()

    def items(self):
        return self._modules.items()

    def values(self):
        return self._modules.values()
