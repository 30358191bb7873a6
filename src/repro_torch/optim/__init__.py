"""repro_torch.optim — torch.optim-shaped optimizers (counterpart of
``repro.optim``).

An Optimizer is a plain object holding references to parameters;
``step()`` replaces their data under ``no_grad`` and bumps their
version counters.  The math lives in ``optim.functional``.  The update
works on the parameters' raw torch data, so it records no tape node and
enqueues nothing in the fusion queue.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List

import torch

from ..core import dispatch as _dispatch
from ..core.autograd import no_grad, op_range
from . import functional as OF
from .functional import clip_by_global_norm, global_norm, make_optimizer

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "Adafactor",
           "clip_by_global_norm", "cosine_schedule", "global_norm",
           "make_optimizer"]


class Optimizer:
    """Base optimizer with param groups, mirroring torch.optim.Optimizer.

    ``foreach=True`` (the default, torch's multi-tensor path) replaces the
    per-parameter update loop with one fused step per param group:
    leaves are bucketed by dtype, concatenated, updated together, and
    split back — identical math and state layout, but O(1) Python work
    per group instead of O(params).  Unhashable hyperparameters take the
    per-leaf path with a warning counter instead of raising.
    """

    def __init__(self, params, defaults: Dict[str, Any], algo: str,
                 foreach: bool = True):
        self.defaults = defaults
        self.algo = algo
        self.foreach = foreach
        params = list(params)
        if not params:
            raise ValueError("optimizer got an empty parameter list")
        if isinstance(params[0], dict):
            self.param_groups = [dict(defaults, **g) for g in params]
        else:
            self.param_groups = [dict(defaults, params=params)]
        self.state: Dict[int, Dict[str, Any]] = {}
        # host-side per-param step counts: lets the foreach path group
        # params by step (staggered grads) without device syncs per step
        self._foreach_steps: Dict[int, int] = {}
        init, self._update = OF.OPTIMIZERS[algo]
        self._init = init

    def zero_grad(self, set_to_none: bool = True) -> None:
        for group in self.param_groups:
            for p in group["params"]:
                p.grad = None

    @no_grad()
    def step(self) -> None:
        with op_range("optimizer.step"):
            self._step()

    def _step(self) -> None:
        for group in self.param_groups:
            hp = {k: v for k, v in group.items() if k != "params"}
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            if self.foreach and self._step_foreach(ps, hp):
                continue
            for p in ps:
                st = self.state.get(id(p))
                if st is None:
                    st = self._init(p.data, **hp)
                g = p.grad.data
                updates, new_state = self._update(g, st, p.data, **hp)
                self.state[id(p)] = new_state
                if id(p) in self._foreach_steps:
                    self._foreach_steps[id(p)] += 1
                p._data = p.data + updates
                p._version.bump()

    # -- fused multi-tensor step ----------------------------------------
    def _step_foreach(self, ps: List[Any], hp: Dict[str, Any]) -> bool:
        """One fused update per step-group.  Params are grouped by their
        per-leaf step count (staggered grads — e.g. a param frozen for a
        while — must keep the bias correction the per-leaf reference
        would use).  Returns False (caller takes the per-leaf path) when
        the hyperparameters can't key the step cache."""
        key = OF.foreach_hparams_key(self.algo, hp)
        if key is None:
            _dispatch.dispatch_cache().stats.num_fallback_unhashable += 1
            return False

        states = []
        for p in ps:
            st = self.state.get(id(p))
            if st is None:
                st = self._init(p.data, **hp)
                self.state[id(p)] = st
            states.append(st)

        stepped = "step" in states[0]
        if stepped:
            groups: Dict[int, List[int]] = {}
            for i, (p, st) in enumerate(zip(ps, states)):
                c = self._foreach_steps.get(id(p))
                if c is None:
                    c = self._foreach_steps[id(p)] = int(st["step"])
                groups.setdefault(c, []).append(i)
        else:
            groups = {0: list(range(len(ps)))}

        step_fn = OF.foreach_step_fn(self.algo, key, hp)
        for idxs in groups.values():
            g_ps = [ps[i] for i in idxs]
            g_states = [states[i] for i in idxs]
            # per-param state dicts <-> one list-structured state
            # (state_dict stays per-param)
            combined: Dict[str, Any] = {}
            for k in g_states[0]:
                combined[k] = (g_states[0][k] if k == "step"
                               else [s[k] for s in g_states])
            new_ps, new_st = step_fn(
                [p.grad.data for p in g_ps], combined,
                [p.data for p in g_ps], hp.get("lr", 1e-3))
            for i, p in enumerate(g_ps):
                self.state[id(p)] = {k: (v if k == "step" else v[i])
                                     for k, v in new_st.items()}
                if stepped:
                    self._foreach_steps[id(p)] += 1
                p._data = new_ps[i]
                p._version.bump()
        return True

    def state_dict(self) -> Dict[str, Any]:
        # params indexed positionally across groups for serialization
        packed = []
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state.get(id(p))
                packed.append(dict(st) if st is not None else None)
        return {"state": packed,
                "param_groups": [
                    {k: v for k, v in g.items() if k != "params"}
                    for g in self.param_groups]}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self._foreach_steps.clear()  # resync from restored state
        packed = sd["state"]
        idx = 0
        for group in self.param_groups:
            for p in group["params"]:
                if idx < len(packed) and packed[idx] is not None:
                    self.state[id(p)] = packed[idx]
                idx += 1


class SGD(Optimizer):
    """SGD with momentum/Nesterov/weight decay (torch.optim.SGD);
    ``foreach=True`` (default) runs one fused update over dtype-bucketed
    concatenated leaves instead of a per-parameter loop."""

    def __init__(self, params, lr: float = 1e-3, momentum: float = 0.0,
                 weight_decay: float = 0.0, nesterov: bool = False,
                 dampening: float = 0.0, foreach: bool = True):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      weight_decay=weight_decay,
                                      nesterov=nesterov,
                                      dampening=dampening), "sgd",
                         foreach=foreach)


class Adam(Optimizer):
    """Adam with COUPLED (L2) weight decay (torch.optim.Adam);
    ``foreach=True`` fuses the update across parameters."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 foreach: bool = True):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay,
                                      decoupled=False), "adam",
                         foreach=foreach)


class AdamW(Optimizer):
    """Adam with DECOUPLED weight decay (torch.optim.AdamW);
    ``state_dtype`` stores moments in a reduced precision."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.01,
                 state_dtype=None, foreach: bool = True):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay,
                                      decoupled=True,
                                      state_dtype=state_dtype), "adamw",
                         foreach=foreach)


class Adafactor(Optimizer):
    """Memory-factored Adam variant: second moments stored as row/col
    factors for 2-D parameters (sublinear optimizer state)."""

    def __init__(self, params, lr: float = 1e-2, decay: float = 0.8,
                 clip_threshold: float = 1.0, weight_decay: float = 0.0,
                 foreach: bool = True):
        super().__init__(params, dict(lr=lr, decay=decay,
                                      clip_threshold=clip_threshold,
                                      weight_decay=weight_decay),
                         "adafactor", foreach=foreach)


# -- LR schedules -------------------------------------------------------

def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1) -> Callable[[Any], Any]:
    """Linear warmup then cosine decay to ``min_ratio * base_lr``;
    returns a ``step -> lr`` function giving a 0-d fp32 tensor, computed
    in fp32 as the reference's is."""
    def f(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup_steps, 1)
        progress = (step - warmup_steps) / max(total_steps - warmup_steps,
                                               1)
        progress = torch.clamp(progress, 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (
            1 + torch.cos(math.pi * progress))
        return torch.where(step < warmup_steps, warm, base_lr * cos)

    return f
