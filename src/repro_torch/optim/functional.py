"""Functional optimizer cores: ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)`` pairs.

Counterpart of ``repro/optim/functional.py`` for SGD, Adam/AdamW and
Adafactor, with the same update math and the same state layout.  "Trees" here are
a tensor, or a list, tuple or dict of them (the reference's pytrees).

**Foreach variants**: ``sgd_update_foreach`` / ``adam_update_foreach``
flatten the parameter list once, bucket leaves by dtype, and apply the
update math to one concatenated raveled buffer per bucket, then split
back — identical math (elementwise, so concatenation is exact) and the
per-leaf state structure.  They are plain torch ops: the reference's
foreach step is its own XLA program, and ``torch._foreach_*`` is a
library kernel, so neither is used.  Adafactor's factored second moment
is not elementwise over a concatenated buffer, so its foreach step is
its per-leaf update over the whole list, as in the reference.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch


def tree_map(f, *trees):
    """``f`` over the leaves (tensors) of lists / tuples / dicts."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(f, *[t[k] for t in trees]) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(f, *xs) for xs in zip(*trees))
    return f(*trees)


def tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


# ----------------------------------------------------------------------
# SGD
# ----------------------------------------------------------------------

def sgd_init(params, momentum: float = 0.0, **_):
    if momentum == 0.0:
        return {}
    return {"momentum": tree_map(torch.zeros_like, params)}


def sgd_update(grads, state, params, *, lr: float, momentum: float = 0.0,
               weight_decay: float = 0.0, nesterov: bool = False,
               dampening: float = 0.0, **_):
    if weight_decay:
        grads = tree_map(lambda g, p: g + weight_decay * p, grads, params)
    if momentum:
        buf = tree_map(
            lambda m, g: momentum * m + (1 - dampening) * g,
            state["momentum"], grads)
        if nesterov:
            grads = tree_map(lambda g, m: g + momentum * m, grads, buf)
        else:
            grads = buf
        state = {"momentum": buf}
    updates = tree_map(lambda g: -lr * g, grads)
    return updates, state


# ----------------------------------------------------------------------
# Adam / AdamW
# ----------------------------------------------------------------------

def adam_init(params, state_dtype=None, **_):
    leaves = tree_leaves(params)

    def z(p):
        return torch.zeros(p.shape, dtype=state_dtype or p.dtype,
                           device=p.device)

    return {
        "m": tree_map(z, params),
        "v": tree_map(z, params),
        "step": torch.zeros((), dtype=torch.int32,
                            device=leaves[0].device),
    }


def adam_update(grads, state, params, *, lr: float, betas=(0.9, 0.999),
                eps: float = 1e-8, weight_decay: float = 0.0,
                decoupled: bool = True, state_dtype=None, **_):
    b1, b2 = betas
    step = state["step"] + 1
    stepf = step.float()

    if weight_decay and not decoupled:  # classic Adam (L2 into grad)
        grads = tree_map(lambda g, p: g + weight_decay * p, grads, params)

    def upd_m(m, g):
        return (b1 * m.to(g.dtype) + (1 - b1) * g).to(m.dtype)

    def upd_v(v, g):
        g32 = g.float()
        return (b2 * v.float() + (1 - b2) * torch.square(g32)).to(v.dtype)

    m = tree_map(upd_m, state["m"], grads)
    v = tree_map(upd_v, state["v"], grads)
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf

    def upd(p, mm, vv):
        mhat = mm.float() / bc1
        vhat = vv.float() / bc2
        u = -lr * mhat / (torch.sqrt(vhat) + eps)
        if weight_decay and decoupled:  # AdamW
            u = u - lr * weight_decay * p.float()
        return u.to(p.dtype)

    updates = tree_map(upd, params, m, v)
    return updates, {"m": m, "v": v, "step": step}


# ----------------------------------------------------------------------
# Adafactor (factored second moment)
# ----------------------------------------------------------------------

def adafactor_init(params, **_):
    def fac(p):
        if p.dim() >= 2:
            return {"row": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                       device=p.device),
                    "col": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                       dtype=torch.float32,
                                       device=p.device)}
        return {"v": torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)}

    return {"fac": tree_map(fac, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device)}


def _map_up_to(f, grads, params, fac):
    """``f(g, p, f_leaf) -> (update, new_f_leaf)`` over the leaves of
    ``grads``, with ``fac`` read at the same positions (each of its
    leaves a dict of factors: the reference's ``flatten_up_to``).
    Returns (updates tree, new fac tree)."""
    if isinstance(grads, dict):
        pairs = {k: _map_up_to(f, grads[k], params[k], fac[k])
                 for k in grads}
        return ({k: u for k, (u, _) in pairs.items()},
                {k: n for k, (_, n) in pairs.items()})
    if isinstance(grads, (list, tuple)):
        pairs = [_map_up_to(f, g, p, s)
                 for g, p, s in zip(grads, params, fac)]
        return (type(grads)(u for u, _ in pairs),
                type(grads)(n for _, n in pairs))
    return f(grads, params, fac)


class LeafMeans:
    """The means Adafactor takes over a leaf: ``mean(x, dim, pdim)``
    over dimension ``dim`` of ``x`` (the leaf's squared gradient, or its
    ``row`` factor), which runs along the leaf's dimension ``pdim``
    (``row``: -1, ``col`` and ``row_mean``: -2), and ``mean_all(x)`` over
    every element (the RMS clip).  This one takes them over ``x`` itself:
    a leaf held whole.  The meshed train step passes, per leaf, one that
    completes a piece's sums over the ranks that split the leaf
    (``launch.train``)."""

    def mean(self, x: torch.Tensor, dim: int, pdim: int,
             keepdim: bool = False) -> torch.Tensor:
        return x.mean(dim=dim, keepdim=keepdim)

    def mean_all(self, x: torch.Tensor) -> torch.Tensor:
        return torch.mean(x)


WHOLE = LeafMeans()


def adafactor_update(grads, state, params, *, lr: float,
                     decay: float = 0.8, eps: float = 1e-30,
                     clip_threshold: float = 1.0,
                     weight_decay: float = 0.0, means=None, **_):
    """The reference's update.  ``means``: one :class:`LeafMeans` a
    leaf, in ``tree_leaves`` order (default: every leaf whole)."""
    step = state["step"] + 1
    beta2 = 1.0 - step.float() ** (-decay)
    by_leaf = iter(means) if means is not None else None

    def leaf(g, p, f):
        m = WHOLE if by_leaf is None else next(by_leaf)
        g32 = g.float()
        sq = torch.square(g32) + eps
        if g.dim() >= 2:
            row = beta2 * f["row"] + (1 - beta2) * m.mean(sq, -1, -1)
            col = beta2 * f["col"] + (1 - beta2) * m.mean(sq, -2, -2)
            row_mean = m.mean(row, -1, -2, keepdim=True)
            vhat = (row[..., :, None]
                    / torch.clamp(row_mean[..., None], min=eps)
                    ) * col[..., None, :]
            new_f = {"row": row, "col": col}
        else:
            vhat = beta2 * f["v"] + (1 - beta2) * sq
            new_f = {"v": vhat}
        u = g32 / torch.sqrt(torch.clamp(vhat, min=eps))
        # update clipping (Adafactor's RMS rule)
        rms = torch.sqrt(m.mean_all(torch.square(u)))
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        u = -lr * u
        if weight_decay:
            u = u - lr * weight_decay * p.float()
        return u.to(p.dtype), new_f

    updates, fac = _map_up_to(leaf, grads, params, state["fac"])
    return updates, {"fac": fac, "step": step}


# ----------------------------------------------------------------------
# fused multi-tensor ("foreach") updates
# ----------------------------------------------------------------------

def _bucket_by_dtype(*leaf_lists) -> List[List[int]]:
    """Group leaf indices whose participating tensors share dtypes
    (everything ravels to 1-D before concatenation)."""
    buckets: Dict[Tuple, List[int]] = {}
    for i in range(len(leaf_lists[0])):
        key = tuple(ll[i].dtype for ll in leaf_lists)
        buckets.setdefault(key, []).append(i)
    return list(buckets.values())


def _concat(leaves, idxs):
    if len(idxs) == 1:
        return leaves[idxs[0]].reshape(-1)
    return torch.cat([leaves[i].reshape(-1) for i in idxs])


def _scatter_back(buf, like_leaves, idxs, out: list) -> None:
    off = 0
    for i in idxs:
        n = like_leaves[i].numel()
        out[i] = buf[off:off + n].reshape(like_leaves[i].shape)
        off += n


def sgd_update_foreach(grads, state, params, *, lr: float,
                       momentum: float = 0.0, weight_decay: float = 0.0,
                       nesterov: bool = False, dampening: float = 0.0,
                       **_):
    """Bucketed-concat SGD over lists of tensors: exactly
    :func:`sgd_update`'s math applied to one buffer per dtype bucket."""
    flat_p, flat_g = list(params), list(grads)
    flat_m = list(state["momentum"]) if momentum else None

    n = len(flat_p)
    updates: List = [None] * n
    new_m: List = [None] * n
    lists = (flat_p, flat_g) + ((flat_m,) if momentum else ())
    for idxs in _bucket_by_dtype(*lists):
        p = _concat(flat_p, idxs)
        g = _concat(flat_g, idxs)
        if weight_decay:
            g = g + weight_decay * p
        if momentum:
            m = _concat(flat_m, idxs)
            buf = momentum * m + (1 - dampening) * g
            g = g + momentum * buf if nesterov else buf
            _scatter_back(buf, flat_p, idxs, new_m)
        _scatter_back(-lr * g, flat_p, idxs, updates)
    return updates, ({"momentum": new_m} if momentum else {})


def adam_update_foreach(grads, state, params, *, lr: float,
                        betas=(0.9, 0.999), eps: float = 1e-8,
                        weight_decay: float = 0.0, decoupled: bool = True,
                        state_dtype=None, **_):
    """Bucketed-concat Adam/AdamW: exactly :func:`adam_update`'s math per
    dtype bucket, preserving the per-leaf state structure."""
    b1, b2 = betas
    step = state["step"] + 1
    stepf = step.float()
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf

    flat_p, flat_g = list(params), list(grads)
    flat_m, flat_v = list(state["m"]), list(state["v"])

    n = len(flat_p)
    updates: List = [None] * n
    new_m: List = [None] * n
    new_v: List = [None] * n
    for idxs in _bucket_by_dtype(flat_p, flat_g, flat_m, flat_v):
        p = _concat(flat_p, idxs)
        g = _concat(flat_g, idxs)
        m = _concat(flat_m, idxs)
        v = _concat(flat_v, idxs)
        if weight_decay and not decoupled:  # classic Adam (L2 into grad)
            g = g + weight_decay * p
        g32 = g.float()
        m_new = (b1 * m.to(g.dtype) + (1 - b1) * g).to(m.dtype)
        v_new = (b2 * v.float() + (1 - b2) * torch.square(g32)).to(v.dtype)
        mhat = m_new.float() / bc1
        vhat = v_new.float() / bc2
        u = -lr * mhat / (torch.sqrt(vhat) + eps)
        if weight_decay and decoupled:  # AdamW
            u = u - lr * weight_decay * p.float()
        _scatter_back(m_new, flat_p, idxs, new_m)
        _scatter_back(v_new, flat_p, idxs, new_v)
        _scatter_back(u.to(p.dtype), flat_p, idxs, updates)
    return updates, {"m": new_m, "v": new_v, "step": step}


# Adafactor's "foreach" step is its per-leaf update over the whole list
# (its factored moments are not elementwise over a concatenated buffer)
FOREACH_UPDATES: Dict[str, Callable] = {
    "sgd": sgd_update_foreach,
    "adam": adam_update_foreach,
    "adamw": adam_update_foreach,
    "adafactor": adafactor_update,
}

_FOREACH_STEPS: Dict[Tuple, Callable] = {}


def foreach_hparams_key(algo: str, hparams: Dict) -> Optional[Tuple]:
    """Hashable cache key of a foreach step, or ``None`` when the
    hyperparameters cannot key a cache entry (unhashable values — caller
    falls back to the per-leaf path)."""
    items = []
    for k, v in hparams.items():
        if k == "lr":
            continue  # lr is passed per call (schedules mutate it)
        if isinstance(v, list):
            v = tuple(v)
        items.append((k, v))
    key = (algo, tuple(sorted(items, key=lambda kv: kv[0])))
    try:
        hash(key)
    except TypeError:
        return None
    return key


def foreach_step_fn(algo: str, key: Tuple, hparams: Dict) -> Callable:
    """``(grads, state, params, lr) -> (new_params, new_state)`` over
    lists, fused per dtype bucket; cached per (algo, hyperparams)."""
    fn = _FOREACH_STEPS.get(key)
    if fn is None:
        update = FOREACH_UPDATES[algo]
        hp = {k: v for k, v in hparams.items() if k != "lr"}

        def step(gs, st, ps, lr):
            updates, new_st = update(gs, st, ps, lr=lr, **hp)
            return [p + u for p, u in zip(ps, updates)], new_st

        fn = _FOREACH_STEPS[key] = step
    return fn


# ----------------------------------------------------------------------
# registry + helpers
# ----------------------------------------------------------------------

OPTIMIZERS: Dict[str, Tuple[Callable, Callable]] = {
    "sgd": (sgd_init, sgd_update),
    "adam": (adam_init, adam_update),
    "adamw": (adam_init, adam_update),
    "adafactor": (adafactor_init, adafactor_update),
}


def make_optimizer(name: str, foreach: bool = False, **hparams):
    """Returns (init_fn(params)->state, update_fn(grads, state, params,
    **per_call) -> (new_params, new_state)) with hyperparameters bound
    (``per_call``: arguments of one call, Adafactor's ``means``);
    ``params`` a list of tensors (or, per leaf, any tree when
    ``foreach=False``)."""
    init, _ = OPTIMIZERS[name]
    update = FOREACH_UPDATES[name] if foreach else OPTIMIZERS[name][1]
    if name == "adamw":
        hparams.setdefault("decoupled", True)
        hparams.setdefault("weight_decay", 0.01)
    if name == "adam":
        hparams.setdefault("decoupled", False)

    def init_fn(params):
        return init(params, **hparams)

    def update_fn(grads, state, params, **per_call):
        updates, new_state = update(grads, state, params, **hparams,
                                    **per_call)
        return tree_map(lambda p, u: p + u, params, updates), new_state

    return init_fn, update_fn


def global_norm(tree) -> torch.Tensor:
    """L2 norm over every leaf of a gradient tree (f32 accumulate)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """Scale the whole tree so its global norm is <= ``max_norm``;
    returns (clipped tree, pre-clip norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-6), max=1.0)
    return tree_map(lambda g: g * scale, tree), norm
