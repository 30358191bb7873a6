"""The pure functions of the port's meshed steps against the JAX
package's, and the decode kernel's log-sum-exp output.

  * ``act_sharding.spec_for`` is the spec the reference's ``constrain``
    applies (recorded by monkeypatching ``repro.distributed.
    act_sharding._apply`` inside the test, the reference's scope opened
    on a ``RefMesh``), for every kind over a grid of shapes, heads and
    experts, on the five meshes of ``tests/test_torch_sharding.py``,
    without a switch and under each of ``REPRO_SEQ_SHARD=1`` and
    ``REPRO_ATTN_FALLBACK`` (``replicate``, and a value that applies
    nothing);
  * ``constrain`` is the identity outside a scope and in a scope over a
    mesh shape (no ranks);
  * ``launch.train.opt_state_specs`` equals the reference's for AdamW,
    SGD with momentum and Adafactor over the ten configs and the five
    meshes, both given the port's per-layer parameter tree and specs;
  * ``lm.abstract_cache`` has the reference's shapes and dtypes (its
    stack axis dropped), on the meta device.

The decode kernel's log-sum-exp output is tested in
``tests/test_torch_decode_lse.py``.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.distributed import act_sharding as JAS
from repro.models import lm as JLM
from repro.optim.functional import make_optimizer as jmake_optimizer
from repro_torch import configs as tconfigs
from repro_torch.distributed import act_sharding as AS
from repro_torch.distributed import sharding as TS
from repro_torch.launch import train as T
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import lm as TLM
from repro_torch.optim.functional import make_optimizer

MESHES = {
    "1x1": MeshShape(("data", "model"), (1, 1)),
    "2x4": MeshShape(("data", "model"), (2, 4)),
    "4x2": MeshShape(("data", "model"), (4, 2)),
    "16x16": MeshShape(("data", "model"), (16, 16)),
    "2x16x16": MeshShape(("pod", "data", "model"), (2, 16, 16)),
}
SWITCHES = {"none": {}, "seq_shard": {"REPRO_SEQ_SHARD": "1"},
            "replicate": {"REPRO_ATTN_FALLBACK": "replicate"},
            "no_fallback": {"REPRO_ATTN_FALLBACK": "off"}}


class RefMesh:
    """What the reference's scope reads of a ``jax.sharding.Mesh``."""

    def __init__(self, mesh: MeshShape):
        self.axis_names = mesh.axis_names
        self.shape = dict(mesh.shape)


class Shaped:
    """A stand-in tensor: the reference's ``constrain`` reads its shape."""

    def __init__(self, shape):
        self.shape = tuple(shape)


def _norm(spec):
    if spec is None:
        return None
    return tuple(None if e is None else
                 (tuple(e) if isinstance(e, (tuple, list)) else (e,))
                 for e in spec)


def _cases():
    """(kind, shape, heads, experts) over the grid of the test."""
    out = []
    for b, s in itertools.product((1, 2, 32, 64), (16, 24, 48)):
        out += [("btd", (b, s, 64), None, None)]
        out += [("btf", (b, s, f), None, None) for f in (128, 96, 100)]
        out += [("logits", (b, s, v), None, None) for v in (256, 97)]
        for h, heads in ((4, None), (3, None), (1, None), (56, None),
                         (32, 8), (32, 7)):
            out.append(("bhsd", (b, h, s, 16), heads, None))
    for e, c, d in itertools.product((8, 60, 16), (5, 32), (64, 100)):
        for experts in (None, 64):
            out += [(k, (e, c, d), None, experts) for k in ("ecd", "ecf")]
            out += [(k, (g, e, c, d), None, experts)
                    for k in ("gecd", "gecf") for g in (1, 2, 32, 64)]
    out.append(("unknown", (2, 2), None, None))
    return out


@pytest.mark.parametrize("switch", sorted(SWITCHES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_spec_for_is_the_reference_choice(mesh, switch, monkeypatch):
    for k, v in SWITCHES[switch].items():
        monkeypatch.setenv(k, v)
    seen = []
    monkeypatch.setattr(JAS, "_apply",
                        lambda x, spec: seen.append(spec) or x)
    scope = AS._Scope(MESHES[mesh])
    for kind, shape, heads, experts in _cases():
        seen.clear()
        with JAS.scope(RefMesh(MESHES[mesh])):
            JAS.constrain(Shaped(shape), kind, heads=heads,
                          experts=experts)
        want = _norm(seen[0]) if seen else None
        got = _norm(AS.spec_for(kind, shape, scope, heads=heads,
                                experts=experts))
        assert got == want, (kind, shape, heads, experts)


def test_constrain_is_the_identity_without_ranks():
    x = torch.randn(4, 8, 16)
    assert AS.constrain(x, "btd") is x
    with AS.scope(MESHES["2x4"]):
        assert AS.active()
        assert AS.constrain(x, "logits") is x
        assert AS.spmd() is None and AS.model_size() == 1
    assert not AS.active()


# ----------------------------------------------------------------------
# optimizer-state specs
# ----------------------------------------------------------------------

def _jax_spec(spec):
    from jax.sharding import PartitionSpec
    return PartitionSpec(*spec)


def _spec_tree_to_jax(tree):
    if isinstance(tree, dict):
        return {k: _spec_tree_to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_spec_tree_to_jax(v) for v in tree]
    return _jax_spec(tree)


def _sds(tree):
    if isinstance(tree, dict):
        return {k: _sds(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_sds(v) for v in tree]
    return jax.ShapeDtypeStruct(tuple(tree.shape), jnp.float32)


def _spec_paths(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_spec_paths(v, f"{prefix}{k}/"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_spec_paths(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = _norm(tree)
    return out


OPTIMIZERS = {"adamw": {}, "sgd": {"momentum": 0.9}, "adafactor": {}}


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    cfg = tconfigs.get_config(arch)
    return cfg, TLM.abstract_params(cfg)


@pytest.mark.parametrize("optimizer", sorted(OPTIMIZERS))
@pytest.mark.parametrize("arch", list(tconfigs.ARCHS))
def test_opt_state_specs_match_reference(arch, optimizer):
    """Both packages' ``opt_state_specs`` of the port's per-layer
    parameter tree (the reference's function takes any pytree) and the
    port's ``param_specs`` of it, on every mesh."""
    cfg, params = _abstract(arch)
    kw = OPTIMIZERS[optimizer]
    opt = make_optimizer(optimizer, lr=1e-3, **kw)[0](params)
    jopt = jax.eval_shape(jmake_optimizer(optimizer, lr=1e-3, **kw)[0],
                          _sds(params))
    for mesh in MESHES.values():
        p_specs = TS.param_specs(cfg, params, mesh)
        got = _spec_paths(T.opt_state_specs(opt, p_specs))
        want = _spec_paths(JTrain.opt_state_specs(
            jopt, _spec_tree_to_jax(p_specs)))
        assert got == want


class JTrain:
    """The reference's ``opt_state_specs``, imported when first used."""

    @staticmethod
    def opt_state_specs(opt, specs):
        from repro.launch.train import opt_state_specs
        return opt_state_specs(opt, specs)


# ----------------------------------------------------------------------
# abstract_cache
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", [a for a in tconfigs.ARCHS
                                  if a != "hubert-xlarge"])
def test_abstract_cache_matches_reference(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    ref = JLM.abstract_cache(jcfg, 8, 64, jnp.bfloat16)
    got = TLM.abstract_cache(tcfg, 8, 64, torch.bfloat16)
    n_pat = len(jcfg.pattern)
    want = []
    for layer in range(tcfg.n_layers):
        g, j = divmod(layer, n_pat)
        if g < jcfg.n_groups:
            entry = {k: (tuple(v.shape[1:]), v.dtype)
                     for k, v in ref["groups"][j].items()}
        else:
            entry = {k: (tuple(v.shape), v.dtype)
                     for k, v in ref["tail"][layer - jcfg.n_groups
                                             * n_pat].items()}
        want.append(entry)
    assert len(got) == len(want)
    for g_entry, w_entry in zip(got, want):
        assert sorted(g_entry) == sorted(w_entry)
        for k, t in g_entry.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == w_entry[k][0]
            assert str(t.dtype).removeprefix("torch.") == \
                np.dtype(w_entry[k][1]).name
