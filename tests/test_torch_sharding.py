"""The port's sharding tables against the JAX package's, leaf by leaf.

``repro_torch.distributed.sharding`` and ``repro.distributed.sharding``
are pure functions of leaf shapes, the config and the mesh's axis names
and sizes (the reference reads only ``mesh.shape`` and
``mesh.axis_names``), so both take a shape-only mesh here and no forced
devices are needed.  For each of the ten configs and the meshes (1,1),
(2,4), (4,2), (16,16) and (2,16,16): ``param_specs``,
``serving_param_specs``, ``cache_specs`` and ``batch_specs`` equal the
reference's, the reference's leading group-stack axis dropped (the port
keeps one entry per layer); the serving pool's specs for 1, 2 and 8 KV
heads; ``local_shard`` / ``assemble``; ``mesh_for_serving``'s refusals
and the replica-count checks of ``PagePool`` and ``Scheduler``.
"""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.distributed import sharding as JS
from repro.models import lm as JLM
from repro_torch import configs as tconfigs
from repro_torch.distributed import sharding as TS
from repro_torch.launch.mesh import MeshShape, mesh_for_serving
from repro_torch.models import lm as TLM
from repro_torch.serving.errors import MeshConfigError

MESHES = {
    "1x1": MeshShape(("data", "model"), (1, 1)),
    "2x4": MeshShape(("data", "model"), (2, 4)),
    "4x2": MeshShape(("data", "model"), (4, 2)),
    "16x16": MeshShape(("data", "model"), (16, 16)),
    "2x16x16": MeshShape(("pod", "data", "model"), (2, 16, 16)),
}
ARCHS = list(tconfigs.ARCHS)


class RefMesh:
    """What the reference's tables read of a ``jax.sharding.Mesh``."""

    def __init__(self, mesh: MeshShape):
        self.axis_names = mesh.axis_names
        self.shape = dict(mesh.shape)


def _paths(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}{k}/"))
    elif isinstance(tree, list):          # specs are tuples: leaves
        for i, v in enumerate(tree):
            out.update(_paths(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _ref_to_port(cfg, ref: dict, layers_key: str, port_prefix: str,
                 stack_split=None) -> dict:
    """Reference path -> leaf as the port lays it out: ``groups/j/...``
    (leading stack axis) becomes ``{port_prefix}{g*P+j}/...`` for every
    group g, with the stack axis's entry dropped; ``tail/j/...`` becomes
    layer ``n_groups*P + j``.  The stack axis is never split, but for the
    shared expert's weights (the reference's EP rule reads the stack
    axis as an expert count): those port paths go to ``stack_split``."""
    n_pat = len(cfg.pattern)
    out = {}
    for path, spec in ref.items():
        parts = path.split("/")
        if parts[0] == "groups":
            j, rest = int(parts[1]), "/".join(parts[2:])
            if spec[0] is not None:
                assert "/moe/shared/" in path, (path, spec)
                for g in range(cfg.n_groups):
                    stack_split.add(f"{port_prefix}{g * n_pat + j}/{rest}")
                continue
            for g in range(cfg.n_groups):
                out[f"{port_prefix}{g * n_pat + j}/{rest}"] = tuple(spec[1:])
        elif parts[0] == "tail":
            j, rest = int(parts[1]), "/".join(parts[2:])
            out[f"{port_prefix}{cfg.n_groups * n_pat + j}/{rest}"] = \
                tuple(spec)
        else:
            assert layers_key == "", path
            out[path] = tuple(spec)
    return out


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg = jconfigs.get_config(arch)
    tcfg = tconfigs.get_config(arch)
    return jcfg, JLM.abstract_params(jcfg), tcfg, TLM.abstract_params(tcfg)


def _spec_maps(arch, mesh, port_fn, ref_fn):
    """(port specs, the reference's) by port path.  A shared-expert leaf
    whose stack axis the reference splits is held to the reference's own
    mlp rule for its 2-D weight instead (ROADMAP.md queue C)."""
    jcfg, jparams, tcfg, tparams = _models(arch)
    ref = _paths(ref_fn(jcfg, jparams, RefMesh(mesh)))
    top = {p: s for p, s in ref.items()
           if not p.startswith(("groups/", "tail/"))}
    stacked = {p: s for p, s in ref.items() if p not in top}
    want = {p: tuple(s) for p, s in top.items()}
    split = set()
    want.update(_ref_to_port(jcfg, stacked, "layers", "layers/", split))
    leaves = _paths(tparams)
    rules = (JS.serving_rules(RefMesh(mesh))
             if ref_fn is JS.serving_param_specs
             else JS.AxisRules.for_mesh(RefMesh(mesh)))
    for path in split:
        want[path] = tuple(JS.param_spec(
            path.replace("/moe/shared/", "/mlp/"), leaves[path], jcfg,
            RefMesh(mesh), rules))
    got = {p: tuple(s) for p, s in _paths(port_fn(tcfg, tparams,
                                                  mesh)).items()}
    return got, want


def _shapes_agree(arch):
    """Leaf shapes of the two parameter trees agree (what the tables
    read), stack axis dropped."""
    jcfg, jparams, tcfg, tparams = _models(arch)
    shapes = {p: tuple(x.shape) for p, x in _paths(jparams).items()}
    want = {p: s for p, s in shapes.items()
            if not p.startswith(("groups/", "tail/"))}
    stacked = {p: ((None,) + s[1:] if p.startswith("groups/") else s)
               for p, s in shapes.items() if p not in want}
    want.update(_ref_to_port(jcfg, stacked, "layers", "layers/"))
    got = {p: tuple(x.shape) for p, x in _paths(tparams).items()}
    return got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_shapes_match(arch):
    assert _shapes_agree(arch)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh):
    got, want = _spec_maps(arch, MESHES[mesh], TS.param_specs,
                           JS.param_specs)
    assert got == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_param_specs_match_reference(arch, mesh):
    got, want = _spec_maps(arch, MESHES[mesh], TS.serving_param_specs,
                           JS.serving_param_specs)
    assert got == want


@pytest.mark.parametrize("switch", [("REPRO_ATTN_FALLBACK", "replicate"),
                                    ("REPRO_SEQ_SHARD", "1")])
def test_head_fallback_switches_match_reference(switch, monkeypatch):
    """yi-34b's 56 heads do not divide 16: both switches keep only FSDP
    on its attention weights, in both packages."""
    monkeypatch.setenv(*switch)
    got, want = _spec_maps("yi-34b", MESHES["16x16"], TS.param_specs,
                           JS.param_specs)
    assert got == want
    assert got["layers/0/attn/wq"] == ("data", None)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, mesh):
    jcfg, _, tcfg, _ = _models(arch)
    ref = _paths(JS.cache_specs(jcfg, JLM.abstract_cache(jcfg, 32, 64),
                                RefMesh(MESHES[mesh])))
    layout = TLM.cache_layout(tcfg, 32, 64, torch.bfloat16)
    cache = [{k: torch.empty(s, dtype=dt, device="meta")
              for k, (s, dt) in entry.items()} for entry in layout]
    got = {p: tuple(s) for p, s in _paths(
        TS.cache_specs(tcfg, cache, MESHES[mesh])).items()}
    want = _ref_to_port(jcfg, ref, "", "")
    # a 3-D per-layer state (rwkv shifts, mamba conv/ssm, MLA's c_kv) is
    # 4-D stacked, and the reference reads its batch divisibility off the
    # stack axis there (ROADMAP.md queue C); such a leaf is held to the
    # reference's table applied to the port's own, unstacked leaf
    flat = JS.cache_specs(jcfg, [
        {k: jax.ShapeDtypeStruct(s, jnp.bfloat16) for k, (s, _) in
         entry.items()} for entry in layout], RefMesh(MESHES[mesh]))
    for path, spec in _paths(flat).items():
        if len(spec) == 3:
            want[path] = tuple(spec)
    assert got == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_match_reference(arch, mesh):
    jcfg, _, tcfg, _ = _models(arch)
    for name, spec in tconfigs.get_shapes(arch).items():
        if not hasattr(spec, "global_batch"):
            continue
        jspec = jconfigs.get_shapes(arch)[name]
        ref = JS.batch_specs(jcfg, jconfigs.input_specs(jcfg, jspec),
                             RefMesh(MESHES[mesh]))
        got = TS.batch_specs(tcfg, tconfigs.input_specs(tcfg, spec),
                             MESHES[mesh])
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in ref.items()}, name


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("n_kv_heads", [1, 2, 8])
def test_serving_pool_specs_match_reference(n_kv_heads, mesh):
    m = MESHES[mesh]
    for ppr in (64, 63):
        kw = dict(pages_per_replica=ppr)
        assert tuple(TS.serving_kv_spec(n_kv_heads, m, **kw)) == \
            tuple(JS.serving_kv_spec(n_kv_heads, RefMesh(m), **kw))
        assert tuple(TS.serving_kv_scale_spec(n_kv_heads, m, **kw)) == \
            tuple(JS.serving_kv_scale_spec(n_kv_heads, RefMesh(m), **kw))
    assert tuple(TS.serving_mirror_spec(m)) == \
        tuple(JS.serving_mirror_spec(RefMesh(m)))


def test_gemma_mqa_takes_context_parallel_pages():
    """gemma-2b's one KV head at tp = 2: pages over (data, model)."""
    m = MeshShape(("data", "model"), (1, 2))
    assert TS.serving_kv_spec(1, m, pages_per_replica=64) == \
        TS.P(("data", "model"), None, None, None)
    assert TS.serving_kv_spec(2, m, pages_per_replica=64) == \
        TS.P("data", None, "model", None)


@pytest.mark.parametrize("spec", [TS.P("data", None, "model", None),
                                  TS.P(("data", "model"), None, None, None),
                                  TS.P(None, "model", None, "data"),
                                  TS.P(None, None, None, None)])
def test_local_shard_and_assemble_are_inverse(spec):
    mesh = MeshShape(("data", "model"), (2, 2))
    full = torch.arange(8 * 3 * 4 * 2, dtype=torch.float32).reshape(
        8, 3, 4, 2)
    if spec[1] == "model":
        full = torch.arange(8 * 4 * 4 * 2, dtype=torch.float32).reshape(
            8, 4, 4, 2)
    got = TS.assemble(lambda c: TS.local_shard(full, spec, mesh, c),
                      full.shape, spec, mesh)
    assert torch.equal(got, full)
    # (data, model) over the page axis: rank (d, m) holds the m-th half of
    # replica d's range
    if spec[0] == ("data", "model"):
        piece = TS.local_shard(full, spec, mesh, {"data": 1, "model": 0})
        assert torch.equal(piece, full[4:6])


def test_shard_range_refuses_an_uneven_split():
    with pytest.raises(ValueError):
        TS.shard_range(7, "model", {"model": 2}, {"model": 0})


def test_mesh_for_serving_refuses_without_ranks():
    """More ranks than the (absent) process group has, a tp that does not
    divide, no device: MeshConfigError, as the reference raises."""
    with pytest.raises(MeshConfigError):
        mesh_for_serving(2)
    with pytest.raises(MeshConfigError):
        mesh_for_serving(1, tp=2)
    with pytest.raises(MeshConfigError):
        mesh_for_serving(0)


def test_pool_and_scheduler_refuse_replica_mismatch():
    from repro_torch.serving.kv_cache import PagePool, PagedKVCache
    from repro_torch.serving.scheduler import Scheduler
    with pytest.raises(MeshConfigError):
        PagePool(10, n_replicas=4)
    kv = PagedKVCache(n_layers=1, n_kv_heads=2, head_dim=4, page_size=4,
                      num_pages=8, n_replicas=1, device="cpu")
    with pytest.raises(MeshConfigError):
        Scheduler(kv, max_batch=2, n_replicas=2)


def test_replica_pages_stay_in_their_range():
    """The reference's replica isolation: a sequence's pages come from its
    replica's range, prefix hits never cross it, OOM is per replica."""
    from repro_torch.serving.kv_cache import PagedKVCache
    kv = PagedKVCache(n_layers=1, n_kv_heads=2, head_dim=4, page_size=4,
                      num_pages=16, n_replicas=2, device="cpu")
    kv.create(0, list(range(1, 10)), replica=0)
    kv.create(1, list(range(1, 10)), replica=1)
    assert all(p < 8 for p in kv.tables[0])
    assert all(8 <= p < 16 for p in kv.tables[1])
    assert set(kv.tables[0]).isdisjoint(kv.tables[1])
    assert kv.ensure_capacity(1, 16)
    assert all(8 <= p < 16 for p in kv.tables[1])
    assert kv.pool.replica_of(9) == 1
    kv.free_seq(0)
    kv.free_seq(1)
    assert kv.pool.num_free == 16
    kv2 = PagedKVCache(n_layers=1, n_kv_heads=2, head_dim=4, page_size=4,
                       num_pages=8, n_replicas=2, device="cpu")
    kv2.create(0, list(range(1, 16)), replica=0)
    assert not kv2.can_admit(4, replica=0) and kv2.can_admit(4, replica=1)
    assert kv2.pool.free_in(0) == 0 and kv2.pool.free_in(1) == 4
    assert kv2.pool.page_hwm_per_replica == [4, 0]

