"""Meshed training and step builders of the port, on gloo ranks on the
CPU, against the port's one-process steps (and the JAX package where a
function is pure).

The reference's own meshed train step fails on every mesh (ROADMAP.md
queue C), so it is no oracle; the meshed step is held to the port's
one-process step, which ``tests/test_torch_train.py`` holds to the
reference's pieces composed without a mesh.  Groups of 2 and 4 ranks
(``run_ranks``, rank functions in ``tests/torch_dist_workers.py``) run
every check of their size once for the file:

  * the train step on (2,1), (1,2) and (2,2): the tiny config (2 KV
    heads, split over model), gemma-2b's SMOKE (1 KV head: whole K/V
    beside each rank's query heads; GeGLU; tied, vocab-parallel
    embedding and loss), a 3-head config (context-parallel attention
    at model = 2), the SMOKE configs of jamba (mamba channels, experts
    and attention heads over model), rwkv6 (heads over model) and
    qwen2-moe (experts and the shared expert over model), and qwen2-moe's
    with 3 experts (the experts' hidden columns over model), AdamW with
    accum_steps 1 and 2 and SGD with momentum:
    loss and grad norm within 1e-6 relative, the assembled gradients
    within 1e-5 of their largest, SGD's momentum within 1e-5 and AdamW's
    moments within 1e-5 relative, the parameters as stated at
    ``test_parameters``;
  * ``context_sdpa`` on 2 ranks (causal, window, non-causal; GQA)
    against the reference's ``sdpa_ref`` on the whole sequence (1e-5)
    and its gradients against the port's one-process ``sdpa``'s;
  * the meshed prefill and serve steps' greedy tokens against the
    one-process steps' (1 KV head: the cache's slots split over model,
    partials merged by their log-sum-exps; gemma3's sliding rings split
    too, decoded past the ring's end; jamba's, rwkv6's, qwen2-moe's and
    arctic's SMOKE: the mamba and rwkv states split over model);
  * jamba SMOKE's meshed forward at (1,2) against the JAX package's
    forward without a mesh, on the same weights;
  * elastic restore: saved on (2,2) after step 1, restored onto (1,2)
    and onto no mesh, step 2 equal to the uninterrupted run's;
  * ``REPRO_SEQ_SHARD=1`` (a sequence-sharded residual stream): the
    train step on (1,2) and (2,2) against the one-process step under the
    same limits, each block taking the rank's S/m rows; a sequence the
    model axis does not divide equal to the switch-off run bit for bit;
    the prefill step filling the cache, then the serve step, giving the
    one-process greedy tokens with the switch on and off; yi's and
    jamba's SMOKE meshed forward against the JAX package's, and a 3-head
    bidirectional encoder's against the one-process forward;
  * Adafactor on (2,1), (1,2), (2,2) and (1,4) (the tiny config, the
    SMOKE configs of gemma, jamba and qwen2-moe, and the tiny config with
    accum_steps 2; gemma's with ``REPRO_SEQ_SHARD=1`` on (1,2)): loss,
    grad norm, the assembled row/col/v factors and the parameters
    against the one-process steps; the meshed update on (2,2) against
    the JAX package's ``adafactor_update``; ``train_loop`` on each mesh;
    an Adafactor state saved on (1,2) restored onto (2,1) and onto no
    mesh, bit for bit;
  * the dry run's collectives tally (calls and result bytes by kind and
    by mesh axis) of one AdamW train step of gemma's SMOKE, traced on
    ``meta`` on a fake (2,2) group, against the same step's on gloo
    ranks;
  * MLA decode (minicpm3's SMOKE): the prefill that fills the latent
    cache, then greedy decode on (1,2), (2,2) and (1,4), the switch on
    and off, a cache whose slots split over model and a whole one, the
    one-process tokens; the meshed logits at (1,2) against the JAX
    package's ``decode_step``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as JA
from repro.models import lm as JLM
from repro_torch.distributed import act_sharding as AS
from repro_torch.distributed import sharding as TS
from repro_torch.launch import train as T
from repro_torch.launch.mesh import MeshShape, run_ranks
from repro_torch.models import attention as TA
from repro_torch.models import lm as TLM
from repro_torch.optim.functional import tree_leaves

GROUP_TIMEOUT = 300
TRAIN_CASES = [("tiny", "adamw", 1), ("gemma", "adamw", 1),
               ("gemma", "adamw", 2), ("gemma", "sgd", 1),
               ("odd", "adamw", 1), ("tiny", "sgd", 2),
               ("jamba", "adamw", 1), ("rwkv6", "adamw", 1),
               ("qwen2moe", "adamw", 1), ("moe3", "adamw", 1)]
SHAPES_2 = [(2, 1), (1, 2)]
SHAPES_4 = [(2, 2)]
DECODE_NAMES = ("tiny", "gemma", "gemma3", "jamba", "rwkv6", "qwen2moe",
                "arctic")
FORWARD_NAME = "jamba"
# a model axis of 4: jamba's mamba channels, experts and query heads
# split four ways (its 2 KV heads computed whole, its decode cache's
# slots split); rwkv6's 2 heads do not divide it (the layer runs whole
# on every rank, its token-shift rows still split)
MODEL_4 = (1, 4)
MODEL_4_CASES = [("jamba", "adamw", 1), ("rwkv6", "adamw", 1)]
MODEL_4_NAMES = ("jamba", "rwkv6")
# REPRO_SEQ_SHARD=1: the train step's cases on (1,2) (MLA in training
# among them: minicpm3's SMOKE) and on (2,2); the prefill and serve
# steps' configs (gemma3's 8-slot ring wrapped by the 12-token prompt);
# the configs of the meshed forward against the JAX package (yi's 7
# heads do not divide model = 2: every head on the rank's rows)
SEQ_CASES_2 = [("tiny", "adamw", 1), ("odd", "adamw", 1),
               ("gemma", "adamw", 1), ("gemma3", "adamw", 1),
               ("jamba", "adamw", 1), ("rwkv6", "adamw", 1),
               ("qwen2moe", "adamw", 1), ("minicpm3", "adamw", 1),
               ("gemma", "adafactor", 1)]
SEQ_CASES_4 = [("tiny", "adamw", 1), ("jamba", "adamw", 1)]
# (1,4): gemma3's 2 heads do not divide model = 4, so its sliding and
# global layers attend the rank's rows (windows through context_sdpa),
# and its prefill fills rings whose slots split four ways
SEQ_MODEL_4 = ("gemma3",)
SEQ_RUNS = ([((1, 2), c) for c in SEQ_CASES_2]
            + [((2, 2), c) for c in SEQ_CASES_4]
            + [(MODEL_4, (n, "adamw", 1)) for n in SEQ_MODEL_4])
SEQ_DECODE_NAMES = ("gemma", "gemma3", "jamba", "rwkv6")
SEQ_DECODE_RUNS = ([((1, 2), n) for n in SEQ_DECODE_NAMES]
                   + [(MODEL_4, n) for n in SEQ_MODEL_4])
SEQ_FORWARD_NAMES = ("yi", "jamba")
# Adafactor: its factors reduce over the ranks that split a leaf (the
# experts' 3-D leaves, mamba's and attention's split columns)
ADAFACTOR_CASES = [("tiny", "adafactor", 1), ("gemma", "adafactor", 1),
                   ("jamba", "adafactor", 1), ("qwen2moe", "adafactor", 1),
                   ("tiny", "adafactor", 2)]
ADAFACTOR_SHAPES = SHAPES_2 + SHAPES_4 + [MODEL_4]
# MLA decode: the shapes of the 2- and 4-rank groups
MLA_SHAPES = {2: [(1, 2)], 4: [(2, 2), MODEL_4]}
MLA_NAME = "minicpm3"
UPDATE_NAME = "jamba"          # the meshed update against the JAX package
UPDATE_SHAPE = (2, 2)
# the dry run's collectives tally against the same step on gloo ranks
DRYRUN_NAME, DRYRUN_SHAPE = "gemma", (2, 2)

# The limits of the train-step tests: LIMITS for every case but three,
# whose fp32 steps are worse conditioned (measured on the CPU):
#   * jamba's SMOKE (eight layers, six of them mamba): a change of its
#     weights by 1e-7 relative moves its step-1 gradients by up to 2.6e-5
#     of a leaf's largest, and the meshed step's reordered sums leave up
#     to 1.3e-5 (dt_proj): gradients and moments within 3e-5 of their
#     largest, the grad norm within 3e-6 relative; its router as below;
#   * qwen2-moe's SMOKE and its 3-expert cut: the zero-initialised bk
#     learns only through RoPE, most of its elements' gradients below
#     1e-3 of its largest, and AdamW moves such an element by
#     lr * g / (|g| + eps), whose rounding the two runs do not share:
#     the parameter rule's count of elements beyond 1e-5 leaves out those
#     whose one-process gradient is below 1e-3 of the leaf's largest
#     (every element stays within 2 lr).
LIMITS = {"loss": 1e-6, "grads": 1e-5, "small_grads": 0.0}
CASE_LIMITS = {"jamba": {"loss": 3e-6, "grads": 3e-5, "small_grads": 1e-3},
               "qwen2moe": {"small_grads": 1e-3},
               "moe3": {"small_grads": 1e-3}}
# Adafactor's over CASE_LIMITS: a 1-D leaf keeps each element's own
# second moment, and qwen2-moe's bk (the zero-initialised leaf above)
# moves the elements whose gradients lie between 1e-3 and 5e-3 of its
# largest by lr * g / sqrt(v) with g and sqrt(v) both that small: after
# step 2 up to 4 of its 64 elements beyond 1e-5 of its largest (2.3e-4
# lr at most; measured on the CPU), so the count leaves out elements
# below 1e-2 of the largest gradient
ADAFACTOR_LIMITS = {"qwen2moe": {"small_grads": 1e-2}}


def _limits(case) -> dict:
    extra = ADAFACTOR_LIMITS.get(case[0], {}) if case[1] == "adafactor" \
        else {}
    return {**LIMITS, **CASE_LIMITS.get(case[0], {}), **extra}


def _jax_tree(name):
    """The reference's seed-0 parameters of ``name``'s SMOKE config, as
    numpy arrays."""
    cfg = jax_smoke_config(W.SMOKE_ARCHS[name])
    return jax.tree.map(np.asarray, JLM.init_params(cfg, jax.random.key(0)))


def _update_grads(tree, n: int = 2, seed: int = 51):
    """``n`` gradient pytrees shaped as ``tree``, normal, from ``seed``."""
    rng = np.random.default_rng(seed)
    return [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), tree) for _ in range(n)]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Every check's rank results by world size; the 4-rank group saves
    the elastic checkpoint the 2-rank group restores."""
    ckpt = str(tmp_path_factory.mktemp("elastic"))
    loop = str(tmp_path_factory.mktemp("loop"))
    ada_ckpt = str(tmp_path_factory.mktemp("adafactor"))
    trees = {name: _jax_tree(name) for name in set(SEQ_FORWARD_NAMES)
             | {FORWARD_NAME, MLA_NAME, UPDATE_NAME}}
    update_grads = _update_grads(trees[UPDATE_NAME])
    four = run_ranks(W.jobs_rank, 4, ([
        ("mesh_train_rank", (SHAPES_4, TRAIN_CASES)),
        ("mesh_train_rank", ([MODEL_4], MODEL_4_CASES)),
        ("mesh_train_rank", (SHAPES_4 + [MODEL_4], ADAFACTOR_CASES)),
        ("mla_decode_rank", (MLA_SHAPES[4],)),
        ("adafactor_update_rank", (UPDATE_SHAPE, trees[UPDATE_NAME],
                                   update_grads)),
        ("adafactor_loop_rank", (SHAPES_4 + [MODEL_4],)),
        ("mesh_decode_rank", (SHAPES_4, DECODE_NAMES)),
        ("mesh_decode_rank", ([MODEL_4], MODEL_4_NAMES)),
        ("seq_train_rank", (SHAPES_4, SEQ_CASES_4)),
        ("seq_train_rank", ([MODEL_4], [(n, "adamw", 1)
                                        for n in SEQ_MODEL_4])),
        ("seq_decode_rank", (MODEL_4, SEQ_MODEL_4)),
        ("dryrun_tally_rank", (DRYRUN_SHAPE, DRYRUN_NAME)),
        ("elastic_save_rank", (ckpt,))],), backend="gloo",
        timeout=GROUP_TIMEOUT)
    two = run_ranks(W.jobs_rank, 2, ([
        ("mesh_train_rank", (SHAPES_2, TRAIN_CASES)),
        ("mesh_train_rank", (SHAPES_2, ADAFACTOR_CASES)),
        ("mla_decode_rank", (MLA_SHAPES[2],)),
        ("mla_reference_rank", ((1, 2), trees[MLA_NAME])),
        ("adafactor_elastic_rank", (ada_ckpt,)),
        ("adafactor_loop_rank", (SHAPES_2,)),
        ("context_sdpa_rank", ((1, 2),)),
        ("mesh_decode_rank", ([(1, 2)], DECODE_NAMES)),
        ("elastic_restore_rank", (ckpt, (1, 2))),
        ("train_loop_rank", ((1, 2), loop)),
        ("moe_train_rank", ()),
        ("mesh_forward_rank", ((1, 2), FORWARD_NAME,
                               trees[FORWARD_NAME])),
        ("seq_train_rank", ([(1, 2)], SEQ_CASES_2)),
        ("seq_odd_length_rank", ((1, 2), "tiny")),
        ("seq_decode_rank", ((1, 2), SEQ_DECODE_NAMES)),
        ("seq_forward_rank", ((1, 2), {n: trees[n]
                                       for n in SEQ_FORWARD_NAMES})),
        ("seq_encoder_rank", ((1, 2),))],),
        backend="gloo",
        timeout=GROUP_TIMEOUT)
    return {2: two, 4: four, "ckpt": ckpt, "loop": loop,
            "adafactor_ckpt": ada_ckpt,
            "update": (trees[UPDATE_NAME], update_grads)}


@pytest.fixture(scope="module")
def one_process():
    """The port's one-process runs of every train case."""
    return {case: W.run_train(W.train_cfg(case[0]), case[1], case[2])
            for case in dict.fromkeys(TRAIN_CASES + SEQ_CASES_2
                                      + ADAFACTOR_CASES)}


def _ranks(groups, shape, case, job="mesh_train_rank"):
    world = shape[0] * shape[1]
    return [g[job][(shape,) + case] for g in groups[world]]


def _assembled(ranks, pick, full_shapes, specs, shape):
    """Each leaf whole from the ranks' pieces (``pick(rank result)`` is
    the list of pieces in leaf order)."""
    mesh = MeshShape(("data", "model"), shape)
    by_coords = {tuple(r["coords"].values()): r for r in ranks}
    return [TS.assemble(lambda c, i=i: pick(by_coords[(c["data"],
                                                       c["model"])])[i],
                        full_shapes[i], specs[i], mesh)
            for i in range(len(full_shapes))]


@functools.lru_cache(maxsize=None)
def _spec_leaves(name, shape, optimizer, seq, key):
    return _leaf_specs(W.train_cfg(name), shape, optimizer, seq, key)


def _leaf_specs(cfg, shape, optimizer, seq=False, key="params"):
    """The parameters' specs in leaf order (``seq``: under
    ``REPRO_SEQ_SHARD=1``, which leaves attention weights whose heads do
    not divide ``model`` unsplit over it); ``key`` an optimizer state
    entry: its leaves' (Adafactor's ``fac``: the factors' specs, row and
    col or v a leaf; the moments and momentum: the parameters')."""
    from repro_torch.optim.functional import make_optimizer
    mesh = MeshShape(("data", "model"), shape)
    with AS.sequence_sharding(seq):
        specs = T.state_specs(cfg, mesh, optimizer=optimizer,
                              lr=W.TRAIN_LR)
    params_abs = TLM.abstract_params(cfg)
    if key != "fac":
        return T.spec_leaves(specs["params"], params_abs)
    fac = make_optimizer(optimizer, lr=W.TRAIN_LR)[0](params_abs)["fac"]
    return T.spec_leaves(specs["opt"]["fac"], fac)


ALL_SHAPES = SHAPES_2 + SHAPES_4
_SECOND = {}


def _unflatten(like, leaves):
    it = iter(leaves)
    return T.tree_map(lambda _: next(it), like)


def _references(groups, one_process, shape, case, job="mesh_train_rank"):
    """What each meshed step is held to: step 1, the one-process step 1
    from the same initial state; step 2, the one-process step 2 from the
    meshed run's own state after step 1 (assembled), so that each step is
    compared on the same inputs.  Returns [(loss, grad norm, params,
    {opt key: leaves}, the step's gradients) of step 1, of step 2].
    ``job``: the rank function whose runs are held."""
    key = (shape, case, job)
    if key not in _SECOND:
        cfg = W.train_cfg(case[0])
        seq = job == "seq_train_rank"
        first = dict(one_process[case]["steps"][0],
                     grads=one_process[case]["grads"])
        ranks = _ranks(groups, shape, case, job)

        def whole(pick, like, key="params"):
            return _assembled(ranks, pick, [x.shape for x in like],
                              _spec_leaves(case[0], shape, case[1], seq,
                                           key), shape)

        params = TLM.init_params(cfg, seed=0, device="cpu")
        state = {"params": _unflatten(params, whole(
            lambda r: r["steps"][0]["params"], first["params"])),
            "step": torch.ones((), dtype=torch.int32)}
        kw = {"momentum": 0.9} if case[1] == "sgd" else {}
        from repro_torch.optim.functional import make_optimizer
        opt = make_optimizer(case[1], lr=W.TRAIN_LR, **kw)[0](params)
        for k, leaves in first["opt"].items():
            opt[k] = _unflatten(opt[k], whole(
                lambda r, k=k: r["steps"][0]["opt"][k], leaves, k))
        if "step" in opt:
            opt["step"] = torch.ones((), dtype=torch.int32)
        state["opt"] = opt
        step = T.make_train_step(cfg, optimizer=case[1], lr=W.TRAIN_LR,
                                 accum_steps=case[2], opt_kwargs=kw,
                                 device="cpu")
        with W.moe_groups(cfg, W.MOE_GROUP_TOKENS):
            batch = W.train_batches(cfg)[1]
            grads = step.compute(state["params"], batch)[1]
            state, m = step(state, batch)
        second = {"loss": float(m["loss"]), "grads": grads,
                  "grad_norm": float(m["grad_norm"]),
                  "params": tree_leaves(state["params"]),
                  "opt": {k: tree_leaves(v) for k, v in state["opt"].items()
                          if k != "step"}}
        _SECOND[key] = [first, second]
    return _SECOND[key]


CASE_IDS = dict(ids=lambda c: "-".join(map(str, c)))


@pytest.mark.parametrize("case", TRAIN_CASES, **CASE_IDS)
@pytest.mark.parametrize("shape", ALL_SHAPES)
def test_loss_and_grad_norm(groups, one_process, shape, case):
    _check_loss_and_grad_norm(groups, one_process, shape, case)


def _check_loss_and_grad_norm(groups, one_process, shape, case,
                              job="mesh_train_rank"):
    want = _references(groups, one_process, shape, case, job)
    rel = _limits(case)["loss"]
    for r in _ranks(groups, shape, case, job):
        for got, ref in zip(r["steps"], want):
            assert got["loss"] == pytest.approx(ref["loss"], rel=rel)
            assert got["grad_norm"] == pytest.approx(ref["grad_norm"],
                                                     rel=rel)


@pytest.mark.parametrize("case", TRAIN_CASES, **CASE_IDS)
@pytest.mark.parametrize("shape", ALL_SHAPES)
def test_assembled_gradients(groups, one_process, shape, case):
    _check_assembled_gradients(groups, one_process, shape, case)


def _check_assembled_gradients(groups, one_process, shape, case,
                               job="mesh_train_rank"):
    ref = one_process[case]["grads"]
    specs = _spec_leaves(case[0], shape, case[1], job == "seq_train_rank",
                         "params")
    got = _assembled(_ranks(groups, shape, case, job), lambda r: r["grads"],
                     [g.shape for g in ref], specs, shape)
    tol = _limits(case)["grads"]
    for g, w in zip(got, ref):
        assert (g - w).abs().max() <= tol * w.abs().max()


@pytest.mark.parametrize("case", TRAIN_CASES, **CASE_IDS)
@pytest.mark.parametrize("shape", ALL_SHAPES)
def test_optimizer_state(groups, one_process, shape, case):
    """SGD's momentum within 1e-5 of its largest; AdamW's m and v within
    1e-5 relative (of each leaf's largest), after each step (the
    gradients' limit of ``CASE_LIMITS`` where it differs)."""
    _check_optimizer_state(groups, one_process, shape, case)


def _check_optimizer_state(groups, one_process, shape, case,
                           job="mesh_train_rank"):
    refs = _references(groups, one_process, shape, case, job)
    tol = _limits(case)["grads"]
    for i, ref in enumerate(refs):
        for key, leaves in ref["opt"].items():
            specs = _spec_leaves(case[0], shape, case[1],
                                 job == "seq_train_rank", key)
            got = _assembled(_ranks(groups, shape, case, job),
                             lambda r: r["steps"][i]["opt"][key],
                             [x.shape for x in leaves], specs, shape)
            for g, w in zip(got, leaves):
                assert (g - w).abs().max() <= tol * w.abs().max(), key


@pytest.mark.parametrize("case", TRAIN_CASES, **CASE_IDS)
@pytest.mark.parametrize("shape", ALL_SHAPES)
def test_parameters(groups, one_process, shape, case):
    """The parameters after each step.  SGD's within 1e-5 of each leaf's
    largest.  AdamW moves an element by lr * m_hat / (sqrt(v_hat) +
    eps): at step 1 that is lr * g / (|g| + eps), so an element whose
    gradient is near eps = 1e-8 (or whose sign the two reductions'
    rounding flips) moves by anything up to 2 lr more or less than in
    the other run, while the gradients agree to 1e-6 of their largest.
    So an element may differ by up to 2 lr, and all but 1 in 100 of a
    leaf's elements (or all but one, in a leaf of under 100) by 1e-5 of
    its largest (the count leaving out the elements ``CASE_LIMITS``
    names)."""
    _check_parameters(groups, one_process, shape, case)


def _check_parameters(groups, one_process, shape, case,
                      job="mesh_train_rank"):
    specs = _spec_leaves(case[0], shape, case[1], job == "seq_train_rank",
                         "params")
    small = _limits(case)["small_grads"]
    for i, ref in enumerate(_references(groups, one_process, shape, case,
                                        job)):
        got = _assembled(_ranks(groups, shape, case, job),
                         lambda r: r["steps"][i]["params"],
                         [x.shape for x in ref["params"]], specs, shape)
        for g, w, grad in zip(got, ref["params"], ref["grads"]):
            # Adafactor's 1-D leaves keep an element's own second moment
            # (v), and move as AdamW's do
            per_element = case[1] == "adamw" or (case[1] == "adafactor"
                                                 and w.dim() < 2)
            _assert_params_close(g, w, adamw=per_element,
                                 free=grad.abs() < small * grad.abs().max())


def _assert_params_close(got, want, adamw: bool, free=None):
    """``test_parameters``'s rule for one leaf after one step; ``free``
    marks elements left out of the count beyond the tight limit."""
    err = (got - want).abs()
    tight = 1e-5 * max(want.abs().max().item(), 1e-30)
    if not adamw:
        assert err.max() <= tight
        return
    assert err.max() <= 2 * W.TRAIN_LR + tight
    beyond = err > tight
    if free is not None:
        beyond &= ~free
    assert int(beyond.sum()) <= max(1, err.numel() // 100)


@pytest.mark.parametrize("shape", ALL_SHAPES)
def test_ranks_of_a_model_group_agree(groups, shape):
    """A leaf ``model`` does not split is the same on every rank of its
    model group after two steps (the replicas stay in step)."""
    case = ("gemma", "adamw", 1)
    cfg = W.train_cfg("gemma")
    specs = _leaf_specs(cfg, shape, "adamw")
    ranks = _ranks(groups, shape, case)
    for i, spec in enumerate(specs):
        if "model" in [e for e in spec]:
            continue
        for a in ranks:
            for b in ranks:
                if a["coords"]["data"] == b["coords"]["data"]:
                    assert torch.equal(a["steps"][1]["params"][i],
                                       b["steps"][1]["params"][i])


@pytest.mark.parametrize("case", MODEL_4_CASES, **CASE_IDS)
def test_model_axis_of_four(groups, one_process, case):
    """The train step on (1,4): step 1's loss and grad norm and the
    assembled gradients against the one-process step's, within the
    case's limits."""
    cfg = W.train_cfg(case[0])
    lim = _limits(case)
    first = one_process[case]["steps"][0]
    ranks = _ranks(groups, MODEL_4, case)
    for r in ranks:
        assert r["steps"][0]["loss"] == pytest.approx(first["loss"],
                                                      rel=lim["loss"])
        assert r["steps"][0]["grad_norm"] == pytest.approx(
            first["grad_norm"], rel=lim["loss"])
    ref = one_process[case]["grads"]
    got = _assembled(ranks, lambda r: r["grads"], [g.shape for g in ref],
                     _leaf_specs(cfg, MODEL_4, case[1]), MODEL_4)
    for g, w in zip(got, ref):
        assert (g - w).abs().max() <= lim["grads"] * w.abs().max()


# ----------------------------------------------------------------------
# context-parallel attention
# ----------------------------------------------------------------------

@pytest.mark.parametrize("causal,window", W.CONTEXT_CASES)
def test_context_sdpa_matches_reference(groups, causal, window):
    q, k, v, w = W.context_inputs()
    ranks = [g["context_sdpa_rank"][(causal, window)] for g in groups[2]]
    got = torch.cat([r["out"] for r in ranks], dim=2)
    mask = None
    s = q.shape[2]
    if window is not None:
        qp, kp = np.arange(s)[:, None], np.arange(s)[None, :]
        mask = jnp.asarray((kp > qp - window)[None, None])
    ref = JA.sdpa_ref(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                      mask=mask, is_causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("causal,window", W.CONTEXT_CASES)
def test_context_sdpa_gradients(groups, causal, window):
    q, k, v, w = (x.clone() for x in W.context_inputs())
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    (TA.sdpa(q, k, v, is_causal=causal, window=window) * w).sum().backward()
    ranks = [g["context_sdpa_rank"][(causal, window)] for g in groups[2]]
    for name, full in (("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
        got = torch.cat([r[name] for r in ranks], dim=2)
        assert (got - full).abs().max() <= 1e-5 * full.abs().max(), name


# ----------------------------------------------------------------------
# meshed prefill and serve steps
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", DECODE_NAMES)
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_meshed_greedy_decode(groups, shape, name):
    cfg = W.train_cfg(name)
    params = TLM.init_params(cfg, seed=0, device="cpu")
    first, toks, _ = W.greedy_run(cfg, params)
    world = shape[0] * shape[1]
    for g in groups[world]:
        got_first, got, merges = g["mesh_decode_rank"][(shape, name)]
        assert torch.equal(got_first, first)
        assert torch.equal(got, toks)
        # one KV head over model = 2: the cache's slots are split and
        # every attention layer of every step merges the ranks' partials
        attn = sum(spec.mixer in ("attn", "sliding")
                   for spec in cfg.layer_specs())
        split = attn > 0 and cfg.n_kv_heads % shape[1] != 0
        assert (merges > 0) == split
        if split:
            assert merges == attn * (W.DECODE_PROMPT + W.DECODE_STEPS - 1)


@pytest.mark.parametrize("name", MODEL_4_NAMES)
def test_meshed_greedy_decode_on_a_model_axis_of_four(groups, name):
    """(1,4): jamba's mamba channels and experts four ways (its cache's
    slots split, partials merged), rwkv6 whole on every rank beside its
    split token-shift rows: the greedy tokens of no mesh."""
    cfg = W.train_cfg(name)
    params = TLM.init_params(cfg, seed=0, device="cpu")
    first, toks, _ = W.greedy_run(cfg, params)
    for g in groups[4]:
        got_first, got, _ = g["mesh_decode_rank"][(MODEL_4, name)]
        assert torch.equal(got_first, first)
        assert torch.equal(got, toks)


# ----------------------------------------------------------------------
# elastic restore
# ----------------------------------------------------------------------

def test_elastic_restore_onto_another_mesh(groups):
    """Step 2 after a restore onto (1,2) equals the uninterrupted (2,2)
    run's step 2 (the loss within 1e-6 relative, the parameters by
    ``test_parameters``'s AdamW rule: the two meshes reduce in different
    orders)."""
    saved = groups[4][0]["elastic_save_rank"]
    for r in groups[2]:
        got = r["elastic_restore_rank"]
        assert got["step"] == 2
        assert got["loss"] == pytest.approx(saved["loss"], rel=1e-6)
        for x, y in zip(tree_leaves(got["params"]),
                        tree_leaves(saved["params"])):
            _assert_params_close(x, y, adamw=True)


def test_elastic_restore_hands_back_the_saved_state(groups):
    """The state restored onto (1,2) and onto no mesh, every leaf of the
    parameters and of both AdamW moments, equals the (2,2) state that was
    saved, bit for bit."""
    from repro_torch.checkpoint import CheckpointManager
    saved = groups[4][0]["elastic_save_rank"]["saved"]
    cfg = W.train_cfg(W.ELASTIC_CFG)
    like = T.init_train_state(cfg, lr=W.TRAIN_LR, device="cpu")
    runs = [r["elastic_restore_rank"]["restored"] for r in groups[2]]
    runs.append(CheckpointManager(groups["ckpt"]).restore(1, like))
    for got in runs:
        assert int(got["step"]) == int(saved["step"]) == 1
        for part in ("params", "opt"):
            want = tree_leaves(saved[part])
            have = tree_leaves(got[part])
            assert len(have) == len(want)
            for x, y in zip(have, want):
                assert x.dtype == y.dtype and torch.equal(x, y), part


def test_elastic_restore_onto_no_mesh(groups):
    from repro_torch.checkpoint import CheckpointManager
    saved = groups[4][0]["elastic_save_rank"]
    cfg = W.train_cfg(W.ELASTIC_CFG)
    like = T.init_train_state(cfg, lr=W.TRAIN_LR, device="cpu")
    state = CheckpointManager(groups["ckpt"]).restore(1, like)
    step = T.make_train_step(cfg, lr=W.TRAIN_LR, device="cpu")
    state, m = step(state, W.train_batches(cfg)[1])
    assert float(m["loss"]) == pytest.approx(saved["loss"], rel=1e-6)
    for x, y in zip(tree_leaves(state["params"]),
                    tree_leaves(saved["params"])):
        _assert_params_close(x, y, adamw=True)


# ----------------------------------------------------------------------
# Adafactor on a mesh
# ----------------------------------------------------------------------

@pytest.mark.parametrize("case", ADAFACTOR_CASES, **CASE_IDS)
@pytest.mark.parametrize("shape", ADAFACTOR_SHAPES)
def test_adafactor_loss_and_grad_norm(groups, one_process, shape, case):
    """Adafactor's meshed steps: the loss and grad norm of each step
    against the one-process step's (``test_loss_and_grad_norm``'s
    limits)."""
    _check_loss_and_grad_norm(groups, one_process, shape, case)


@pytest.mark.parametrize("case", ADAFACTOR_CASES, **CASE_IDS)
@pytest.mark.parametrize("shape", ADAFACTOR_SHAPES)
def test_adafactor_factors(groups, one_process, shape, case):
    """The row/col factors (v for a 1-D leaf), assembled from the ranks'
    pieces, after each step within the gradients' limit of each leaf's
    largest: the second step's carry the first's."""
    _check_optimizer_state(groups, one_process, shape, case)


@pytest.mark.parametrize("case", ADAFACTOR_CASES, **CASE_IDS)
@pytest.mark.parametrize("shape", ADAFACTOR_SHAPES)
def test_adafactor_parameters(groups, one_process, shape, case):
    """The parameters after each step by ``test_parameters``' rules: a
    factored leaf (2-D and up) by SGD's, within 1e-5 of its largest
    (its update divides by the factored second moment, not by an
    element's own); a 1-D leaf, whose v is each element's own (a step of
    about lr * g / |g|), by AdamW's (gemma's norms, jamba's conv_b and
    qwen2-moe's bk leave up to 14 of 64 elements beyond 1e-5 at step 2,
    2.3e-4 lr at most, on the CPU)."""
    _check_parameters(groups, one_process, shape, case)


def test_meshed_adafactor_update_matches_reference(groups):
    """The meshed update on (2,2) (jamba's SMOKE: experts, mamba channels
    and heads over model, FSDP over data), two updates from the
    reference's parameters, assembled from the pieces: the parameters,
    the factors and the step equal the JAX package's
    ``adafactor_update`` on the whole tree (every layer one group: each
    leaf a stack of one, as ``tests/test_torch_train.py`` gives it)
    within 1e-6 of each leaf's largest.  The reference factors a 1-D
    leaf's stack of one as a row of one, whose col is the port's v."""
    from repro.optim.functional import make_optimizer as jmake
    tree, grads = groups["update"]
    cfg = W.train_cfg(UPDATE_NAME)
    assert jax_smoke_config(W.SMOKE_ARCHS[UPDATE_NAME]).n_groups == 1
    init, update = jmake("adafactor", lr=W.TRAIN_LR)
    update = jax.jit(update)
    p = jax.tree.map(jnp.asarray, tree)
    o = init(p)
    ranks = [g["adafactor_update_rank"] for g in groups[4]]
    for i, g in enumerate(grads):
        p, o = update(jax.tree.map(jnp.asarray, g), o, p)
        want_p = TLM.params_from_numpy(cfg, jax.tree.map(np.asarray, p),
                                       device="cpu")
        want_f = tree_leaves(_port_factors(o["fac"]))
        for r in ranks:
            got = r["steps"][i]
            assert got["step"] == int(o["step"]) == i + 1
            for x, y in zip(tree_leaves(got["params"]),
                            tree_leaves(want_p)):
                assert (x - y).abs().max() <= 1e-6 * y.abs().max()
            have = tree_leaves(got["fac"])
            assert len(have) == len(want_f)
            for x, y in zip(have, want_f):
                assert x.shape == y.shape
                assert (x - y).abs().max() <= 1e-6 * y.abs().max()
    assert all(r["reductions"]["calls"] > 0 for r in ranks)


def _port_factors(fac):
    """The reference's factor tree of a model whose layers are one group
    in the port's layout: each layer's factors of its stack's one entry;
    a 1-D leaf's stack (1, D), a row of one, as the port's ``v``: the
    reference's ``col``, (D,) whole, which its ``row / row_mean`` of one
    leaves as the second moment."""
    def tensor(a, stacked: bool):
        return torch.from_numpy(np.array(a[0] if stacked else a))

    def walk(t, stacked: bool):
        if isinstance(t, dict) and "row" in t and "col" in t:
            if stacked and np.ndim(t["row"]) == 1:
                return {"v": tensor(t["col"], False)}
            return {k: tensor(t[k], stacked) for k in ("row", "col")}
        if isinstance(t, dict) and "v" in t:
            return {"v": tensor(t["v"], stacked)}
        if isinstance(t, dict):
            return {k: walk(v, stacked) for k, v in t.items()}
        return [walk(v, stacked) for v in t]

    out = {k: walk(v, False) for k, v in fac.items()
           if k not in ("groups", "tail")}
    out["layers"] = ([walk(g, True) for g in fac["groups"]]
                     + [walk(t, False) for t in fac.get("tail", [])])
    return out


def test_adafactor_state_restores_onto_another_mesh(groups):
    """An Adafactor state saved on (1,2) after one step, restored onto
    (2,1) and onto no mesh: every leaf of the parameters, the row/col/v
    factors and the steps equals the saved state bit for bit; step 2 on
    (2,1) gives (1,2)'s loss within 1e-6 relative."""
    from repro_torch.checkpoint import CheckpointManager
    cfg = W.train_cfg(W.ELASTIC_CFG)
    like = T.init_train_state(cfg, optimizer="adafactor", lr=W.TRAIN_LR,
                              device="cpu")
    for g in groups[2]:
        r = g["adafactor_elastic_rank"]
        runs = [r["restored"], CheckpointManager(
            groups["adafactor_ckpt"]).restore(1, like)]
        for got in runs:
            want = tree_leaves(r["saved"])
            have = tree_leaves(got)
            assert len(have) == len(want)
            assert int(got["step"]) == int(got["opt"]["step"]) == 1
            for x, y in zip(have, want):
                assert x.dtype == y.dtype and torch.equal(x, y)
        assert r["losses"][1] == pytest.approx(r["losses"][0], rel=1e-6)


@pytest.mark.parametrize("shape", ADAFACTOR_SHAPES)
def test_adafactor_train_loop_on_a_mesh(groups, shape):
    """``train_loop(mesh=, optimizer="adafactor")`` gives the one-process
    loop's losses within 1e-6 relative."""
    from repro_torch.launch.train import train_loop
    want = train_loop(W.train_cfg("tiny"), steps=W.LOOP_STEPS,
                      batch_size=4, seq_len=16, optimizer="adafactor",
                      lr=W.TRAIN_LR, log_every=100, device="cpu")
    for g in groups[shape[0] * shape[1]]:
        got = g["adafactor_loop_rank"][shape]
        assert got == pytest.approx(want["losses"], rel=1e-6)


# ----------------------------------------------------------------------
# MLA decode on a model axis > 1
# ----------------------------------------------------------------------

MLA_RUNS = [(shape, max_seq) for world in (2, 4)
            for shape in MLA_SHAPES[world] for max_seq in W.MLA_MAX_SEQS]


@pytest.mark.parametrize("run", MLA_RUNS,
                         ids=lambda r: "x".join(map(str, r[0])) + f"-{r[1]}")
def test_mla_prefill_and_decode_on_a_mesh(groups, run):
    """minicpm3's SMOKE: the prefill that fills the latent cache, then
    greedy decode, gives the one-process tokens with the switch on and
    off; where ``max_seq`` divides model the cache's slots are split and
    each decode step of each MLA layer merges the ranks' partials, else
    the cache is whole and nothing is merged."""
    shape, max_seq = run
    cfg = W.train_cfg(MLA_NAME)
    params = TLM.init_params(cfg, seed=0, device="cpu")
    want, _ = W.filled_run(cfg, params)
    split = max_seq % shape[1] == 0
    layers = sum(spec.mixer == "mla" for spec in cfg.layer_specs())
    for g in groups[shape[0] * shape[1]]:
        for on in (True, False) if split else (False,):
            toks, merges, rows, _ = g["mla_decode_rank"][(shape, max_seq,
                                                          on)]
            assert torch.equal(toks, want), on
            assert merges == (layers * (W.FILL_STEPS - 1) if split else 0)
            assert rows == [1, W.FILL_PROMPT // (shape[1] if on else 1)]


@pytest.mark.parametrize("run", MLA_RUNS,
                         ids=lambda r: "x".join(map(str, r[0])) + f"-{r[1]}")
def test_mla_cache_holds_the_rank_slots(groups, run):
    """A rank's latent cache: its rows of the batch and, where
    ``max_seq`` divides model, its max_seq / model slots of ``c_kv`` and
    ``k_rope`` (else every slot)."""
    shape, max_seq = run
    cfg = W.train_cfg(MLA_NAME)
    slots = max_seq // shape[1] if max_seq % shape[1] == 0 else max_seq
    rows = W.DECODE_ROWS // shape[0]
    for g in groups[shape[0] * shape[1]]:
        _, _, _, cache = g["mla_decode_rank"][(shape, max_seq, False)]
        assert cache == {"c_kv": (rows, slots, cfg.kv_lora_rank),
                         "k_rope": (rows, 1, slots, cfg.mla_rope_dim)}


def test_mla_meshed_decode_matches_reference(groups):
    """minicpm3 SMOKE's meshed prefill filling a slot-split cache at
    (1,2), then the serve step fed fixed tokens: the logits of the
    prompt's last position and of each step against the JAX package's
    ``decode_step`` without a mesh fed the prompt and the same tokens one
    a step, on the same weights, within 1e-5 (``attn_backend="ref"``:
    the reference's MLA at S >= 128 needs it, ROADMAP.md queue C)."""
    cfg = jax_smoke_config(W.SMOKE_ARCHS[MLA_NAME])
    assert cfg.attn_backend == "ref"
    params = JLM.init_params(cfg, jax.random.key(0))
    tcfg = W.train_cfg(MLA_NAME)
    tokens = torch.cat([W.fill_prompts(tcfg), W.mla_forced_tokens(tcfg)],
                       1).numpy().astype(np.int32)
    cache = JLM.init_cache(cfg, W.DECODE_ROWS, tokens.shape[1],
                           jnp.float32)
    step = jax.jit(JLM.decode_step, static_argnums=0)
    want = []
    for t in range(tokens.shape[1]):
        logits, cache = step(cfg, params, cache, jnp.asarray(
            tokens[:, t:t + 1]), t)
        if t >= W.FILL_PROMPT - 1:
            want.append(np.asarray(logits))
    for g in groups[2]:
        got = g["mla_reference_rank"]
        assert got["merges"] == tcfg.n_layers * W.MLA_FORCED
        assert len(got["logits"]) == len(want)
        for x, y in zip(got["logits"], want):
            np.testing.assert_allclose(x.numpy(), y, atol=1e-5, rtol=1e-5)


def test_train_loop_on_a_mesh_resumes_without_one(groups, tmp_path):
    """``train_loop(mesh=(1,2))`` gives the one-process loop's losses
    (1e-6 relative) and its final checkpoint (the whole state, written
    by the first rank) resumes a one-process loop at that step."""
    from repro_torch.launch.train import train_loop
    cfg = W.train_cfg("tiny")
    kw = dict(batch_size=4, seq_len=16, log_every=100, device="cpu")
    want = train_loop(cfg, steps=W.LOOP_STEPS, **kw)
    for g in groups[2]:
        got = g["train_loop_rank"]
        assert got["steps"] == W.LOOP_STEPS
        assert got["losses"] == pytest.approx(want["losses"], rel=1e-6)
    resumed = train_loop(cfg, steps=W.LOOP_STEPS + 1,
                         checkpoint_dir=groups["loop"], **kw)
    assert resumed["steps"] == 1 and np.isfinite(resumed["final_loss"])


def test_moe_data_parallel_step(groups):
    """qwen2-moe's SMOKE on (2,1): each data rank routes its own rows as
    one group (the reference's groups per data shard) and the balance
    loss takes its means over both ranks' groups, as the one-process
    step with two groups of the same rows does: loss and grad norm within
    1e-6 relative, the gradients within 1e-5 of each leaf's largest."""
    from repro_torch.configs import get_smoke_config
    want = W.moe_train()
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    specs = _leaf_specs(cfg, (2, 1), "adamw")
    ranks = [g["moe_train_rank"] for g in groups[2]]
    got = _assembled(ranks, lambda r: r["grads"],
                     [g.shape for g in want["grads"]], specs, (2, 1))
    for g, w in zip(got, want["grads"]):
        assert (g - w).abs().max() <= 1e-5 * max(w.abs().max(), 1e-30)
    for r in ranks:
        assert r["steps"][0]["loss"] == pytest.approx(
            want["steps"][0]["loss"], rel=1e-6)
        assert r["steps"][0]["grad_norm"] == pytest.approx(
            want["steps"][0]["grad_norm"], rel=1e-6)


# ----------------------------------------------------------------------
# the rank's pieces drawn leaf by leaf; the JAX package's forward
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["jamba", "rwkv6", "qwen2moe", "arctic",
                                  "gemma", "moe3"])
@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2), (1, 4)])
def test_init_pieces_equal_shard_tree(name, shape):
    """``init_pieces`` at every position of the mesh equals
    ``local_shard`` of ``init_params``'s whole tree, bit for bit."""
    cfg = W.train_cfg(name)
    mesh = MeshShape(("data", "model"), shape)
    full = TLM.init_params(cfg, seed=3, device="cpu")
    specs = TS.param_specs(cfg, full, mesh)
    for here in TS.all_coords(mesh):
        got = T.init_pieces(cfg, mesh, seed=3, device="cpu", here=here)
        want = TS.with_specs(lambda x, sp: TS.local_shard(x, sp, mesh, here),
                             full, specs)
        a, b = tree_leaves(got), tree_leaves(want)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y)


def test_jamba_meshed_forward_matches_reference(groups):
    """jamba SMOKE's meshed prefill logits at (1,2) (mamba channels,
    experts, attention heads and the vocabulary over model) against the
    JAX package's ``forward`` without a mesh on the same weights, within
    1e-5."""
    cfg = jax_smoke_config(W.SMOKE_ARCHS[FORWARD_NAME])
    params = JLM.init_params(cfg, jax.random.key(0))
    want, _ = JLM.forward(cfg, params,
                          jnp.asarray(W.forward_tokens(W.train_cfg(
                              FORWARD_NAME))))
    for g in groups[2]:
        got = g["mesh_forward_rank"]
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)


# ----------------------------------------------------------------------
# REPRO_SEQ_SHARD=1: a sequence-sharded residual stream
# ----------------------------------------------------------------------

SEQ_IDS = dict(ids=lambda r: "x".join(map(str, r[0])) + "-" + r[1][0])


@pytest.mark.parametrize("run", SEQ_RUNS, **SEQ_IDS)
def test_seq_shard_loss_and_grad_norm(groups, one_process, run):
    """The switch-on train step's loss and grad norm after each step
    against the one-process step's (``test_loss_and_grad_norm``'s
    limits)."""
    _check_loss_and_grad_norm(groups, one_process, *run, "seq_train_rank")


@pytest.mark.parametrize("run", SEQ_RUNS, **SEQ_IDS)
def test_seq_shard_assembled_gradients(groups, one_process, run):
    _check_assembled_gradients(groups, one_process, *run, "seq_train_rank")


@pytest.mark.parametrize("run", SEQ_RUNS, **SEQ_IDS)
def test_seq_shard_optimizer_state(groups, one_process, run):
    _check_optimizer_state(groups, one_process, *run, "seq_train_rank")


@pytest.mark.parametrize("run", SEQ_RUNS, **SEQ_IDS)
def test_seq_shard_parameters(groups, one_process, run):
    _check_parameters(groups, one_process, *run, "seq_train_rank")


@pytest.mark.parametrize("run", SEQ_RUNS, **SEQ_IDS)
def test_seq_shard_blocks_take_the_rank_rows(groups, run):
    """Between blocks a rank holds only its S/m rows of the residual
    stream: every block of the switch-on step (its forward and, under
    remat, its recompute) took S / model rows."""
    shape, case = run
    for r in _ranks(groups, shape, case, "seq_train_rank"):
        assert r["rows"] == [W.TRAIN_BATCH[1] // shape[1]]


def test_seq_shard_odd_length_equals_switch_off(groups):
    """A sequence of 15 on (1,2): the spec keeps S whole, and the step
    with the switch on is the switch-off step bit for bit (the loss,
    grad norm, gradients, parameters and moments of both steps)."""
    for g in groups[2]:
        on, off = (g["seq_odd_length_rank"][k] for k in (True, False))
        assert on["rows"] == off["rows"] == [W.ODD_LENGTH[1]]
        for a, b in zip(on["grads"], off["grads"]):
            assert torch.equal(a, b)
        for x, y in zip(on["steps"], off["steps"]):
            assert x["loss"] == y["loss"]
            assert x["grad_norm"] == y["grad_norm"]
            for a, b in zip(x["params"], y["params"]):
                assert torch.equal(a, b)
            for k in x["opt"]:
                for a, b in zip(x["opt"][k], y["opt"][k]):
                    assert torch.equal(a, b)


@pytest.mark.parametrize("run", SEQ_DECODE_RUNS,
                         ids=lambda r: "x".join(map(str, r[0])) + "-" + r[1])
def test_seq_shard_prefill_and_decode(groups, run):
    """The prefill step filling the cache, then the serve step: the
    greedy tokens of the one-process steps with the switch on (the
    prefill's blocks take the rank's 12 / model positions; decode's S = 1
    does not divide model and runs the switch-off path) and with it
    off."""
    shape, name = run
    cfg = W.train_cfg(name)
    params = TLM.init_params(cfg, seed=0, device="cpu")
    want, _ = W.filled_run(cfg, params)
    for g in groups[shape[0] * shape[1]]:
        for on in (True, False):
            toks, _, rows = g["seq_decode_rank"][(name, on)]
            assert torch.equal(toks, want), on
            assert rows == [1, W.FILL_PROMPT // (shape[1] if on else 1)]


@pytest.mark.parametrize("name", ["tiny", "gemma", "gemma3", "jamba",
                                  "rwkv6", "minicpm3", "yi"])
def test_prefill_fills_the_cache(name):
    """One process: the prefill step that fills the cache, then the serve
    step, gives the greedy tokens of the prompt fed through the serve
    step one token a step (gemma3's 12-token prompt wraps its 8-slot
    ring; MoE dropless in both, as decode is)."""
    import dataclasses
    cfg = W.train_cfg(name)
    if cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    params = TLM.init_params(cfg, seed=0, device="cpu")
    filled, _ = W.filled_run(cfg, params)
    stepped, _ = W.filled_run(cfg, params, fill=False)
    assert torch.equal(filled, stepped)


@pytest.mark.parametrize("name", SEQ_FORWARD_NAMES)
def test_seq_shard_forward_matches_reference(groups, name):
    """yi's and jamba's SMOKE meshed prefill logits at (1,2) with the
    switch on against the JAX package's ``forward`` without a mesh on
    the same weights, within 1e-5."""
    cfg = jax_smoke_config(W.SMOKE_ARCHS[name])
    params = JLM.init_params(cfg, jax.random.key(0))
    want, _ = JLM.forward(cfg, params, jnp.asarray(
        W.forward_tokens(W.train_cfg(name))))
    for g in groups[2]:
        got = g["seq_forward_rank"][name]
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)


def test_seq_shard_bidirectional_encoder_forward(groups):
    """A bidirectional encoder (hubert's SMOKE cut to 3 heads: every head
    on the rank's rows, non-causal ``context_sdpa``; layer norm,
    embeddings in, a classification head) with the switch on at (1,2):
    the blocks take 8 of the 16 positions, and the logits equal the
    one-process forward's within 1e-5."""
    cfg = W.encoder_cfg()
    params = TLM.init_params(cfg, seed=0, device="cpu")
    want, _ = TLM.forward(cfg, params, embeds=W.encoder_embeds(cfg))
    for g in groups[2]:
        got, rows = g["seq_encoder_rank"]
        assert rows == [W.FORWARD_TOKENS[1] // 2]
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_dryrun_collectives_tally_matches_the_ranks(groups):
    """The dry run's prediction of a step's collectives (rank 0 of a fake
    group, on ``meta``) equals what rank 0 of the gloo group counted
    running it: calls and result bytes of each kind and each axis."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun
    b, s = W.TRAIN_BATCH
    pred = dryrun.trace_cell(W.train_cfg(DRYRUN_NAME),
                             ShapeSpec("train", s, b),
                             (DRYRUN_SHAPE, ("data", "model")),
                             optimizer="adamw", skip_cost=True,
                             timeout=GROUP_TIMEOUT)
    got = groups[4][0]["dryrun_tally_rank"]
    assert pred["collectives"] == got
    assert got["calls"] > 0
    assert set(got["axes"]) == {"data", "model"}
    assert all(got["kinds"][k]["calls"] for k in ("all-gather",
                                                  "all-reduce",
                                                  "reduce-scatter"))
