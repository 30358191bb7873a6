"""Port model layers and the executor body against the JAX package, on
the same numpy inputs and the reference's own parameters carried across
through ``params_from_numpy``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma_2b as jgemma
from repro.models import layers as JL
from repro.models.lm import BlockSpec, init_params
from repro.serving.executor import Executor as JExecutor
from repro_torch.configs import gemma_2b as tgemma
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.serving.executor import Executor as TExecutor
from torch_port_helpers import (port_cfg, port_params, tiny_cfg, to_numpy,
                                to_torch)

LAYER_TOL = dict(rtol=1e-6, atol=1e-6)
BODY_TOL = dict(rtol=2e-5, atol=2e-5)      # docs/kernels.md serving tier


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm(offset):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    exp = np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6,
                                 offset))
    out = to_numpy(TL.rms_norm(to_torch(x), to_torch(w), 1e-6, offset))
    np.testing.assert_allclose(out, exp, **LAYER_TOL)


def test_layer_norm():
    rng = np.random.default_rng(1)
    x, w, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((5, 64), 64, 64))
    exp = np.asarray(JL.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b), 1e-5))
    out = to_numpy(TL.layer_norm(to_torch(x), to_torch(w), to_torch(b),
                                 1e-5))
    np.testing.assert_allclose(out, exp, **LAYER_TOL)


@pytest.mark.parametrize("per_token", [False, True])
def test_apply_rope(per_token):
    rng = np.random.default_rng(2)
    if per_token:           # the executor's layout: (T, H, 1, hd), (T, 1)
        x = rng.standard_normal((6, 4, 1, 16)).astype(np.float32)
        pos = rng.integers(0, 50, (6, 1)).astype(np.int32)
    else:                   # (B, H, S, D) with (S,) positions
        x = rng.standard_normal((2, 4, 6, 16)).astype(np.float32)
        pos = np.arange(6, dtype=np.int32)
    exp = np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    out = to_numpy(TL.apply_rope(to_torch(x), to_torch(pos), 1e4))
    np.testing.assert_allclose(out, exp, **LAYER_TOL)


@pytest.mark.parametrize("act", ["gelu", "silu"])
@pytest.mark.parametrize("gated", [True, False])
def test_mlp(act, gated):
    p = JL.mlp_init(jax.random.key(3), 32, 64, jnp.float32, gated=gated)
    x = np.random.default_rng(3).standard_normal((5, 32)).astype(np.float32)
    exp = np.asarray(JL.mlp(p, jnp.asarray(x), act))
    tp = {k: to_torch(v) for k, v in p.items()}
    out = to_numpy(TL.mlp(tp, to_torch(x), act))
    np.testing.assert_allclose(out, exp, **LAYER_TOL)


def test_configs_copied():
    for name in ("CONFIG", "SMOKE"):
        assert port_cfg(getattr(jgemma, name)) == getattr(tgemma, name)


def test_init_params_shapes_and_unsupported_mixers():
    cfg = tiny_cfg()
    ref = jax.tree.map(np.shape, init_params(cfg, jax.random.key(0)))
    ours = TLM.init_params(port_cfg(cfg), seed=0, device="cpu")
    layer = ours["layers"][0]
    assert len(ours["layers"]) == cfg.n_layers
    assert tuple(ours["embed"].shape) == ref["embed"]
    for k in ("wq", "wk", "wv", "wo"):
        assert tuple(layer["attn"][k].shape) == \
            ref["groups"][0]["attn"][k][1:]
    for k in ("w_up", "w_down", "w_gate"):
        assert tuple(layer["mlp"][k].shape) == \
            ref["groups"][0]["mlp"][k][1:]
    import dataclasses
    unknown = dataclasses.replace(port_cfg(cfg),
                                  pattern=(TLM.BlockSpec("lstm", "dense"),))
    with pytest.raises(ValueError, match="unknown block"):
        TLM.init_params(unknown, device="cpu")
    # mla builds, with the reference's shapes
    mla_cfg = dataclasses.replace(
        cfg, pattern=(BlockSpec("mla", "dense"),), q_lora_rank=32,
        kv_lora_rank=16, mla_nope_dim=16, mla_rope_dim=8, mla_v_dim=16)
    ref = jax.tree.map(np.shape, init_params(mla_cfg, jax.random.key(0)))
    ours = TLM.init_params(port_cfg(mla_cfg), seed=0, device="cpu")
    for k, t in ours["layers"][0]["attn"].items():
        assert tuple(t.shape) == ref["groups"][0]["attn"][k][1:]


def mixed_batch(cfg, kv_quant, seed=4):
    """One mixed step on a prefilled pool: a prefill chunk (slot 0), a
    fresh prefill start (slot 1), decode tokens (slot 2), a reused-prefix
    row whose write is skipped (OOB), and a padding row."""
    rng = np.random.default_rng(seed)
    n_pages, ps = 16, 4
    hkv, hd = cfg.n_kv_heads, cfg.hd
    tables = rng.permutation(n_pages)[:12].reshape(3, 4).astype(np.int32)
    seg = np.array([0, 0, 1, 2, 2, 2, -1, -1], np.int32)
    pos = np.array([3, 4, 0, 10, 14, 15, 0, 0], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
    tokens[6:] = 0
    oob = n_pages * ps
    widx = np.full(8, oob, np.int32)
    for i in range(6):
        widx[i] = tables[seg[i], pos[i] // ps] * ps + pos[i] % ps
    widx[3] = oob                      # reused prefix: K/V already valid
    pools = []
    for _ in range(cfg.n_layers * 2):
        pools.append(rng.standard_normal((n_pages, ps, hkv, hd))
                     .astype(np.float32))
    return dict(tables=tables, seg=seg, pos=pos, tokens=tokens, widx=widx,
                pools=pools, oob=oob)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("which", ["tiny", "gemma_smoke"])
def test_executor_body_matches_jax(which, kv_quant):
    cfg = tiny_cfg() if which == "tiny" else jgemma.SMOKE
    params = init_params(cfg, jax.random.key(5))
    b = mixed_batch(cfg, kv_quant)
    nl = cfg.n_layers

    from repro.serving import quant as jq
    jk, jv, jks, jvs = [], [], [], []
    for i in range(nl):
        for pool, codes, scales in ((b["pools"][2 * i], jk, jks),
                                    (b["pools"][2 * i + 1], jv, jvs)):
            if kv_quant is None:
                codes.append(jnp.asarray(pool))
            else:
                c, s = jq.quantize(jnp.asarray(pool), kv_quant)
                codes.append(c)
                scales.append(s)
    # the port gets the reference's codes and scales
    tk = [to_torch(np.asarray(a)) for a in jk]
    tv = [to_torch(np.asarray(a)) for a in jv]
    tks = [to_torch(np.asarray(a)) for a in jks]
    tvs = [to_torch(np.asarray(a)) for a in jvs]

    jx = JExecutor(cfg, params, kv_quant=kv_quant)
    x_ref, nk, nv, nks, nvs = jx._body(
        jk, jv, jks, jvs, jnp.asarray(b["tokens"]), jnp.asarray(b["seg"]),
        jnp.asarray(b["pos"]), jnp.asarray(b["widx"]),
        jnp.asarray(b["tables"]))

    tx = TExecutor(port_cfg(cfg), port_params(cfg, params),
                   device=torch.device("cpu"), kv_quant=kv_quant)
    rows = np.nonzero(b["widx"] < b["oob"])[0]
    with torch.no_grad():
        x = tx._body(tk, tv, tks, tvs, to_torch(b["tokens"]).long(),
                     to_torch(b["seg"]), to_torch(b["pos"]),
                     torch.from_numpy(rows),
                     torch.from_numpy(b["widx"][rows].astype(np.int64)),
                     to_torch(b["tables"]))
    live = b["seg"] >= 0
    np.testing.assert_allclose(to_numpy(x)[live], np.asarray(x_ref)[live],
                               **BODY_TOL)
    # the pools were updated in place with the same rows
    for ours, ref in zip(tk + tv + tks + tvs, nk + nv + nks + nvs):
        np.testing.assert_allclose(to_numpy(ours),
                                   np.asarray(ref, np.float32), **BODY_TOL)
