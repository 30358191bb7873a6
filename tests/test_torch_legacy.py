"""The port's KV-cache host write paths, ``gather`` and the legacy
serving engine against the JAX package.

* ``append``, ``write_batch``, ``write_prompt`` and ``gather``: one op
  sequence replayed on both packages' ``PagedKVCache`` (fp32, int8 and
  fp8 pools; ``gather`` dequantizes a quantized pool to fp32 in both);
* ``LegacyServingEngine``: greedy tokens identical to the reference's on
  the tiny config at fp32 where the reference is right (equal prompt
  lengths), identical to the port's unified engine and to the dense
  oracle at ragged lengths (where the reference's legacy engine attends
  a stale slot: see ``repro_torch/serving/legacy.py``), and the
  reference's preemption-resume case.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.kv_cache import PagedKVCache as JKV
from repro.serving.legacy import LegacyServingEngine as JLegacy
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import lm as TLM
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.kv_cache import PagedKVCache as TKV
from repro_torch.serving.legacy import LegacyServingEngine as TLegacy
from test_serving import dense_rollout
from test_torch_serving import _kv_state
from torch_port_helpers import (cuda_device, requires_cuda,  # noqa: F401
                                tiny_models, to_numpy, to_torch)


# ----------------------------------------------------------------------
# host write paths and gather
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8_e4m3"])
def test_write_paths_and_gather_match(kv_dtype):
    kw = dict(n_layers=2, n_kv_heads=2, head_dim=8, page_size=4,
              num_pages=16, kv_dtype=kv_dtype)
    jkv = JKV(dtype=jnp.float32, **kw)
    tkv = TKV(dtype=torch.float32, device="cpu", **kw)
    rng = np.random.default_rng(3)

    def layer_kv(n):
        return [tuple(rng.standard_normal((n, 2, 8)).astype(np.float32)
                      for _ in range(2)) for _ in range(2)]

    def both(fn_j, fn_t=None):
        a = fn_j(jkv)
        b = (fn_t or fn_j)(tkv)
        assert a == b
        assert _kv_state(jkv) == _kv_state(tkv)

    def as_j(lkv):
        return [(jnp.asarray(k), jnp.asarray(v)) for k, v in lkv]

    def as_t(lkv):
        return [(to_torch(k), to_torch(v)) for k, v in lkv]

    prompt = list(range(10))
    full = layer_kv(10)
    both(lambda kv: kv.create(0, prompt))
    both(lambda kv: kv.write_prompt(0, as_j(full), 10),
         lambda kv: kv.write_prompt(0, as_t(full), 10))
    # seq 1 shares seq 0's two full prompt pages: write_prompt skips them
    both(lambda kv: kv.create(1, prompt[:8] + [50, 51, 52]))
    share = layer_kv(11)
    both(lambda kv: kv.write_prompt(1, as_j(share), 11),
         lambda kv: kv.write_prompt(1, as_t(share), 11))
    for seq in (0, 1):
        one = [(k[0], v[0]) for k, v in layer_kv(1)]
        both(lambda kv: kv.append(seq, [(jnp.asarray(k), jnp.asarray(v))
                                        for k, v in one]),
             lambda kv: kv.append(seq, [(to_torch(k), to_torch(v))
                                        for k, v in one]))
    # an append inside a shared page copies it first (COW)
    both(lambda kv: kv.create(2, prompt[:8]))
    both(lambda kv: kv.truncate(2, 7))
    one = [(k[0], v[0]) for k, v in layer_kv(1)]
    both(lambda kv: kv.append(2, [(jnp.asarray(k), jnp.asarray(v))
                                  for k, v in one]),
         lambda kv: kv.append(2, [(to_torch(k), to_torch(v))
                                  for k, v in one]))
    assert tkv.pool.stats.cow_copies == 1
    # a span write across a page boundary
    both(lambda kv: kv.create(3, [9, 9, 9]))
    span = layer_kv(6)
    both(lambda kv: kv.write_batch(3, as_j(span), 1, 7),
         lambda kv: kv.write_batch(3, as_t(span), 1, 7))
    for layer in range(2):
        for seqs, pad_to in (([0, 1, 2, 3], None), ([3, 1], 16)):
            jk, jv, jl = jkv.gather(seqs, layer, pad_to=pad_to)
            tk, tv, tl = tkv.gather(seqs, layer, pad_to=pad_to)
            assert tk.is_contiguous() and tk.dtype == torch.float32
            np.testing.assert_allclose(to_numpy(tk), np.asarray(jk),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(to_numpy(tv), np.asarray(jv),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


# ----------------------------------------------------------------------
# the legacy engine
# ----------------------------------------------------------------------

def serve(eng, prompts, n_new):
    rids = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
    done = {r.req_id: r for r in eng.run()}
    assert len(done) == len(prompts)
    return [done[r].out_tokens for r in rids]


def test_legacy_tokens_identical_to_jax():
    """Equal prompt lengths (the reference's legacy engine is right
    there): greedy tokens identical, and the same prefill/step counts."""
    cfg, params, tcfg, tparams = tiny_models()
    prompts = [[(5 + 13 * i + j) % 97 for j in range(8)] for i in range(3)]
    kw = dict(page_size=4, num_pages=64, max_batch=4)
    jeng = JLegacy(cfg, params, **kw)
    teng = TLegacy(tcfg, tparams, device="cpu", **kw)
    assert serve(teng, prompts, 8) == serve(jeng, prompts, 8)
    for key in ("steps", "prefills", "decoded_tokens"):
        assert teng.metrics[key] == jeng.metrics[key]


def test_legacy_equals_unified_engine_at_ragged_lengths():
    """Ragged prompts and admission in waves (max_batch 2 of 5): the
    legacy engine's tokens equal the unified engine's and the dense
    oracle's."""
    cfg, params, tcfg, tparams = tiny_models()
    prompts = [[(7 + 11 * i + j) % 97 for j in range(n)]
               for i, n in enumerate((3, 8, 13, 5, 21))]
    kw = dict(page_size=4, num_pages=64, max_batch=2)
    legacy = serve(TLegacy(tcfg, tparams, device="cpu", **kw), prompts, 6)
    unified = serve(TEngine(tcfg, tparams, device="cpu", **kw), prompts, 6)
    assert legacy == unified
    for p, toks in zip(prompts[:2], legacy):
        assert toks == dense_rollout(cfg, params, p, 6)


def test_legacy_engine_resume_keeps_tokens():
    """tests/test_serving.py's case on the port: a pool too small for
    both final histories preempts mid-decode; the resumed request keeps
    its tokens and continues exactly."""
    cfg, params, tcfg, tparams = tiny_models()
    prompts = [[(5 + 13 * i + j) % 97 for j in range(8)] for i in range(2)]
    eng = TLegacy(tcfg, tparams, device="cpu", page_size=4, num_pages=6,
                  max_batch=2)
    out = serve(eng, prompts, 8)
    assert eng.metrics["prefills"] > len(prompts)      # a re-prefill
    for p, toks in zip(prompts, out):
        assert toks == dense_rollout(cfg, params, p, 8)
    pool = eng.kv.pool
    assert pool.num_free == pool.num_pages
    assert eng.stats()["pages_used"] == 0


def test_legacy_refuses_other_blocks_and_needs_cuda(monkeypatch):
    _, _, tcfg, tparams = tiny_models()
    moe = dataclasses.replace(tcfg, pattern=(TLM.BlockSpec("attn", "moe"),))
    with pytest.raises(ValueError):
        TLegacy(moe, tparams, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TLegacy(tcfg, tparams)


def test_legacy_cpu_launches_no_kernel():
    """On the CPU the wrappers take their plain versions: no kernel
    launch is counted."""
    _, _, tcfg, tparams = tiny_models()
    reset_launch_counts()
    serve(TLegacy(tcfg, tparams, device="cpu", page_size=4, num_pages=64),
          [[1, 2, 3, 4]], 3)
    assert not any(launch_counts().values())


@requires_cuda
def test_cuda_legacy_launches_flash_and_decode(cuda_device):
    """On the card: one flash launch per layer per prefill, one decode
    launch per layer per step, and the CPU's greedy tokens."""
    _, _, tcfg, tparams = tiny_models()
    prompts = [[(7 + 11 * i + j) % 97 for j in range(n)]
               for i, n in enumerate((3, 8, 13))]
    kw = dict(page_size=4, num_pages=64, max_batch=4)
    cpu = serve(TLegacy(tcfg, tparams, device="cpu", **kw), prompts, 6)
    eng = TLegacy(tcfg, tparams, device=cuda_device, **kw)
    reset_launch_counts()
    assert serve(eng, prompts, 6) == cpu
    counts = launch_counts()
    n = tcfg.n_layers
    assert counts["flash_attention"] == n * eng.metrics["prefills"]
    assert counts["decode_attention"] == n * eng.metrics["steps"]
