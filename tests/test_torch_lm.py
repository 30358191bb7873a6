"""The port's dense-cache path against the JAX package: the attention
layer with and without a cache, ``lm.forward``, ``lm.decode_step``
rollouts, and the step builders of ``launch/train.py``.

Inputs are made by numpy from a seed; the reference's parameters cross
through ``params_from_numpy``.  The reference runs its jnp oracle
(``attn_backend="ref"``) except where a case says ``auto``: there its
flash kernel runs in interpret mode, as the reference's own tests run it
on the CPU.  Tolerances at fp32: 2e-5 on outputs and logits of O(1) (the
serving tier of docs/kernels.md: the two frameworks sum the fp32 matmuls
in other orders, through every layer); greedy tokens identical;
prefill == decode at ``rollout_parity``'s 5e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma_2b as jgemma
from repro.configs import get_smoke_config as jsmoke
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import lm as JLM
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops as tops
from repro_torch.launch.train import make_prefill_step, make_serve_step
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from torch_port_helpers import (PARITY_RTOL, cuda_device,  # noqa: F401
                                greedy_rollouts, port_cfg, port_params,
                                port_rollout_parity, requires_cuda, tiny_cfg,
                                to_numpy, to_torch)

TOL = dict(rtol=2e-5, atol=2e-5)


def jax_cfg(which):
    if which == "tiny":
        return tiny_cfg()
    if which == "tiny_auto":
        return dataclasses.replace(tiny_cfg(), attn_backend="auto")
    if which == "tiny_mqa":
        return dataclasses.replace(tiny_cfg(), n_kv_heads=1)
    return jgemma.SMOKE


def attn_params(seed, d=32, hq=4, hkv=2, hd=16, bias=False, qk_norm=False):
    rng = np.random.default_rng(seed)
    p = {"wq": rng.standard_normal((d, hq * hd)) / np.sqrt(d),
         "wk": rng.standard_normal((d, hkv * hd)) / np.sqrt(d),
         "wv": rng.standard_normal((d, hkv * hd)) / np.sqrt(d),
         "wo": rng.standard_normal((hq * hd, d)) / np.sqrt(hq * hd)}
    if bias:
        p["bq"] = rng.standard_normal(hq * hd) * 0.1
        p["bk"] = rng.standard_normal(hkv * hd) * 0.1
        p["bv"] = rng.standard_normal(hkv * hd) * 0.1
    if qk_norm:
        p["q_norm"] = 1 + rng.standard_normal(hd) * 0.1
        p["k_norm"] = 1 + rng.standard_normal(hd) * 0.1
    return {k: v.astype(np.float32) for k, v in p.items()}


LAYER_CASES = {
    "plain": dict(),
    "qkv_bias": dict(bias=True),
    "q_norm": dict(qk_norm=True),
    "window": dict(window=5),
    "bidirectional_norope": dict(causal=False, rope_theta=None),
    "query_scale": dict(query_scale=0.3),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_attention_layer_prefill_matches_jax(case):
    kw = dict(LAYER_CASES[case])
    p = attn_params(1, bias=kw.pop("bias", False),
                    qk_norm=kw.pop("qk_norm", False))
    x = np.random.default_rng(2).standard_normal((2, 12, 32)).astype(
        np.float32)
    common = dict(n_heads=4, n_kv_heads=2, head_dim=16,
                  q_norm="q_norm" in p, **kw)
    exp, _ = JL.attention({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), backend="ref", **common)
    out, cache = TL.attention({k: to_torch(v) for k, v in p.items()},
                              to_torch(x), **common)
    assert cache is None
    np.testing.assert_allclose(to_numpy(out), np.asarray(exp), **TOL)


@pytest.mark.parametrize("window,cache_len", [(None, None), (4, None),
                                              (None, 6)])
@pytest.mark.parametrize("bias", [False, True])
def test_attention_layer_decode_matches_jax(bias, window, cache_len):
    """One decode token written at slot 5 of a partly filled cache; the
    port writes in place and returns the same tensors."""
    p = attn_params(3, bias=bias)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, 32)).astype(np.float32)
    kc = rng.standard_normal((2, 2, 10, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 2, 10, 16)).astype(np.float32)
    kc[:, :, 6:] = vc[:, :, 6:] = 0.0
    common = dict(n_heads=4, n_kv_heads=2, head_dim=16, window=window,
                  cache_pos=5, cache_len=cache_len)
    exp, jc = JL.attention({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), backend="ref",
                           cache={"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
                           **common)
    tcache = {"k": to_torch(kc), "v": to_torch(vc)}
    k_before = tcache["k"]
    out, nc = TL.attention({k: to_torch(v) for k, v in p.items()},
                           to_torch(x), cache=tcache, **common)
    np.testing.assert_allclose(to_numpy(out), np.asarray(exp), **TOL)
    assert nc["k"] is k_before
    np.testing.assert_allclose(to_numpy(nc["k"]), np.asarray(jc["k"]),
                               **TOL)
    np.testing.assert_allclose(to_numpy(nc["v"]), np.asarray(jc["v"]),
                               **TOL)


@pytest.mark.parametrize("which", ["tiny", "tiny_auto", "tiny_mqa",
                                   "gemma_smoke"])
def test_forward_matches_jax(which):
    """S = 128 >= the reference's _PALLAS_MIN_SEQ, so under ``auto`` the
    JAX side runs its flash kernel (interpret mode)."""
    cfg = jax_cfg(which)
    params = JLM.init_params(cfg, jax.random.key(5))
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 128)).astype(np.int32)
    exp, exp_aux = JLM.forward(cfg, params, jnp.asarray(toks))
    out, aux = TLM.forward(port_cfg(cfg), port_params(cfg, params),
                           torch.from_numpy(toks).long())
    assert tuple(out.shape) == (2, 128, cfg.vocab_size)
    np.testing.assert_allclose(to_numpy(out), np.asarray(exp), **TOL)
    assert float(aux) == float(exp_aux) == 0.0


@pytest.mark.parametrize("which", ["tiny", "tiny_mqa", "gemma_smoke"])
def test_decode_rollout_matches_jax(which):
    """4 prompt tokens fed one a step, then greedy: logits at every step
    within 2e-5 and 17 greedy tokens identical."""
    jl, tl, jt, tt = greedy_rollouts(jax_cfg(which), steps=20)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, **TOL)
    assert jt.shape[1] == 17
    np.testing.assert_array_equal(tt, jt)


@pytest.mark.parametrize("which", ["tiny", "tiny_mqa", "gemma_smoke"])
def test_port_prefill_equals_decode(which):
    """The port's own ``rollout_parity`` (tests/test_models_lm.py): the
    last prefill logits equal a decode_step rollout's, on the port's own
    random parameters."""
    tcfg = port_cfg(jax_cfg(which))
    tp = TLM.init_params(tcfg, seed=9, device="cpu")
    tokens = torch.randint(0, tcfg.vocab_size, (2, 10),
                           generator=torch.Generator().manual_seed(10))
    port_rollout_parity(tcfg, tp, tokens)


def test_untied_head_and_layer_norm_forward_matches_jax():
    cfg = dataclasses.replace(tiny_cfg(), tie_embeddings=False,
                              norm="layer", gated_mlp=False, act="relu")
    params = JLM.init_params(cfg, jax.random.key(11))
    toks = np.random.default_rng(12).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32)
    exp, _ = JLM.forward(cfg, params, jnp.asarray(toks))
    out, _ = TLM.forward(port_cfg(cfg), port_params(cfg, params),
                         torch.from_numpy(toks).long())
    np.testing.assert_allclose(to_numpy(out), np.asarray(exp), **TOL)


def test_step_builders_on_cpu():
    cfg = jgemma.SMOKE
    tcfg = port_cfg(cfg)
    tp = TLM.init_params(tcfg, seed=13, device="cpu")
    toks = torch.randint(0, tcfg.vocab_size, (2, 6),
                         generator=torch.Generator().manual_seed(14))
    prefill = make_prefill_step(tcfg, device="cpu")
    logits = prefill(tp, {"tokens": toks})
    torch.testing.assert_close(logits, TLM.forward(tcfg, tp, toks)[0],
                               rtol=0, atol=0)
    assert not logits.requires_grad

    serve = make_serve_step(tcfg, batch=2, max_seq=8,
                            cache_dtype=torch.float32, device="cpu")
    cache = TLM.init_cache(tcfg, 2, 8, torch.float32, device="cpu")
    for t in range(6):
        lg, cache = serve(tp, cache, toks[:, t:t + 1], t)
    torch.testing.assert_close(lg[:, 0], logits[:, -1], rtol=PARITY_RTOL,
                               atol=PARITY_RTOL)
    with pytest.raises(ValueError, match="outside the cache"):
        serve(tp, cache, toks[:, :1], 8)
    with pytest.raises(ValueError, match="built for"):
        serve(tp, TLM.init_cache(tcfg, 2, 9, torch.float32, device="cpu"),
              toks[:, :1], 0)


def test_default_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = port_cfg(jgemma.SMOKE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_prefill_step(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_serve_step(tcfg, batch=1, max_seq=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TLM.init_cache(tcfg, 1, 8)


def test_unported_features_raise():
    """What the port still refuses, as the reference does: an encoder's
    decode step, an unknown block or input mode, a head wider than every
    instantiated width."""
    enc = dataclasses.replace(port_cfg(tiny_cfg()), lm_head=False,
                              n_classes=5)
    with pytest.raises(ValueError, match="serve-tiny.*no decode step"):
        make_serve_step(enc, batch=1, max_seq=8, device="cpu")
    unknown = dataclasses.replace(
        port_cfg(tiny_cfg()), pattern=(TLM.BlockSpec("lstm", "dense"),))
    with pytest.raises(ValueError, match="unknown block"):
        make_prefill_step(unknown, device="cpu")
    with pytest.raises(ValueError, match="input_mode"):
        make_prefill_step(dataclasses.replace(port_cfg(tiny_cfg()),
                                              input_mode="audio"),
                          device="cpu")
    wide = torch.zeros((1, 1, 4, 320))
    with pytest.raises(ValueError, match="exceed"):
        TA.sdpa(wide, wide, wide, is_causal=True)


# ----------------------------------------------------------------------
# every mixer x FFN pair on a tiny config
# ----------------------------------------------------------------------

def grid_cfg(mixer, ffn):
    """The tiny serving config with one (mixer, ffn) block repeated over
    2 layers, and what that mixer and FFN need."""
    extra = {}
    if mixer == "sliding":
        extra = dict(window=3, rope_theta_local=1e3)
    elif mixer == "mla":
        extra = dict(q_lora_rank=32, kv_lora_rank=16, mla_nope_dim=16,
                     mla_rope_dim=8, mla_v_dim=16)
    elif mixer == "rwkv":
        extra = dict(rwkv_head_dim=32)
    if ffn == "moe":
        extra.update(n_experts=4, top_k=2)
    return dataclasses.replace(tiny_cfg(), pattern=(JLM.BlockSpec(mixer,
                                                                  ffn),),
                               **extra)


@pytest.mark.parametrize("ffn", TLM.FFNS)
@pytest.mark.parametrize("mixer", TLM.MIXERS)
def test_every_block_pair_matches_jax(mixer, ffn):
    """Forward logits within 2e-5, and a decode rollout (3 prompt tokens,
    3 greedy: past the sliding window of 3) with the same logits and
    tokens."""
    assert (mixer, ffn) in TLM.SUPPORTED_BLOCKS
    cfg = grid_cfg(mixer, ffn)
    params = JLM.init_params(cfg, jax.random.key(17))
    toks = np.random.default_rng(18).integers(
        0, cfg.vocab_size, (2, 10)).astype(np.int32)
    exp, exp_aux = JLM.forward(cfg, params, jnp.asarray(toks))
    out, aux = TLM.forward(port_cfg(cfg), port_params(cfg, params),
                           torch.from_numpy(toks).long())
    np.testing.assert_allclose(to_numpy(out), np.asarray(exp), **TOL)
    np.testing.assert_allclose(float(aux), float(exp_aux), rtol=1e-5,
                               atol=1e-7)
    jl, tl, jt, tt = greedy_rollouts(cfg, steps=6, prompt=3, max_seq=8)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, **TOL)
    np.testing.assert_array_equal(tt, jt)


# ----------------------------------------------------------------------
# head widths the kernels lack: padded, exact
# ----------------------------------------------------------------------

PAD_CASES = {"hubert_80": (80, 80, False), "mla_96_64": (96, 64, True),
             "hubert_80_causal": (80, 80, True)}


def pad_case(d_qk, d_v, seed=19, b=2, hq=4, hkv=2, s=11):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, s, d_qk)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d_qk)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d_v)).astype(np.float32)
    return to_torch(q), to_torch(k), to_torch(v)


def test_padded_width_picks_the_next_instantiated_width():
    assert TA.padded_width(64, 64) is None
    assert TA.padded_width(80, 80) == 128
    assert TA.padded_width(96, 64) == 128
    assert TA.padded_width(16, 8) == 16
    assert TA.padded_width(128, 64) == 128
    with pytest.raises(ValueError, match="exceed"):
        TA.padded_width(320, 320)


@pytest.mark.parametrize("case", sorted(PAD_CASES))
def test_padded_sdpa_matches_the_unpadded_oracle(monkeypatch, case):
    """sdpa at widths 80 and 96 / 64: the flash function sees the padded
    width 128, and the result equals sdpa_ref at the caller's width (the
    default scale is the caller's width's)."""
    d_qk, d_v, causal = PAD_CASES[case]
    q, k, v = pad_case(d_qk, d_v)
    widths = []
    real = tops.flash_attention_fwd

    def spy(q_, k_, v_, **kw):
        widths.append((q_.shape[-1], k_.shape[-1], v_.shape[-1]))
        return real(q_, k_, v_, **kw)

    monkeypatch.setattr(tops, "flash_attention_fwd", spy)
    out = TA.sdpa(q, k, v, is_causal=causal)
    assert widths == [(128, 128, 128)]
    assert tuple(out.shape) == tuple(q.shape[:3]) + (d_v,)
    # the oracle at the caller's width: logits q.k, then P @ v
    scale = d_qk ** -0.5
    kk, vv = TA.repeat_kv(k, 2), TA.repeat_kv(v, 2)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, kk) * scale
    if causal:
        logits = logits.masked_fill(
            ~FA.visible_mask(11, 11, True, None, "cpu"),
            torch.finfo(torch.float32).min)
    exp = torch.softmax(logits, -1) @ vv
    torch.testing.assert_close(out, exp, rtol=1e-6, atol=1e-6)
    if d_qk == d_v:
        torch.testing.assert_close(
            out, TA.sdpa_ref(q, k, v, is_causal=causal), rtol=1e-6,
            atol=1e-6)


@pytest.mark.parametrize("case", ["hubert_80", "mla_96_64"])
def test_padded_decode_matches_the_unpadded_oracle(case):
    d_qk, d_v, _ = PAD_CASES[case]
    q, k, v = pad_case(d_qk, d_v)
    lens = torch.tensor([7, 11])
    out = TA.decode_attention(q[:, :, :1], k, v, lens)
    assert tuple(out.shape) == (2, 4, 1, d_v)
    kk, vv = TA.repeat_kv(k, 2), TA.repeat_kv(v, 2)
    logits = torch.einsum("bhqd,bhkd->bhqk", q[:, :, :1], kk) * d_qk ** -0.5
    live = torch.arange(11)[None, :] < lens[:, None]
    logits = logits.masked_fill(~live[:, None, None],
                                torch.finfo(torch.float32).min)
    exp = torch.softmax(logits, -1) @ vv
    torch.testing.assert_close(out, exp, rtol=1e-6, atol=1e-6)


def test_padded_sdpa_gradients_are_the_unpadded_ones():
    q, k, v = (x.requires_grad_() for x in pad_case(96, 64))
    TA.sdpa(q, k, v, is_causal=True).square().sum().backward()
    got = [x.grad.clone() for x in (q, k, v)]
    for x in (q, k, v):
        x.grad = None
    kk, vv = TA.repeat_kv(k, 2), TA.repeat_kv(v, 2)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, kk) * 96 ** -0.5
    logits = logits.masked_fill(
        ~FA.visible_mask(11, 11, True, None, "cpu"),
        torch.finfo(torch.float32).min)
    (torch.softmax(logits, -1) @ vv).square().sum().backward()
    for a, x in zip(got, (q, k, v)):
        torch.testing.assert_close(a, x.grad, rtol=1e-5, atol=1e-6)


def mla_params(seed, d=64, h=4, q_rank=32, kv_rank=16, nope=16, rope=8,
               vd=16):
    rng = np.random.default_rng(seed)

    def w(i, o):
        return (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)

    return {"wq_a": w(d, q_rank), "wq_b": w(q_rank, h * (nope + rope)),
            "wkv_a": w(d, kv_rank + rope), "wkv_b": w(kv_rank,
                                                      h * (nope + vd)),
            "q_norm": (1 + rng.standard_normal(q_rank) * 0.1).astype(
                np.float32),
            "kv_norm": (1 + rng.standard_normal(kv_rank) * 0.1).astype(
                np.float32),
            "wo": w(h * vd, d)}


MLA_KW = dict(n_heads=4, nope_dim=16, rope_dim=8, v_dim=16,
              kv_lora_rank=16)


def test_mla_at_s160_matches_the_reference_ref_backend():
    """S = 160 >= 128, where the reference's own ``auto`` path raises
    (ROADMAP.md C); the port computes it, and equals the reference's jnp
    path."""
    p = mla_params(20)
    x = np.random.default_rng(21).standard_normal((2, 160, 64)).astype(
        np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    exp, _ = JL.mla_attention(jp, jnp.asarray(x), backend="ref", **MLA_KW)
    out, _ = TL.mla_attention({k: to_torch(v) for k, v in p.items()},
                              to_torch(x), **MLA_KW)
    np.testing.assert_allclose(to_numpy(out), np.asarray(exp), **TOL)
    with pytest.raises(TypeError, match="reshape"):
        JL.mla_attention(jp, jnp.asarray(x[:, :128]), backend="auto",
                         **MLA_KW)


def test_mla_decode_writes_the_latent_cache_like_jax():
    p = mla_params(22)
    rng = np.random.default_rng(23)
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    c_kv = rng.standard_normal((2, 12, 16)).astype(np.float32)
    k_rope = rng.standard_normal((2, 1, 12, 8)).astype(np.float32)
    c_kv[:, 8:] = k_rope[:, :, 8:] = 0.0
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    exp, jc = JL.mla_attention(
        jp, jnp.asarray(x), cache={"c_kv": jnp.asarray(c_kv),
                                   "k_rope": jnp.asarray(k_rope)},
        cache_pos=7, backend="ref", **MLA_KW)
    tc = {"c_kv": to_torch(c_kv), "k_rope": to_torch(k_rope)}
    before = tc["c_kv"]
    out, nc = TL.mla_attention({k: to_torch(v) for k, v in p.items()},
                               to_torch(x), cache=tc, cache_pos=7, **MLA_KW)
    np.testing.assert_allclose(to_numpy(out), np.asarray(exp), **TOL)
    assert nc["c_kv"] is before
    for name in ("c_kv", "k_rope"):
        np.testing.assert_allclose(to_numpy(nc[name]), np.asarray(jc[name]),
                                   **TOL)


def test_sdpa_backends_and_mask_on_cpu():
    """Every backend matches the oracles called by name on the CPU; an
    explicit mask takes sdpa_masked there and matches the reference's
    sdpa_ref with the same mask; unknown backends raise."""
    rng = np.random.default_rng(15)
    q = rng.standard_normal((2, 4, 9, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 9, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 9, 16)).astype(np.float32)
    mask = rng.random((2, 1, 9, 9)) > 0.3
    mask[..., 0] = True
    t = to_torch
    oracle = TA.sdpa_ref(t(q), t(k), t(v), is_causal=True, window=4)
    for backend in TA.BACKENDS:
        torch.testing.assert_close(
            TA.sdpa(t(q), t(k), t(v), is_causal=True, window=4,
                    backend=backend), oracle, rtol=1e-6, atol=1e-6)
    exp = JA.sdpa_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      mask=jnp.asarray(mask), is_causal=True)
    out = TA.sdpa(t(q), t(k), t(v), mask=torch.from_numpy(mask),
                  is_causal=True)
    np.testing.assert_allclose(to_numpy(out), np.asarray(exp), **TOL)
    with pytest.raises(ValueError):
        TA.sdpa(t(q), t(k), t(v), backend="triton")
    with pytest.raises(ValueError):
        TA.decode_attention(t(q[:, :, :1]), t(k), t(v), 5, backend="jnp")
    qd = t(q[:, :, :1])
    oracle = DA.decode_attention_plain(
        qd.reshape(2, 2, 2, 16), t(k), t(v), torch.full((2,), 5),
        scale=16 ** -0.5).reshape(2, 4, 1, 16)
    for backend in TA.BACKENDS:
        torch.testing.assert_close(
            TA.decode_attention(qd, t(k), t(v), 5, backend=backend), oracle,
            rtol=0, atol=0)
    np.testing.assert_array_equal(to_numpy(TA.repeat_kv(t(k), 2)),
                                  np.asarray(JA.repeat_kv(jnp.asarray(k),
                                                          2)))


def _spy_kernels(monkeypatch):
    """Count the calls that reach the flash and decode kernel functions
    behind ``kernels.ops`` (the plain versions run under them on the
    CPU, the kernels on the card)."""
    calls = {"flash": 0, "decode": 0}

    def spy(key, fn):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(tops, "flash_attention_fwd",
                        spy("flash", tops.flash_attention_fwd))
    monkeypatch.setattr(tops, "decode_attention_fwd",
                        spy("decode", tops.decode_attention_fwd))
    return calls


@pytest.mark.parametrize("backend", ["auto", "pallas", "ref"])
def test_every_backend_goes_through_the_kernels(monkeypatch, backend):
    """The config's attn_backend selects nothing: prefill and decode go
    through the kernel functions once per layer whatever it says, so no
    config runs plain attention on the card."""
    tcfg = dataclasses.replace(port_cfg(jgemma.SMOKE), attn_backend=backend)
    tp = TLM.init_params(tcfg, seed=13, device="cpu")
    toks = torch.randint(0, tcfg.vocab_size, (2, 5),
                         generator=torch.Generator().manual_seed(14))
    calls = _spy_kernels(monkeypatch)
    make_prefill_step(tcfg, device="cpu")(tp, {"tokens": toks})
    assert calls == {"flash": tcfg.n_layers, "decode": 0}
    serve = make_serve_step(tcfg, batch=2, max_seq=8,
                            cache_dtype=torch.float32, device="cpu")
    cache = TLM.init_cache(tcfg, 2, 8, torch.float32, device="cpu")
    for t in range(3):
        _, cache = serve(tp, cache, toks[:, t:t + 1], t)
    assert calls == {"flash": tcfg.n_layers, "decode": 3 * tcfg.n_layers}
    with pytest.raises(ValueError, match="backend"):
        make_prefill_step(dataclasses.replace(tcfg, attn_backend="jnp"),
                          device="cpu")(tp, {"tokens": toks})


def _to_device(p, dev):
    if isinstance(p, dict):
        return {k: _to_device(v, dev) for k, v in p.items()}
    if isinstance(p, list):
        return [_to_device(v, dev) for v in p]
    return p.to(dev)


@requires_cuda
def test_cuda_smoke_steps_launch_the_kernels(cuda_device):
    """gemma SMOKE (attn_backend "ref") on the card: the prefill launches
    the flash kernel and each decode step the decode kernel once per
    layer, and both agree with the same steps on the CPU."""
    tcfg = port_cfg(jgemma.SMOKE)
    assert tcfg.attn_backend == "ref"
    toks = torch.randint(0, tcfg.vocab_size, (2, 6),
                         generator=torch.Generator().manual_seed(14))
    cpu_params = TLM.init_params(tcfg, seed=13, device="cpu")
    outs = {}
    for dev in ("cpu", cuda_device):
        tp = _to_device(cpu_params, dev)
        flash0, decode0 = FA.counter.launches, DA.decode_counter.launches
        logits = make_prefill_step(tcfg, device=dev)(
            tp, {"tokens": toks.to(dev)})
        serve = make_serve_step(tcfg, batch=2, max_seq=8,
                                cache_dtype=torch.float32, device=dev)
        cache = TLM.init_cache(tcfg, 2, 8, torch.float32, device=dev)
        for t in range(6):
            lg, cache = serve(tp, cache, toks[:, t:t + 1].to(dev), t)
        outs[str(dev)] = (logits.cpu(), lg.cpu())
        launched = (FA.counter.launches - flash0,
                    DA.decode_counter.launches - decode0)
        assert launched == ((0, 0) if dev == "cpu"
                            else (tcfg.n_layers, 6 * tcfg.n_layers))
    for a, b in zip(outs["cpu"], outs["cuda"]):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)


# ----------------------------------------------------------------------
# the new paths on the card: kernel against plain version
# ----------------------------------------------------------------------

@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g_heads,hkv", [(7, 8), (1, 16)])
def test_cuda_decode_at_the_new_groupings(cuda_device, g_heads, hkv, dtype):
    """yi / arctic's 56 query heads over 8 (G = 7, an m16 tile with 9
    idle rows) and qwen2-moe's 16 over 16 (G = 1), head width 128, ragged
    lengths up to a 1040-slot cache."""
    gen = torch.Generator(device=cuda_device).manual_seed(g_heads)
    b, smax, hd = 8, 1040, 128
    q = torch.randn((b, hkv * g_heads, 1, hd), generator=gen,
                    device=cuda_device).to(dtype)
    kc = torch.randn((b, hkv, smax, hd), generator=gen,
                     device=cuda_device).to(dtype)
    vc = torch.randn((b, hkv, smax, hd), generator=gen,
                     device=cuda_device).to(dtype)
    lens = torch.tensor([1, 127, 128, 129, 500, 1024, 1039, 1040],
                        dtype=torch.int32, device=cuda_device)
    before = DA.decode_counter.launches
    out = TA.decode_attention(q, kc, vc, lens)
    torch.cuda.synchronize()
    assert DA.decode_counter.launches == before + 1
    exp = DA.decode_attention_plain(
        q.reshape(b, hkv, g_heads, hd), kc, vc, lens, scale=hd ** -0.5
    ).reshape(b, hkv * g_heads, 1, hd)
    tol = 1e-2 if dtype == torch.bfloat16 else 2e-3
    torch.testing.assert_close(out.float(), exp.float(), rtol=tol, atol=tol)


@requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["hubert_80", "mla_96_64",
                                  "hubert_80_causal"])
def test_cuda_padded_flash_matches_plain(cuda_device, case, dtype):
    """hubert's bidirectional attention at width 80 and MLA's 96 / 64,
    padded to 128 on the card: one flash launch, equal to the plain
    version at the caller's width."""
    d_qk, d_v, causal = PAD_CASES[case]
    q, k, v = (x.to(cuda_device, dtype) for x in
               pad_case(d_qk, d_v, b=2, hq=16, hkv=16, s=300))
    before = FA.counter.launches
    out = TA.sdpa(q, k, v, is_causal=causal)
    torch.cuda.synchronize()
    assert FA.counter.launches == before + 1
    assert tuple(out.shape) == (2, 16, 300, d_v)
    exp = TA.sdpa(*(x.cpu().float() for x in (q, k, v)), is_causal=causal)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float().cpu(), exp, rtol=tol, atol=tol)


@requires_cuda
@pytest.mark.parametrize("unsupported", ["width", "dtype"])
def test_cuda_wrappers_raise_rather_than_fall_back(cuda_device, unsupported):
    """On a CUDA tensor a wrapper launches or raises: a width no kernel
    holds and a dtype none takes are refused, never sent to the plain
    version."""
    q = torch.zeros((1, 2, 4, 80 if unsupported == "width" else 64),
                    device=cuda_device,
                    dtype=torch.float16 if unsupported == "dtype"
                    else torch.float32)
    with pytest.raises((ValueError, TypeError)):
        tops.flash_attention(q, q, q, causal=True)
    with pytest.raises((ValueError, TypeError)):
        tops.decode_attention(q[:, :, :1], q, q, 4)


@requires_cuda
def test_cuda_mla_prefill_and_decode_match_the_cpu(cuda_device):
    """MLA at S = 160 (flash over q/k 24 wide and v 16, padded to 32),
    then 4 decode steps over its latent cache (the decode kernel at G =
    1), on the card against the CPU."""
    p = mla_params(24)
    x = np.random.default_rng(25).standard_normal((2, 164, 64)).astype(
        np.float32)
    outs = {}
    for dev in ("cpu", cuda_device):
        tp = {k: to_torch(v).to(dev) for k, v in p.items()}
        xt = to_torch(x).to(dev)
        pre, _ = TL.mla_attention(tp, xt[:, :160], **MLA_KW)
        cache = {"c_kv": torch.zeros((2, 170, 16), device=dev),
                 "k_rope": torch.zeros((2, 1, 170, 8), device=dev)}
        steps = []
        for t in range(164):
            o, cache = TL.mla_attention(tp, xt[:, t:t + 1], cache=cache,
                                        cache_pos=t, **MLA_KW)
            steps.append(o)
        outs[str(dev)] = (pre.cpu(), torch.cat(steps, 1).cpu())
    for a, b in zip(outs["cpu"], outs["cuda"]):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)
    # the decode rollout's first 160 steps are the prefill
    torch.testing.assert_close(outs["cpu"][1][:, :160], outs["cpu"][0],
                               rtol=1e-4, atol=1e-4)


@requires_cuda
@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2-moe-a2.7b",
                                  "minicpm3-4b", "llava-next-mistral-7b",
                                  "hubert-xlarge", "yi-34b", "arctic-480b"])
def test_cuda_new_arch_smoke_matches_the_cpu(cuda_device, arch):
    """Each new arch's SMOKE (fp32) on the card against the CPU: prefill
    through the step builder (one flash launch per attention layer), and
    for the decoders 20 greedy steps with 4-token prompts (one decode
    launch per layer a step; gemma3's rings of 8 wrap twice), tokens
    identical.  yi's and arctic's SMOKE run G = 7, qwen2-moe's and
    minicpm3's G = 1."""
    tcfg = port_cfg(jsmoke(arch))
    cpu_params = TLM.init_params(tcfg, seed=26, device="cpu")
    rng = np.random.default_rng(27)
    if tcfg.input_mode == "embeddings":
        batch = {"embeds": torch.from_numpy(rng.standard_normal(
            (2, 40, tcfg.d_model)).astype(np.float32))}
    else:
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, tcfg.vocab_size, (2, 40)))}
    prompt = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (2, 4)))
    outs = {}
    for dev in ("cpu", cuda_device):
        tp = _to_device(cpu_params, dev)
        flash0, decode0 = FA.counter.launches, DA.decode_counter.launches
        logits = make_prefill_step(tcfg, device=dev)(
            tp, {k: v.to(dev) for k, v in batch.items()})
        got = [logits.cpu()]
        if tcfg.lm_head:
            serve = make_serve_step(tcfg, batch=2, max_seq=24,
                                    cache_dtype=torch.float32, device=dev)
            cache = TLM.init_cache(tcfg, 2, 24, torch.float32, device=dev)
            tok = prompt.to(dev)
            cur = tok[:, :1]
            for t in range(20):
                lg, cache = serve(tp, cache, cur, t)
                cur = (tok[:, t + 1:t + 2] if t + 1 < 4
                       else lg[:, -1].argmax(-1, keepdim=True))
                got.append(cur.cpu())
        outs[str(dev)] = got
        launched = (FA.counter.launches - flash0,
                    DA.decode_counter.launches - decode0)
        steps = 20 if tcfg.lm_head else 0
        assert launched == ((0, 0) if dev == "cpu" else
                            (tcfg.n_layers, steps * tcfg.n_layers))
    torch.testing.assert_close(outs["cuda"][0], outs["cpu"][0], rtol=1e-4,
                               atol=1e-4)
    for a, b in zip(outs["cpu"][1:], outs["cuda"][1:]):
        assert torch.equal(a, b)
