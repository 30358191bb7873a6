#!/usr/bin/env python3
"""Parent against change, on one card: one family of kernels of two
checkouts of the port, measured in turns.

    python3 tools/kernel_ab.py --parent DIR [--kernels KIND] [--out FILE]

DIR is another checkout of this repository (an unpacked ``git archive``
of the parent commit, say).  The script runs four turns, parent, this
tree, this tree, parent, each a process of its own that imports that
tree's ``repro_torch`` (built into that tree's ``build/``) and this
tree's ``chip_smoke`` helpers, so both trees are measured by the same
code.  KIND picks the rows a turn measures:

``attention`` (the default), on the paged row's inputs
(``chip_smoke.paged_inputs``, seed 11):

  * the paged kernel on every ``PAGED_CASES`` row: the SHA-256 of its
    output's bytes, a single call's ms by CUDA events, and the device us
    a call of its pre-pass, main kernel and combine and in all
    (``profile_kernels``);
  * the mixed kernel on every ``MIXED_ROWS`` row: the SHA-256 of its
    output, a single call's ms, SDPA's ms on the same inputs, and the
    device us a call of each of its kernels (pre-pass, main, combine);
  * gemma-2b's fp32 greedy serving runs, without and with speculation
    (``spec_k`` = ``SPEC_K``): wall seconds, tokens/s, steps, paged
    launches, and whether the two runs' tokens are equal.

  The summary says, row by row, whether the outputs of every turn are
  the same bits, whether the two trees' paged libraries hold the same
  machine code (``cuobjdump -sass``, the source file's hash in the
  kernel names masked), and whether the machine code of each bf16 mixed
  kernel of the parent's library (pre-pass, "mma" main kernel, bf16
  combine) is among the change's; the script exits non-zero when the
  bits of a bf16 paged row or of a bf16 mixed row differ between any two
  turns, those of an fp32 paged row or an fp32-cache mixed row between
  the two turns of one tree, or the fp32 serving run with speculation
  draws other tokens than without.

``gumbel``: at ``GUMBEL_SHAPE``, the parent's serving path
(``position_uniforms`` then the uniform kernel), the uniform kernel and,
where the tree has it, the keyed kernel: each one's max abs error against
the plain perturbation, a single call's ms, the host us a call and the
device us and launches a call (``profile_kernels``: every kernel of the
parent's path); then gemma-2b's bf16 serving run (tokens/s) and its
profile (``profile_serving``: the sampling tail's device ms and launches
a step; a tree whose executor has no ``sampling`` range gets one around
``sample_tokens``, so both trees are read alike).

``wkv6``: the WKV6 kernel on every ``RWKV6_ROWS`` row (its max abs error
against the plain version, which must be within ``kernel_tol``, a single
call's ms, the device us a call), then ``rwkv_prefill`` and
``rwkv_decode`` on rwkv6-1.6b and their profiles (tokens/s, ms a step,
busy and wall ms, idle share, WKV6 device ms).

``mamba``: the Mamba scan on every ``MAMBA_ROWS`` row (its max abs error
against the plain version within ``kernel_tol``, the final state's, a
single call's ms, the device us a launch), then ``jamba_prefill`` and
``jamba_decode`` on jamba-1.5-large's first 5 layers and their profiles
(Mamba device ms), and ``jamba_parity``.

``fused``: the fused-elementwise kernel on every ``FUSED_ROWS`` row (its
max abs error within ``FUSED_TOL``, the device ms of 20 calls queued, a
single call's ms, the host us a call, the device us a launch by the
profiler, and the relu row's turns against ``torch.relu``), then
``eager_train`` (ResNet-50) and its profile (fused device ms a step).

``dense32``: the dense-cache path's kernels.  Every ``FLASH_ROWS`` and
``DECODE_ROWS`` row: the SHA-256 of its output and a single call's ms;
the fp32 rows also SDPA's ms on the same inputs, and the device us a
call of the kernel (each of its kernels) and of SDPA (by kernel name,
``profile_kernels``).  Then ``dense_parity`` (gemma-2b) and
``jamba_parity``: wall seconds, ``err_over_rms`` and launches.  The
summary says whether the bf16 rows are the same bits in all four turns
and the fp32 rows within each tree's two turns (the script exits
non-zero when not), and whether the machine code of every bf16 kernel
of the parent's flash and decode libraries is among the change's
(``cuobjdump -sass``, names aside).

It prints each turn's JSON line, then a summary with each number of the
four turns side by side.  Needs one CUDA card and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(tree: str, kernels: str) -> dict:
    """One turn: the measurements of ``tree``'s kernels of one kind."""
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch
    from repro_torch.kernels import _build
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    rows = {"attention": measure_attention, "gumbel": measure_gumbel,
            "wkv6": measure_wkv6, "mamba": measure_mamba,
            "fused": measure_fused, "dense32": measure_dense32}[kernels](
                torch, cs)
    return {"tree": tree, "card": cs.smi_line(), **rows}


def sha256(torch, out) -> str:
    return hashlib.sha256(out.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


def measure_attention(torch, cs) -> dict:
    from repro_torch.kernels import decode_attention as DA

    x = cs.paged_inputs(torch, torch.Generator().manual_seed(11), "cuda")
    paged, paged_kerns = {}, {}
    for q_dtype, pool in cs.PAGED_CASES:
        q, kp, vp, ksc, vsc = cs.paged_case_tensors(torch, x, q_dtype, pool)

        def kern(q=q, kp=kp, vp=vp, ksc=ksc, vsc=vsc):
            return DA.paged_attention_fwd(
                q, kp, vp, x["tables"], x["seg"], x["pos"],
                scale=256 ** -0.5, k_scale=ksc, v_scale=vsc)
        out = kern()
        torch.cuda.synchronize()
        key = f"{q_dtype}x{pool}"
        paged[key] = {"sha256": sha256(torch, out),
                      "ms": cs.time_ms(torch, kern)}
        paged_kerns[key] = kern

    xm, caches = cs.mixed_inputs(torch, "cuda")
    mixed, mixed_kerns = {}, {}
    for spec in cs.MIXED_ROWS:
        label, window = spec[0], spec[6]
        q, kc, vc = cs.mixed_row_tensors(torch, "cuda", xm, caches, spec)
        kw = dict(scale=spec[5] ** -0.5, window=window)

        def kern(q=q, kc=kc, vc=vc, kw=kw):
            return DA.mixed_attention_fwd(q, kc, vc, xm["seg"], xm["pos"],
                                          **kw)
        out = kern()
        torch.cuda.synchronize()
        mixed[label] = {
            "q_dtype": spec[1], "cache_dtype": spec[2],
            "sha256": sha256(torch, out),
            "ms": cs.time_ms(torch, kern),
            "sdpa_ms": cs.mixed_library_ms(torch, q, kc, vc, xm["seg"],
                                           xm["pos"], window, kw["scale"])}
        mixed_kerns[label] = kern

    serving = fp32_serving(torch, cs)

    # the profiled readings last: a profiler session slows what follows
    for key, kern in paged_kerns.items():
        kern()
        prof = cs.profile_kernels(torch, kern, DA.counter, "paged_attention",
                                  DA.last_launch()["device_launches"],
                                  part=cs.kernel_part)
        paged[key]["device_us"] = prof["device_us_per_call"]
        paged[key]["parts_us"] = {
            k: v["device_us_per_call"] for k, v in prof["kernels"].items()}
        paged[key]["device_launches"] = prof["device_launches_per_call"]
        paged[key]["sessions"] = len(prof["sessions"])
    for label, kern in mixed_kerns.items():
        kern()
        want = (DA.mixed_last_launch()["device_launches"]
                if hasattr(DA, "mixed_last_launch") else 1)
        prof = cs.profile_kernels(torch, kern, DA.mixed_counter,
                                  "mixed_attention", want,
                                  part=cs.kernel_part)
        mixed[label]["device_us"] = prof["device_us_per_call"]
        mixed[label]["parts_us"] = {
            k: v["device_us_per_call"] for k, v in prof["kernels"].items()}
        mixed[label]["sessions"] = len(prof["sessions"])
    return {"paged": paged, "mixed": mixed, "serving": serving,
            "paged_library": DA._lib()._name,
            "mixed_library": DA._mixed_lib()._name}


def fp32_serving(torch, cs, dev: str = "cuda") -> dict:
    """The fp32 greedy serving runs of ``chip_smoke.phase_serving``."""
    cfg32, params32, _, _ = cs.gemma_models(torch, dev)
    cs.free(torch)
    requests = [r for r in cs.serving_requests(torch, cfg32) if r[2].greedy]
    runs, tokens = {}, {}
    for name, kw in (("fp32_greedy", {}),
                     ("fp32_greedy_spec2", {"spec_k": cs.SPEC_K})):
        (outs, wall, m), counts = cs.counted(
            torch, name, lambda: cs.run_engine(torch, cfg32, params32,
                                               requests, dev, **kw))
        tokens[name] = outs
        runs[name] = {"wall_s": wall,
                      "tokens_per_s": sum(n for _, n, _ in requests) / wall,
                      "steps": m["steps"],
                      "paged_launches": counts["paged_attention"]}
    runs["spec2_equals_spec0"] = (tokens["fp32_greedy"]
                                  == tokens["fp32_greedy_spec2"])
    del params32
    cs.free(torch)
    return runs


def measure_gumbel(torch, cs, dev: str = "cuda") -> dict:
    import inspect

    from repro_torch.kernels import ops
    from repro_torch.serving import executor, sampling

    rows, vocab = cs.GUMBEL_SHAPE
    logits, seeds, pos = cs.gumbel_inputs(torch, dev, rows, vocab)
    u = sampling.position_uniforms(seeds, pos, vocab)
    ref = ops.gumbel_perturb_plain(logits, u)
    entries = {
        "composition": (lambda: ops.gumbel_perturb(
            logits, sampling.position_uniforms(seeds, pos, vocab)),
            None, None),
        "uniform": (lambda: ops.gumbel_perturb(logits, u),
                    "gumbel_perturb", 1)}
    if hasattr(ops, "gumbel_perturb_keyed"):
        entries["keyed"] = (lambda: ops.gumbel_perturb_keyed(
            logits, seeds, pos), "gumbel_perturb", 1)
    gumbel = {}
    for label, (fn, _, _) in entries.items():
        out = fn()
        torch.cuda.synchronize()
        gumbel[label] = {
            "max_abs_err": cs.gumbel_check(torch, label, out, ref),
            "ms": cs.time_ms(torch, fn), "host_us": cs.host_us(torch, fn)}
        del out

    if 'record_function("sampling")' not in inspect.getsource(executor):
        sample_tokens = sampling.sample_tokens

        def ranged(*args, **kw):
            with torch.profiler.record_function(cs.SAMPLING_RANGE):
                return sample_tokens(*args, **kw)
        sampling.sample_tokens = ranged
    _, _, cfg, params = cs.gemma_models(torch, dev)
    cs.free(torch)
    requests = cs.serving_requests(torch, cfg)
    (_, wall, m), counts = cs.counted(
        torch, "the bf16 serving run",
        lambda: cs.run_engine(torch, cfg, params, requests, dev))
    model = {"serving": {
        "tokens_per_s": sum(n for _, n, _ in requests) / wall,
        "steps": m["steps"], "launches": counts}}
    # the profiler sessions last: they slow the host for timed runs after
    for label, (fn, group, want) in entries.items():
        prof = cs.profile_kernels(torch, fn, ops.gumbel_counter, group,
                                  want)
        gumbel[label]["device_us"] = prof["device_us_per_call"]
        gumbel[label]["device_launches"] = prof["device_launches_per_call"]
        gumbel[label]["sessions"] = len(prof["sessions"])
    prof = cs.profile_serving(torch, cfg, params, requests, dev)
    model["serving_profile"] = {
        k: prof[k] for k in ("wall_ms", "device_busy_ms",
                             "device_idle_share", "steps", "sampling")}
    return {"gumbel": gumbel, "model": model}


def measure_wkv6(torch, cs, dev: str = "cuda") -> dict:
    from repro_torch.kernels import rwkv6 as RW
    rows, kerns = {}, {}
    for label, dt, b, h, s, d, state, decays in cs.RWKV6_ROWS:
        args = cs.rwkv6_inputs(torch, dev, dt, b, h, s, d, state, decays)
        out, st = RW.rwkv6_scan_fwd(*args)
        ref, ref_st = RW.rwkv6_scan_plain(*args)
        kerns[label] = lambda args=args: RW.rwkv6_scan_fwd(*args)
        rows[label] = {
            **cs.check_row(torch, f"rwkv6_scan[{label}]", out, ref,
                           cs.kernel_tol(dt, s)),
            "state_max_abs_err": (st - ref_st).abs().max().item(),
            "ms": cs.time_ms(torch, kerns[label])}
    # the model phases' lines, kept instead of printed
    lines = []
    cs.emit = lines.append
    _, _, cfg, params = cs.rwkv_models(torch, dev)
    _, prefill_profile = cs.phase_prefill(torch, dev, cfg, params,
                                          "rwkv_prefill", 31)
    _, decode_profile = cs.phase_decode_steps(torch, dev, cfg, params,
                                              "rwkv_decode", 32)
    # the profiler sessions last: they slow the host for timed runs after
    for label, kern in kerns.items():
        prof = cs.profile_kernels(torch, kern, RW.counter, "rwkv6_scan", 1)
        rows[label]["device_us"] = prof["device_us_per_call"]
        rows[label]["sessions"] = len(prof["sessions"])
    prefill_profile(params)
    decode_profile(params)
    return {"wkv6": rows, "model": model_lines(lines, "rwkv6_scan")}


def model_lines(lines: list, group: str) -> dict:
    """The model phases' numbers from their captured lines, with the
    device ms of kernel ``group`` where a profile line has it."""
    model = {}
    for line in lines:
        if "phase" not in line:
            continue
        # the eager profile files the Triton kernel, which no host op
        # launches in the profiler's view, under "unlinked:<group>"
        groups = line.get("device_ms_by_group", {})
        ms = groups.get(group, groups.get(f"unlinked:{group}"))
        model[line["phase"]] = {
            k: line[k] for k in ("tokens_per_s", "decode_tokens_per_s",
                                 "wall_ms", "wall_s", "ms_per_step",
                                 "device_busy_ms", "device_idle_share",
                                 "images_per_s", "err_over_rms",
                                 "launches") if k in line}
        if ms is not None:
            model[line["phase"]][f"{group}_ms"] = ms
    return model


def measure_mamba(torch, cs, dev: str = "cuda") -> dict:
    from repro_torch.kernels import mamba as MB
    from repro_torch.models.lm import BlockSpec
    rows, kerns = {}, {}
    for label, dt, b, s, di, n, state, strided in cs.MAMBA_ROWS:
        args = cs.mamba_inputs(torch, dev, dt, b, s, di, n, state, strided)
        y, h = MB.mamba_scan_fwd(*args)
        ref_y, ref_h = MB.mamba_scan_plain(*args)
        kerns[label] = lambda args=args: MB.mamba_scan_fwd(*args)
        rows[label] = {
            **cs.check_row(torch, f"mamba_scan[{label}]", y, ref_y,
                           cs.kernel_tol(dt, s)),
            "state_max_abs_err": (h - ref_h).abs().max().item(),
            "ms": cs.time_ms(torch, kerns[label])}
    lines = []
    cs.emit = lines.append
    cfg, params = cs.jamba_model(torch, dev, torch.bfloat16, cs.JAMBA_LAYERS)
    _, prefill_profile = cs.phase_prefill(torch, dev, cfg, params,
                                          "jamba_prefill", 41)
    _, decode_profile = cs.phase_decode_steps(torch, dev, cfg, params,
                                              "jamba_decode", 42)
    # the profiler sessions last: they slow the host for timed runs after
    for label, kern in kerns.items():
        prof = cs.profile_kernels(torch, kern, MB.counter, "mamba_scan", 1)
        rows[label]["device_us"] = prof["device_us_per_call"]
        rows[label]["sessions"] = len(prof["sessions"])
    del kerns
    prefill_profile(params)
    decode_profile(params)
    del params
    cs.free(torch)
    cfg32, params32 = cs.jamba_model(
        torch, dev, torch.float32, len(cs.JAMBA_PARITY_PATTERN),
        capacity_factor=cfg.n_experts / cfg.top_k,
        pattern=tuple(BlockSpec(*b) for b in cs.JAMBA_PARITY_PATTERN))
    cs.phase_parity(torch, dev, cfg32, params32, "jamba_parity", 43)
    return {"mamba": rows, "model": model_lines(lines, "mamba_scan")}


def measure_fused(torch, cs, dev: str = "cuda") -> dict:
    from repro_torch.kernels import fused_elementwise as FE
    rows = {}
    for label, dtype, _, chain, ext in cs.fused_rows(torch, dev):
        run = FE.make_fused_elementwise(chain)

        def kern(run=run, ext=ext):
            return run(*ext)
        err = cs.fused_check(torch, label, kern(),
                             FE.fused_elementwise_plain(chain, *ext))
        rows[label] = {"max_abs_err": err,
                       "ms": cs.time_ms_stream(torch, kern),
                       "single_call_ms": cs.time_ms(torch, kern),
                       "host_us": cs.host_us(torch, kern)}
        if label == "relu":
            rows[label]["turns_vs_library"] = cs.relu_turns(
                torch, kern, lambda x=ext[0]: torch.relu(x))
        prof = cs.profile_kernels(torch, kern, FE.fused_counter,
                                  "fused_elementwise", 1)
        rows[label]["device_us"] = prof["device_us_per_call"]
        del ext
    cs.free(torch)
    lines = []
    cs.emit = lines.append
    _, profiled = cs.phase_eager_train(torch, dev)
    profiled()
    return {"fused": rows, "model": model_lines(lines, "fused_elementwise")}


def measure_dense32(torch, cs, dev: str = "cuda") -> dict:
    from repro_torch.configs import jamba_1_5_large_398b as jamba
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models.lm import BlockSpec

    rows, profiled = {"flash": {}, "decode": {}}, []
    for spec in cs.FLASH_ROWS:
        label, dt, b, hq, hkv, sq, skv, d, window = spec
        q, k, v, kw = cs.flash_inputs(torch, dev, spec)

        def kern(q=q, k=k, v=v, kw=kw):
            return FA.flash_attention_fwd(q, k, v, **kw)
        lib = cs.flash_library(torch, q, k, v, (b, hq, hkv, sq, skv, d),
                               window, FA.visible_mask(sq, skv, kw["causal"],
                                                       window, dev),
                               kw["causal"])
        profiled.append(("flash", label, dt, kern, lib, FA.counter,
                         "flash_attention"))
    for spec in cs.DECODE_ROWS:
        label, dt = spec[:2]
        q, kc, vc, _, lens, kw = cs.decode_inputs(torch, dev, spec)

        def kern(q=q, kc=kc, vc=vc, lens=lens, kw=kw):
            return DA.decode_attention_fwd(q, kc, vc, lens, **kw)
        lib = cs.decode_library(torch, q, kc, vc, lens, kw["window"])
        profiled.append(("decode", label, dt, kern, lib, DA.decode_counter,
                         "decode_attention"))
    for kind, label, dt, kern, lib, _, _ in profiled:
        out = kern()
        torch.cuda.synchronize()
        row = rows[kind][label] = {"dtype": dt, "sha256": sha256(torch, out),
                                   "ms": cs.time_ms(torch, kern)}
        if dt == "float32":
            row["sdpa_ms"] = cs.time_ms(torch, lib)

    lines = []
    cs.emit = lines.append
    cfg32, params32, _, _ = cs.gemma_models(torch, dev)
    cs.free(torch)
    cs.phase_parity(torch, dev, cfg32, params32, "dense_parity", 23)
    del params32
    cs.free(torch)
    base = jamba.CONFIG
    cfg32, params32 = cs.jamba_model(
        torch, dev, torch.float32, len(cs.JAMBA_PARITY_PATTERN),
        capacity_factor=base.n_experts / base.top_k,
        pattern=tuple(BlockSpec(*b) for b in cs.JAMBA_PARITY_PATTERN))
    cs.phase_parity(torch, dev, cfg32, params32, "jamba_parity", 43)
    del params32
    cs.free(torch)

    # the profiler sessions last: they slow the host for timed runs after
    for kind, label, dt, kern, lib, counter, group in profiled:
        if dt != "float32":
            continue
        kern()
        want = (DA.decode_last_launch()["device_launches"]
                if kind == "decode" else 1)
        # up to 6 sessions: after the parity runs the profiler has dropped
        # kernel records in 3 sessions running
        prof = cs.profile_kernels(torch, kern, counter, group, want, tries=6)
        row = rows[kind][label]
        row["device_us"] = prof["device_us_per_call"]
        row["parts_us"] = {k: v["device_us_per_call"]
                           for k, v in prof["kernels"].items()}
        row["device_launches"] = prof["device_launches_per_call"]
        sdpa = cs.profile_library(torch, lib)
        row["sdpa_device_us"] = sdpa["device_us_per_call"]
        row["sdpa_kernels"] = {k: v["device_us_per_call"]
                               for k, v in sdpa["kernels"].items()}
    return {**rows, "model": model_lines(lines, "flash_attention"),
            "libraries": {"flash": FA._lib()._name,
                          "decode": DA._decode_lib()._name}}


def sass(library: str) -> dict:
    """The machine code of a built library: each kernel's instructions by
    its name, with the per-file hash of anonymous-namespace names masked
    and runs of spaces made one (cuobjdump pads every line to the
    library's longest instruction)."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", library], check=True,
                          capture_output=True, text=True).stdout
    kernels, name = {}, None
    for line in text.splitlines():
        line = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "ANON", line)
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            kernels[name] = []
        elif name is not None and "/*" in line:
            kernels[name].append(" ".join(line.split()))
    return kernels


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="the other checkout")
    ap.add_argument("--kernels", choices=("attention", "gumbel", "wkv6",
                                          "mamba", "fused", "dense32"),
                    default="attention", help="the rows a turn measures")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    ap.add_argument("--out", help="also write the turns and the summary "
                                  "to this JSON file")
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(args.measure, args.kernels)), flush=True)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    turns = []
    for label, tree in (("parent", args.parent), ("change", HERE),
                        ("change", HERE), ("parent", args.parent)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--kernels", args.kernels,
                               "--measure", os.path.abspath(tree)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"the {label} turn failed")
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        line["turn"] = label
        print(json.dumps(line), flush=True)
        turns.append(line)
    summary = {"attention": attention_summary,
               "dense32": dense32_summary}.get(args.kernels,
                                               rows_summary)(turns)
    summary["turns"] = [t["turn"] for t in turns]
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"turns": turns, "summary": summary}, f, indent=1)
    return 0 if all(summary.get("bits_equal", {}).values()) else 1


def side_by_side(turns, *path) -> list:
    """The number at ``path`` in each turn's line."""
    out = []
    for t in turns:
        for key in path:
            t = t.get(key) if isinstance(t, dict) else None
        out.append(t)
    return out


def mixed_bf16_sass_kept(parent_lib: str, change_lib: str) -> dict:
    """For each kernel of the parent's mixed library that a bf16 q over
    bf16 caches runs (the pre-pass, the "mma" main kernel, the combine
    that writes bf16), whether its machine code is, instruction for
    instruction, that of a kernel of the change's library."""
    parent, change = sass(parent_lib), sass(change_lib)
    bodies = {tuple(body) for body in change.values()}
    return {name: tuple(body) in bodies for name, body in parent.items()
            if re.search(r"mixed_attention_(tiles|mma|combine)", name)}


def attention_summary(turns) -> dict:
    """Bits: a bf16 paged row and a bf16 mixed row must be the same in all
    four turns (the change keeps them), an fp32 paged row and an
    fp32-cache mixed row within each tree's two turns (each tree's kernel
    gives the same bits every run)."""
    paged_keys = list(turns[0]["paged"])
    parent_sass, change_sass = (sass(turns[i]["paged_library"])
                                for i in (0, 1))

    def same(kind, key, which):
        return len({turns[i][kind][key]["sha256"] for i in which}) == 1

    bits = {f"paged {k}": same("paged", k, range(4)) for k in paged_keys
            if k.startswith("bfloat16")}
    bits.update({f"paged {k} within each tree":
                 same("paged", k, (0, 3)) and same("paged", k, (1, 2))
                 for k in paged_keys if not k.startswith("bfloat16")})
    mixed_keys = list(turns[0]["mixed"])
    bf16_mixed = {k for k in mixed_keys
                  if turns[0]["mixed"][k].get("cache_dtype") == "bfloat16"}
    bits.update({f"mixed {k}": same("mixed", k, range(4))
                 for k in mixed_keys if k in bf16_mixed})
    bits.update({f"mixed {k} within each tree":
                 same("mixed", k, (0, 3)) and same("mixed", k, (1, 2))
                 for k in mixed_keys if k not in bf16_mixed})
    mixed_sass = mixed_bf16_sass_kept(turns[0]["mixed_library"],
                                      turns[1]["mixed_library"])
    bits["fp32 serving: spec_k=2 tokens equal spec_k=0's"] = all(
        t["serving"]["spec2_equals_spec0"] for t in turns)
    return {
        "paged_sass_identical": parent_sass == change_sass,
        "paged_sass_kernels": len(parent_sass),
        "paged_sass_kernels_differing": sorted(
            k for k in set(parent_sass) | set(change_sass)
            if parent_sass.get(k) != change_sass.get(k)),
        "mixed_bf16_sass_kept": all(mixed_sass.values()) and bool(
            mixed_sass),
        "mixed_bf16_sass_kernels": mixed_sass,
        "bits_equal": bits,
        "paged_fp32_bits_equal_parent_change": {
            k: same("paged", k, range(4)) for k in paged_keys
            if not k.startswith("bfloat16")},
        "paged": {k: {field: side_by_side(turns, "paged", k, field)
                      for field in ("ms", "device_us", "parts_us",
                                    "device_launches")}
                  for k in paged_keys},
        "mixed": {
            label: {field: side_by_side(turns, "mixed", label, field)
                    for field in ("ms", "sdpa_ms", "device_us", "parts_us")}
            for label in turns[0]["mixed"]},
        "serving": side_by_side(turns, "serving")}


def bf16_sass_kept(parent_lib: str, change_lib: str) -> dict:
    """For each bf16 kernel of the parent's library, whether its machine
    code is, instruction for instruction, that of a kernel of the
    change's library (whatever the change named it)."""
    parent, change = sass(parent_lib), sass(change_lib)
    bodies = {tuple(body) for body in change.values()}
    return {name: tuple(body) in bodies for name, body in parent.items()
            if "bfloat16" in name}


def dense32_summary(turns) -> dict:
    """Bits: a bf16 flash or decode row must be the same in all four
    turns (the change keeps them), an fp32 row within each tree's two
    turns (each tree's kernel gives the same bits every run)."""
    def same(kind, key, which):
        return len({turns[i][kind][key]["sha256"] for i in which}) == 1

    bits = {}
    for kind in ("flash", "decode"):
        for key, row in turns[0][kind].items():
            if row["dtype"] == "bfloat16":
                bits[f"{kind} {key}"] = same(kind, key, range(4))
            else:
                bits[f"{kind} {key} within each tree"] = (
                    same(kind, key, (0, 3)) and same(kind, key, (1, 2)))
    sass_kept = {lib: bf16_sass_kept(turns[0]["libraries"][lib],
                                     turns[1]["libraries"][lib])
                 for lib in ("flash", "decode")}
    summary = rows_summary(turns)
    return {"bits_equal": bits,
            "bf16_sass_kept": {lib: all(v.values()) and bool(v)
                               for lib, v in sass_kept.items()},
            "bf16_sass_kernels": sass_kept, **summary}


def rows_summary(turns) -> dict:
    """Each number of the kernel rows and the model phases, turn by
    turn (a row or field only one tree has reads None in the other's
    turns)."""
    kinds = [k for k in turns[0]
             if k not in ("tree", "card", "model", "libraries", "turn")]

    def table(key):
        fields = {}
        for t in turns:
            for label, row in t[key].items():
                fields.setdefault(label, {}).update(dict.fromkeys(row))
        return {label: {f: side_by_side(turns, key, label, f) for f in fs}
                for label, fs in fields.items()}
    return {**{kind: table(kind) for kind in kinds}, "model": table("model")}


if __name__ == "__main__":
    sys.exit(main())
