#!/usr/bin/env python3
"""Variants of the fp32 decode, flash and mixed kernels, built and
measured on one card: the decode kernel's tiling sweep, the flash
kernel's breakdown with parts removed, and the fp32-cache mixed kernel's
choices.

    python3 tools/kernel_variants.py decode [--set NAME=V1,V2 ...] [--out F]
    python3 tools/kernel_variants.py flash [--patch NAME ...] [--out F]
    python3 tools/kernel_variants.py mixed [--set NAME=V1,V2 ...]
                                           [--patch NAME ...] [--out F]

``decode``: each ``--set`` names one of ``csrc/decode_attention.cu``'s
constants with its values (default: ``kSimtWarps=4,8``,
``kSimtSplitKeys=64,128`` and ``kSimtWarpKeys=16,32``: warps a block,
keys a split, keys a warp's tile), and every combination is a variant
with those constants replaced and nothing else changed.

``flash``: the whole kernel, then one variant for each ``--patch``
(default: all of ``PATCHES``), each a build of ``csrc/`` with one part
of the fp32 ("tf32x3") kernel removed: its outputs are wrong by design
and only its time is read.

``mixed``: the whole kernel, or every combination of the ``--set``
constants of ``csrc/mixed_attention.cu``, then one variant for each
``--patch`` of ``MIXED_PATCHES`` (default: all) on the source as it is:
a bf16 q's S in three products, every item run wide.  Rows: the
fp32-cache rows of ``chip_smoke.MIXED_ROWS`` ((b) fp32 q, (e) bf16 q)
and, for each, the same call on its prefill chunks' tokens alone and on
its decode tokens alone (what a 64-row item and an 8-row item cost).  A
variant the card cannot launch (too much shared memory) is reported with
its error.

Every variant is built from a copy of ``csrc/``, every ``nvcc`` started
together, into ``build/variants/``.  The port's own wrapper then runs on
each variant's library, on every fp32 row of ``chip_smoke.DECODE_ROWS``
or ``FLASH_ROWS`` (or the mixed rows above): the max abs error against
the plain version (within ``kernel_tol`` for a variant that removes
nothing), the kernel's registers, spills and blocks an SM, a single
call's ms (decode and mixed: and the C entry's launch record); then, in
a second pass over the variants (a profiler session slows the timed
calls after it), the device us a call of each of the call's kernels
(``profile_kernels``).  It prints one JSON line a variant and the card's
name and power limit.  Needs one CUDA card and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import itertools
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

DECODE_SETS = (("kSimtWarps", (4, 8)), ("kSimtSplitKeys", (64, 128)),
               ("kSimtWarpKeys", (16, 32)))

# the flash breakdown: (file, text, replacement) edits of csrc/
PATCHES = {
    # one TF32 product (big x big) in place of three
    "one_product": [("attention_common.cuh",
                     "  mma_tf32(c, a_small, b0_big, b1_big);\n"
                     "  mma_tf32(c, a_big, b0_small, b1_small);\n", "")],
    # no S = Q K^T products (nor the Q and K loads and splits they use)
    "no_qk": [("flash_attention.cu",
               "      mma_tf32x3(s[0][2 * np], ab, as, bb[0], bb[1], bs[0], "
               "bs[1]);\n      mma_tf32x3(s[0][2 * np + 1], ab, as, bb[2], "
               "bb[3], bs[2],\n                 bs[3]);\n", "")],
    # no O += P V products (nor the V loads and splits)
    "no_pv": [("flash_attention.cu",
               "      mma_tf32x3(o[0][dn], ab, as, b0b, b1b, b0s, b1s);\n",
               "")],
    # no exchange of the partial scores between a row group's warps
    "no_exchange": [("flash_attention.cu", "  pair_sync(pair_id);\n", ""),
                    ("flash_attention.cu",
                     "    const float4 x = *reinterpret_cast<const float4*>"
                     "(xs_other + j * 128);\n",
                     "    const float4 x = make_float4(0.f, 0.f, 0.f, 0.f);"
                     "\n")],
}

# the fp32-cache mixed kernel's variants on the source as it is
MIXED_PATCHES = {
    # a bf16 q's S in three TF32 products, its zero remainder's among them
    "bf16q_three_qk_products": [(
        "mixed_attention.cu",
        "    mma_tf32(c, ab, b0s, b1s);\n",
        "    const uint32_t zero[4] = {0u, 0u, 0u, 0u};\n"
        "    mma_tf32(c, zero, b0b, b1b);\n"
        "    mma_tf32(c, ab, b0s, b1s);\n")],
    # every item run wide: a decode token's 8 rows on one warp pair
    "no_narrow_items": [("mixed_attention.cu",
                         "bool tf_narrow_items() {\n  return D >= 64;",
                         "bool tf_narrow_items() {\n  return false;")],
}


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(library: str, variants: dict) -> dict:
    """{name: [(file, old, new)]} -> {name: the variant's library}, all
    built at once."""
    from repro_torch.kernels import _build
    jobs = {}
    for name, edits in variants.items():
        out = HERE / "build" / "variants" / library / name
        if out.exists():
            shutil.rmtree(out)
        shutil.copytree(_build.CSRC, out)
        for file, old, new in edits:
            text = (out / file).read_text()
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the text to replace is not in "
                                 f"{file} once: {old!r}")
            (out / file).write_text(text.replace(old, new))
        lib = out / f"lib{library}.so"
        src = out / _build.LIBRARIES[library][0]
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      lib)
    libs = {}
    for name, (proc, lib) in jobs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{output}")
        libs[name] = str(lib)
    return libs


def constant_variants(file: str, sets) -> dict:
    """Every combination of the constants' values, each a list of edits
    of ``file``."""
    text = (HERE / "src/repro_torch/kernels/csrc" / file).read_text()
    variants = {}
    for vals in itertools.product(*[vs for _, vs in sets]):
        edits, name = [], []
        for (const, _), val in zip(sets, vals):
            found = re.findall(rf"constexpr int {const} = \d+;", text)
            if len(found) != 1:
                raise SystemExit(f"{const} is not defined once in the source")
            edits.append((file, found[0], f"constexpr int {const} = {val};"))
            name.append(f"{const}={val}")
        variants[",".join(name)] = edits
    return variants


def mixed_calls(torch, cs, DA) -> dict:
    """label -> (kernel call, plain call, L, D, q dtype) of the mixed rows:
    each fp32-cache MIXED_ROWS row, and its prefill chunks' and decode
    tokens' calls alone."""
    x, caches = cs.mixed_inputs(torch, "cuda")
    seg = x["seg"].cpu()
    subsets = {"": None,
               ":chunks": torch.nonzero((seg >= 0) & (seg < 2))[:, 0],
               ":decode": torch.nonzero(seg >= 2)[:, 0]}
    calls = {}
    for spec in cs.MIXED_ROWS:
        if spec[2] != "float32":
            continue
        q, kc, vc = cs.mixed_row_tensors(torch, "cuda", x, caches, spec)
        kw = dict(scale=spec[5] ** -0.5, window=spec[6])
        for suffix, idx in subsets.items():
            args = (q, x["seg"], x["pos"]) if idx is None else (
                q[idx.cuda()], x["seg"][idx.cuda()], x["pos"][idx.cuda()])
            calls[spec[0] + suffix] = (
                lambda a=args, kc=kc, vc=vc, kw=kw:
                DA.mixed_attention_fwd(a[0], kc, vc, a[1], a[2], **kw),
                lambda a=args, kc=kc, vc=vc, kw=kw:
                DA.mixed_attention_plain(a[0], kc, vc, a[1], a[2], **kw),
                int(kc.shape[2]), spec[5], spec[1])
    return calls


def parse_sets(args, default):
    return default if not args else tuple(
        (a.split("=")[0], tuple(int(x) for x in a.split("=")[1].split(",")))
        for a in args)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=("decode", "flash", "mixed"))
    ap.add_argument("--set", action="append", default=[],
                    metavar="NAME=V1,V2", help="decode, mixed: a constant "
                                               "and its values")
    ap.add_argument("--patch", action="append", default=[],
                    choices=sorted(PATCHES) + sorted(MIXED_PATCHES),
                    help="flash: a part removed; mixed: a variant")
    ap.add_argument("--out", help="also write the lines to this JSON file")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE / "src"))
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    cs = load_chip_smoke()

    # label -> (kernel call, plain call, reduction length, D, q dtype)
    calls = {}
    if args.kernel == "decode":
        library, counter, group = ("repro_decode_attention",
                                   DA.decode_counter, "decode_attention")
        variants = constant_variants("decode_attention.cu",
                                     parse_sets(args.set, DECODE_SETS))
        for r in cs.DECODE_ROWS:
            if r[1] != "float32":
                continue
            q, kc, vc, _, lens, kw = cs.decode_inputs(torch, "cuda", r)
            calls[r[0]] = (
                lambda q=q, kc=kc, vc=vc, lens=lens, kw=kw:
                DA.decode_attention_fwd(q, kc, vc, lens, **kw),
                lambda q=q, kc=kc, vc=vc, lens=lens, kw=kw:
                DA.decode_attention_plain(q, kc, vc, lens, **kw), r[6], r[5],
                "float32")
    elif args.kernel == "flash":
        library, counter, group = ("repro_flash_attention", FA.counter,
                                   "flash_attention")
        variants = {"whole": []}
        variants.update({p: PATCHES[p]
                         for p in (args.patch or sorted(PATCHES))})
        for r in cs.FLASH_ROWS:
            if r[1] != "float32":
                continue
            q, k, v, kw = cs.flash_inputs(torch, "cuda", r)
            calls[r[0]] = (
                lambda q=q, k=k, v=v, kw=kw:
                FA.flash_attention_fwd(q, k, v, **kw),
                lambda q=q, k=k, v=v, kw=kw:
                FA.flash_attention_plain(q, k, v, **kw), r[6], r[7],
                "float32")
    else:
        library, counter, group = ("repro_mixed_attention",
                                   DA.mixed_counter, "mixed_attention")
        variants = (constant_variants("mixed_attention.cu",
                                      parse_sets(args.set, ()))
                    if args.set else {"whole": []})
        variants.update({p: MIXED_PATCHES[p]
                         for p in (args.patch or sorted(MIXED_PATCHES))})
        calls = mixed_calls(torch, cs, DA)
    libs = build(library, variants)

    def use(name):
        _build._libs[library] = ctypes.CDLL(libs[name])
        DA._decode_workspace_bytes.cache_clear()

    def attributes(d, dtype):
        if args.kernel == "decode":
            return DA.decode_kernel_attributes(torch.float32, d)
        if args.kernel == "flash":
            return FA.kernel_attributes(torch.float32, d)
        return DA.mixed_kernel_attributes(getattr(torch, dtype),
                                          torch.float32, d)

    def launches():
        if args.kernel == "decode":
            return DA.decode_last_launch()
        return DA.mixed_last_launch() if args.kernel == "mixed" else {}

    results = {name: {} for name in variants}
    for name, edits in variants.items():
        use(name)
        exact = args.kernel != "flash" or not edits
        for label, (kern, plain, skv, d, dtype) in calls.items():
            try:
                out = kern()
                torch.cuda.synchronize()
            except RuntimeError as e:
                results[name][label] = {"error": str(e)}
                continue
            ref = plain()
            err = (out.float() - ref.float()).abs().max().item()
            if exact:
                cs.check_row(torch, f"{library}[{label}] {name}", out, ref,
                             cs.kernel_tol(dtype, skv))
            attrs = attributes(d, dtype)
            row = results[name][label] = {
                "max_abs_err": err,
                **{k: attrs[k] for k in ("registers", "spill_bytes",
                                         "smem_bytes", "blocks_per_sm",
                                         "threads")},
                "ms": cs.time_ms(torch, kern), **launches()}
            if args.kernel == "decode":
                row["split_keys"] = attrs["split_keys"]
    part = cs.kernel_part if args.kernel == "mixed" else cs.decode_part
    for name in variants:
        use(name)
        for label, (kern, _, _, _, _) in calls.items():
            if "error" in results[name][label]:
                continue
            kern()
            want = launches().get("device_launches", 1)
            prof = cs.profile_kernels(torch, kern, counter, group, want,
                                      part=part, tries=6)
            results[name][label]["device_us"] = prof["device_us_per_call"]
            results[name][label]["parts_us"] = {
                k: p["device_us_per_call"] for k, p in prof["kernels"].items()}
    lines = [{"kernel": args.kernel, "variant": name, "rows": results[name]}
             for name in variants]
    for line in lines:
        print(json.dumps(line), flush=True)
    card = cs.smi_line()
    print(card, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "variants": lines}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
