#!/usr/bin/env python3
"""Variants of the fp32 decode and flash kernels, built and measured on
one card: the decode kernel's tiling sweep and the flash kernel's
breakdown with parts removed.

    python3 tools/kernel_variants.py decode [--set NAME=V1,V2 ...] [--out F]
    python3 tools/kernel_variants.py flash [--patch NAME ...] [--out F]

``decode``: each ``--set`` names one of ``csrc/decode_attention.cu``'s
constants with its values (default: ``kSimtWarps=4,8``,
``kSimtSplitKeys=64,128`` and ``kSimtWarpKeys=16,32``: warps a block,
keys a split, keys a warp's tile), and every combination is a variant
with those constants replaced and nothing else changed.

``flash``: the whole kernel, then one variant for each ``--patch``
(default: all of ``PATCHES``), each a build of ``csrc/`` with one part
of the fp32 ("tf32x3") kernel removed: its outputs are wrong by design
and only its time is read.

Every variant is built from a copy of ``csrc/``, every ``nvcc`` started
together, into ``build/variants/``.  The port's own wrapper then runs on
each variant's library, on every fp32 row of ``chip_smoke.DECODE_ROWS``
or ``FLASH_ROWS``: the max abs error against the plain version (within
``kernel_tol`` for a variant that removes nothing), the kernel's
registers, spills and blocks an SM, a single call's ms (decode: and the
C entry's launch record); then, in a second pass over the variants (a
profiler session slows the timed calls after it), the device us a call
of each of the call's kernels (``profile_kernels``).  It prints one JSON
line a variant and the card's name and power limit.  Needs one CUDA card
and the CUDA toolkit.
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


def decode_variants(sets) -> dict:
    variants = {}
    for vals in itertools.product(*[vs for _, vs in sets]):
        edits, name = [], []
        for (const, _), val in zip(sets, vals):
            text = (HERE / "src/repro_torch/kernels/csrc/decode_attention.cu"
                    ).read_text()
            found = re.findall(rf"constexpr int {const} = \d+;", text)
            if len(found) != 1:
                raise SystemExit(f"{const} is not defined once in the source")
            edits.append(("decode_attention.cu", found[0],
                          f"constexpr int {const} = {val};"))
            name.append(f"{const}={val}")
        variants[",".join(name)] = edits
    return variants


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=("decode", "flash"))
    ap.add_argument("--set", action="append", default=[],
                    metavar="NAME=V1,V2", help="decode: a constant and its "
                                               "values")
    ap.add_argument("--patch", action="append", default=[],
                    choices=sorted(PATCHES), help="flash: a part removed")
    ap.add_argument("--out", help="also write the lines to this JSON file")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE / "src"))
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    cs = load_chip_smoke()

    if args.kernel == "decode":
        library, counter, group = ("repro_decode_attention",
                                   DA.decode_counter, "decode_attention")
        sets = DECODE_SETS if not args.set else tuple(
            (a.split("=")[0], tuple(int(x) for x in
                                    a.split("=")[1].split(",")))
            for a in args.set)
        variants = decode_variants(sets)
        rows = [r for r in cs.DECODE_ROWS if r[1] == "float32"]
    else:
        library, counter, group = ("repro_flash_attention", FA.counter,
                                   "flash_attention")
        variants = {"whole": []}
        variants.update({p: PATCHES[p]
                         for p in (args.patch or sorted(PATCHES))})
        rows = [r for r in cs.FLASH_ROWS if r[1] == "float32"]
    libs = build(library, variants)

    def use(name):
        _build._libs[library] = ctypes.CDLL(libs[name])
        DA._decode_workspace_bytes.cache_clear()

    calls = {}
    for r in rows:
        if args.kernel == "decode":
            q, kc, vc, _, lens, kw = cs.decode_inputs(torch, "cuda", r)
            calls[r[0]] = (
                lambda q=q, kc=kc, vc=vc, lens=lens, kw=kw:
                DA.decode_attention_fwd(q, kc, vc, lens, **kw),
                lambda q=q, kc=kc, vc=vc, lens=lens, kw=kw:
                DA.decode_attention_plain(q, kc, vc, lens, **kw), r[6], r[5])
        else:
            q, k, v, kw = cs.flash_inputs(torch, "cuda", r)
            calls[r[0]] = (
                lambda q=q, k=k, v=v, kw=kw:
                FA.flash_attention_fwd(q, k, v, **kw),
                lambda q=q, k=k, v=v, kw=kw:
                FA.flash_attention_plain(q, k, v, **kw), r[6], r[7])
    results = {name: {} for name in variants}
    for name, edits in variants.items():
        use(name)
        exact = args.kernel == "decode" or not edits
        for label, (kern, plain, skv, d) in calls.items():
            out = kern()
            torch.cuda.synchronize()
            ref = plain()
            err = (out - ref).abs().max().item()
            if exact:
                cs.check_row(torch, f"{library}[{label}] {name}", out, ref,
                             cs.kernel_tol("float32", skv))
            attrs = (DA.decode_kernel_attributes(torch.float32, d)
                     if args.kernel == "decode"
                     else FA.kernel_attributes(torch.float32, d))
            row = results[name][label] = {
                "max_abs_err": err,
                **{k: attrs[k] for k in ("registers", "spill_bytes",
                                         "blocks_per_sm", "threads")},
                "ms": cs.time_ms(torch, kern)}
            if args.kernel == "decode":
                row.update(DA.decode_last_launch())
                row["split_keys"] = attrs["split_keys"]
    for name in variants:
        use(name)
        for label, (kern, _, _, _) in calls.items():
            kern()
            want = (DA.decode_last_launch()["device_launches"]
                    if args.kernel == "decode" else 1)
            prof = cs.profile_kernels(torch, kern, counter, group, want,
                                      part=cs.decode_part, tries=6)
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
