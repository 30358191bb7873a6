"""Render the dry-run matrix and the roofline table from the dry run's
records (counterpart of ``repro/launch/report.py``)::

    PYTHONPATH=src python -m repro_torch.launch.report build/dryrun

The tables are the reference's, line for line, but for the last column
of the dry-run matrix: the seconds the eager trace took
(``trace_s``), where the reference gives XLA's compile seconds.  The
roofline's terms are the H100's (``launch/roofline.py``): predictions
from the data sheet's rates, computed on a CPU, not timings.
"""

import glob
import json
import os
import sys

from ..configs import ARCHS, SkipSpec, get_shapes

SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(dirpath, mesh):
    recs = {}
    for f in glob.glob(os.path.join(dirpath, f"*__{mesh}.json")):
        with open(f) as fh:
            r = json.load(fh)
        recs[(r["arch"], r["shape"])] = r
    return recs


def fmt_bytes(b):
    return f"{b/1e9:.2f}"


def roofline_table(recs):
    lines = [
        "| arch | shape | FLOPs/dev | bytes/dev | coll/dev | compute_s |"
        " memory_s | collective_s | dominant | MODEL_FLOPS | useful |"
        " HBM GB/dev |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCHS:
        for shape in SHAPES:
            spec = get_shapes(arch).get(shape)
            if isinstance(spec, SkipSpec):
                lines.append(
                    f"| {arch} | {shape} | — | — | — | — | — | — | "
                    f"SKIP: {spec.reason[:60]} | — | — | — |")
                continue
            r = recs.get((arch, shape))
            if r is None:
                lines.append(f"| {arch} | {shape} | MISSING |"
                             + " |" * 10)
                continue
            rl = r["roofline"]
            mem_gb = r["memory"].get("bytes", 0) / 1e9
            lines.append(
                f"| {arch} | {shape} "
                f"| {rl['flops_per_device']:.2e} "
                f"| {rl['bytes_per_device']:.2e} "
                f"| {rl['collective_bytes_per_device']:.2e} "
                f"| {rl['compute_s']*1e3:.1f}ms "
                f"| {rl['memory_s']*1e3:.1f}ms "
                f"| {rl['collective_s']*1e3:.1f}ms "
                f"| **{rl['dominant']}** "
                f"| {rl['model_flops']:.2e} "
                f"| {rl['useful_ratio']:.2f} "
                f"| {mem_gb:.1f} |")
    return "\n".join(lines)


def dryrun_table(recs_s, recs_m):
    lines = [
        "| arch | shape | single-pod (256) | multi-pod (512) | "
        "bytes/dev single | bytes/dev multi | trace s/m |",
        "|---|---|---|---|---|---|---|",
    ]
    for arch in ARCHS:
        for shape in SHAPES:
            spec = get_shapes(arch).get(shape)
            if isinstance(spec, SkipSpec):
                lines.append(f"| {arch} | {shape} | SKIP | SKIP | — | — "
                             f"| — |")
                continue
            rs = recs_s.get((arch, shape))
            rm = recs_m.get((arch, shape))

            def stat(r):
                if r is None:
                    return "MISSING", "—", "—"
                return ("OK", fmt_bytes(r["memory"].get("bytes", 0)),
                        str(r.get("trace_s", "—")))
            s_ok, s_b, s_c = stat(rs)
            m_ok, m_b, m_c = stat(rm)
            lines.append(f"| {arch} | {shape} | {s_ok} | {m_ok} "
                         f"| {s_b} GB | {m_b} GB | {s_c}/{m_c} |")
    return "\n".join(lines)


def main():
    d = sys.argv[1] if len(sys.argv) > 1 else "build/dryrun"
    recs_s = load(d, "single")
    recs_m = load(d, "multi")
    print("## Dry-run matrix\n")
    print(dryrun_table(recs_s, recs_m))
    print("\n## Roofline (single-pod, 256 × H100; predictions from the "
          "data sheet's rates, computed on a CPU)\n")
    print(roofline_table(recs_s))


if __name__ == "__main__":
    main()
