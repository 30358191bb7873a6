"""Roofline terms of a dry-run cell on the H100 (counterpart of
``repro/launch/roofline.py``).

Per (arch × shape × mesh), from one rank's traced step
(``launch/dryrun.py``):

  compute term    = FLOPs_per_device / peak FLOP/s of the params' dtype
  memory term     = bytes_per_device / HBM bytes/s
  collective term = each mesh axis's collective bytes / its link's
                    bytes/s, summed over the axes

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` and
parses the collectives out of the compiled HLO.  The port has no
compiler to ask: the FLOPs are ``FlopCounterMode``'s (the kernels'
registered formulas included), the bytes the dry run's count of each
operator's operands and results, and the collectives the tally that
``distributed/collectives.py`` keeps where each call is made
(``stats["kinds"]`` and ``stats["axes"]``).

MODEL_FLOPS uses 6·N·D (dense) or 6·N_active·D (MoE) per trained token,
3× less for forward-only (prefill/decode count 2·N·D per token), from
the parameters' shapes alone (``lm.abstract_params`` on ``meta``).
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass
from typing import Any, Dict, Optional

from ..models.lm import abstract_params

# H100 SXM 80GB, per card: NVIDIA's data sheet, the figures
# chip_smoke.py's kernel bounds use.  Dense peaks: bf16 tensor cores,
# fp32 CUDA cores, fp32 as three TF32 products
HBM_BW = 3.35e12                       # bytes/s
HBM_BYTES = 80e9                       # device memory
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32x3": 494.7e12 / 3}
# links (NVIDIA H100 SXM data sheet; no NCCL rate of this port is
# measured): NVLink 4 inside a node of 8 cards, 900 GB/s a card, 450 GB/s
# each way; 400 Gb/s NDR InfiniBand a card between nodes
NODE_SIZE = 8
NVLINK_BW = 450e9                      # bytes/s each way
IB_BW = 50e9                           # bytes/s


def axis_link_bw(sizes: Dict[str, int], axis: str) -> float:
    """The link rate of a mesh axis: NVLink when each of its groups lies
    inside one node of :data:`NODE_SIZE` consecutive ranks (the mesh's
    ranks in row-major order: the axis and those after it make blocks of
    consecutive ranks that must divide a node), else InfiniBand."""
    names = list(sizes)
    block = math.prod(sizes[a] for a in names[names.index(axis):])
    return NVLINK_BW if NODE_SIZE % block == 0 else IB_BW


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_breakdown: Dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float          # MODEL_FLOPS / (FLOPs × devices)
    bytes_per_device_peak: Optional[float] = None   # the dry run's peak
    note: str = ""

    def as_dict(self) -> Dict[str, Any]:
        return asdict(self)


def model_flops(cfg, spec, kind: str) -> float:
    """6·N_active·D for train, 2·N_active·D per forward token."""
    # parameter count excluding embeddings (standard convention keeps
    # embed out of the 6ND matmul estimate; logits matmul added back)
    total = sum(math.prod(leaf.shape) for leaf in _leaves(
        abstract_params(cfg)))
    embed = cfg.vocab_size * cfg.d_model
    body = total - embed * (1 if cfg.tie_embeddings else 2)

    # MoE: only top_k of n_experts expert FFNs run per token
    if cfg.n_experts:
        moe_layers = sum(1 for s in cfg.pattern if s.ffn == "moe") \
            * cfg.n_groups + sum(1 for s in cfg.tail if s.ffn == "moe")
        per_layer_expert = 3 * cfg.d_model * cfg.d_ff * cfg.n_experts
        inactive = per_layer_expert * (1 - cfg.top_k / cfg.n_experts)
        body -= moe_layers * inactive

    n_active = body + cfg.vocab_size * cfg.d_model  # logits matmul
    tokens = spec.global_batch * (spec.seq_len if spec.kind != "decode"
                                  else 1)
    per_token = 6 * n_active if kind == "train" else 2 * n_active
    return float(per_token) * tokens


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def analyze(arch: str, shape: str, mesh_name: str, sizes: Dict[str, int],
            cfg, spec, kind: str, cost: Dict[str, float],
            collectives: Dict, mem: Optional[Dict] = None) -> Roofline:
    """The roofline of one rank's step on a mesh of axis ``sizes``:
    ``cost`` its ``{"flops", "bytes accessed"}``, ``collectives`` the
    ``collectives.stats`` tally of the step, ``mem`` the dry run's
    memory record."""
    n_devices = math.prod(sizes.values())
    flops_dev = float(cost.get("flops") or 0.0)
    bytes_dev = float(cost.get("bytes accessed") or 0.0)
    kinds, axes = collectives["kinds"], collectives["axes"]
    coll_total = float(sum(k["bytes"] for k in kinds.values()))

    # the products run in the parameters' dtype
    compute_s = flops_dev / PEAK_FLOPS[str(cfg.param_dtype).split(".")[-1]]
    memory_s = bytes_dev / HBM_BW
    collective_s = sum(a["bytes"] / axis_link_bw(sizes, name)
                       for name, a in axes.items() if name in sizes)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)

    mf = model_flops(cfg, spec, kind)
    total = flops_dev * n_devices
    useful = mf / total if total else 0.0

    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, n_devices=n_devices,
        flops_per_device=flops_dev, bytes_per_device=bytes_dev,
        collective_bytes_per_device=coll_total,
        collective_breakdown={
            **{k: v["bytes"] for k, v in kinds.items()},
            **{f"n_{k}": v["calls"] for k, v in kinds.items()},
            **{f"axis_{a}": v["bytes"] for a, v in axes.items()}},
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=mf, useful_ratio=useful,
        bytes_per_device_peak=(mem or {}).get("bytes"),
    )
