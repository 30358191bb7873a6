"""Distributed execution on ``torch.distributed``: the sharding tables
(``sharding``), the collectives over either backend (``collectives``),
data-parallel gradient sync (``ddp``) and pipeline stages
(``pipeline``).  Counterpart of ``repro/distributed``; ``act_sharding``
waits for the meshed training step (ROADMAP.md queue A7b)."""
