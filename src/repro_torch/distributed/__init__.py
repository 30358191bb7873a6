"""Distributed execution on ``torch.distributed``: the sharding tables
(``sharding``), activation layouts and what each rank computes under a
mesh (``act_sharding``: the meshed train, prefill and serve steps of
``launch/train.py``), the collectives over either backend, with their
autograd-aware forms (``collectives``), data-parallel gradient sync
(``ddp``) and pipeline stages (``pipeline``).  Counterpart of
``repro/distributed``."""
