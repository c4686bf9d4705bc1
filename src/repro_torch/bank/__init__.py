"""repro_torch.bank -- keyed multi-tenant sampler banks: K stacked per-key
R-TBS reservoirs or T-TBS buffers behind the ``init / step / extract`` protocol
(:class:`SamplerBank`, built by :func:`make_bank`; :func:`shard_bank` steps S
of them together as one key-sharded bank), with key-routed
ingestion (:mod:`.routing`), the banked payload kernel B3 and a lazy
per-key pending decay for the untouched keys. The bank-level manage loop
lives in :mod:`repro_torch.manage.bank_loop`."""
from .bank import (  # noqa: F401
    BankState,
    SamplerBank,
    available_bank_schemes,
    make_bank,
    register_bank,
    shard_bank,
)
from .routing import Routing, ShardedBatch, compact_shards, route, subbatches  # noqa: F401
