"""Serving of the port: the single-batch ``ServeEngine`` and the
continuous-batching tier (scheduler, slot pool, ``ContinuousEngine``)."""
from repro_torch.serve.continuous import (  # noqa: F401
    Bank,
    ContinuousEngine,
    make_slot_decode,
    make_slot_prefill,
)
from repro_torch.serve.engine import (  # noqa: F401
    ServeEngine,
    deploy_serving_bank,
    sample_tokens,
    sample_tokens_batch,
)
from repro_torch.serve.kvcache import SlotPool  # noqa: F401
from repro_torch.serve.scheduler import (  # noqa: F401
    Request,
    RequestScheduler,
    Sequence,
)
