"""Device nonidealities of the port: fault and variation models
(:mod:`.models`), deployment injection (:mod:`.inject`), the exact
Eq-17 evaluator under faults (:mod:`.weights`) and the Monte-Carlo NF
engine over fault and variation ensembles (:mod:`.montecarlo`)."""
from repro_torch.nonideal.models import (  # noqa: F401
    HEALTHY,
    OPEN,
    STUCK_OFF,
    STUCK_ON,
    CellSample,
    NonidealModel,
    apply_to_conductances,
    cell_values,
    conductances_from_masks,
    sample_cell_state,
    sample_corr_field,
    sample_line_open,
    sample_stuck,
)
from repro_torch.nonideal.montecarlo import (  # noqa: F401
    McNfResult,
    mc_nf,
    mc_nf_oracle,
    mc_samples,
    summarize,
)
