"""Device nonidealities of the port: fault and variation models
(:mod:`.models`), deployment injection (:mod:`.inject`) and the exact
Eq-17 evaluator under faults (:mod:`.weights`)."""
from repro_torch.nonideal.models import (  # noqa: F401
    HEALTHY,
    OPEN,
    STUCK_OFF,
    STUCK_ON,
    CellSample,
    NonidealModel,
    cell_values,
    sample_cell_state,
    sample_corr_field,
    sample_line_open,
    sample_stuck,
)
