"""Column-order strategies.  The legacy pipelines keep the (possibly
dataflow-reversed) bitline order, so this slice ports ``identity`` only;
the X-CHANGR and spare-line passes come with the imperfect-device
slice."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class IdentityCols:
    """Keep the (possibly dataflow-reversed) column order unchanged."""
