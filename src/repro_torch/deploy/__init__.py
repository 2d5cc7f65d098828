"""Whole-model CIM deployment of the port (dense, ideal devices)."""
from repro_torch.deploy.engine import (  # noqa: F401
    DEPLOYABLE,
    collect_model_matrices,
    deploy_model_params,
    spec_from_config,
)
from repro_torch.deploy.planner import (  # noqa: F401
    plan_matrix,
    quantize_codes_host,
)
