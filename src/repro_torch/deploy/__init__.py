"""Whole-model CIM deployment of the port (dense models and MoE expert
banks, one matrix an expert, on ideal or imperfect devices): the plan
cache (``cache``), planning one matrix at a time through it
(``planner``) and packaging, with the devices' faults and variation
injected, into the stacked deployments the serving path reads
(``engine``), and the per-matrix lifetime state that ages and heals
them while they serve (``lifetime``)."""
from repro_torch.deploy.cache import (  # noqa: F401
    PLAN_CACHE_VERSION,
    CacheStats,
    PlanCache,
    default_cache_dir,
    manifest_key,
    plan_key,
    weight_fingerprint,
)
from repro_torch.deploy.lifetime import (  # noqa: F401
    DEMOTED_RUNTIME,
    MatrixLifetime,
    bank_index,
    group_key,
    pad_host_deployment,
    restack_group,
)
from repro_torch.deploy.engine import (  # noqa: F401
    DEPLOYABLE,
    collect_model_matrices,
    collect_projection_matrices,
    deploy_matrices,
    deploy_model_params,
    package_deployment_host,
    spec_from_config,
)
from repro_torch.deploy.planner import (  # noqa: F401
    fingerprint_matrices,
    plan_matrices,
    plan_matrix,
    plan_model_tiles,
    quantize_codes_host,
)
