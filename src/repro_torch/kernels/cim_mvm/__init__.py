from repro_torch.kernels.cim_mvm.ops import (  # noqa: F401
    CimDeployment,
    cim_mvm,
    deploy,
)
