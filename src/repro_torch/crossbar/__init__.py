"""The circuit solver: single tiles and the dense oracle
(:mod:`.solver`), and the batched PCG engine with its precision
policies and convergence watchdog (:mod:`.batched`)."""
from repro_torch.crossbar.batched import (  # noqa: F401
    F32,
    F64,
    MIXED,
    BatchedSolveResult,
    SolverPrecision,
    SolverReport,
    measured_nf_batched,
    measured_nf_batched_checked,
    measured_nf_conductances,
    measured_nf_conductances_checked,
    resolve_precision,
    solve_conductances_batched,
    solve_crossbar_batched,
    tile_converged,
)
from repro_torch.crossbar.solver import (  # noqa: F401
    SolveResult,
    column_currents_dense,
    conductances,
    ideal_currents,
    measured_nf,
    measured_nf_checked,
    measured_nf_sequential,
    solve_crossbar,
)
