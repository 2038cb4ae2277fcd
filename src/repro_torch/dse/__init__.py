# Vectorized batched design-space exploration (see DESIGN.md §repro_torch.dse).
# Evaluates thousands of (strategy, MCM, fabric) points per call via the
# SoA port of core.simulator.simulate; the scalar simulator is the oracle.
from repro_torch.dse.space import (DesignSpace, StrategyBatch, FABRICS,  # noqa: F401
                             P_ORDER, P_IDX, enumerate_mcm_grid,
                             enumerate_space_batch,
                             enumerate_strategy_batch)
from repro_torch.dse.batched_sim import (BatchedSimResult,  # noqa: F401
                                   batched_simulate, map_intra_batch,
                                   traffic_volumes_batch,
                                   allocate_links_batch,
                                   allocate_links_railx_batch)
from repro_torch.dse.pareto import (crowding_distance, nondominated_sort,  # noqa: F401
                              pareto_front_indices, pareto_mask)
from repro_torch.dse.search import (DRIVERS, BatchedEvaluator,  # noqa: F401
                              SearchResult, SweepResult, refine_cell_rows,
                              refine_sweep_rows, refine_top_points,
                              search_exhaustive, search_nsga2,
                              search_prf_ucb, search_random,
                              sweep_design_space)
from repro_torch.dse.outer import (VariantEval, mcm_variant_key,  # noqa: F401
                             outer_search)
