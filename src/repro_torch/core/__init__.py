# ChipLight core: the paper's contribution as a composable library.
# Traffic model (paper §III), MCM + OI-rail cluster model (§IV-A),
# the scalar design-point oracle and the RailX baseline (§IV-B).
from repro_torch.core.hardware import HW, DEFAULT_HW  # noqa: F401
from repro_torch.core.workload import Workload, paper_workload  # noqa: F401
from repro_torch.core.traffic import Strategy, traffic_volumes, \
    traffic_matrix, reusable_pairs  # noqa: F401
from repro_torch.core.mcm import MCMArch, mcm_from_compute  # noqa: F401
from repro_torch.core.network import RailDim, OITopology, allocate_links, \
    derive_physical  # noqa: F401
from repro_torch.core.cost import cluster_cost, CostBreakdown  # noqa: F401
from repro_torch.core.simulator import simulate, SimResult, map_intra  # noqa: F401
from repro_torch.core.optimizer import (  # noqa: F401
    railx_search, evaluate_point, enumerate_strategies, DesignPoint)
