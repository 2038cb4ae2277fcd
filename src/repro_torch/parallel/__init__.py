from repro_torch.parallel.sharding import (param_specs, batch_specs,  # noqa: F401
                                           cache_specs, placements)
from repro_torch.parallel.plan import ParallelPlan, plan_from_design  # noqa: F401
