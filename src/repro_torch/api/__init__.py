# Unified Scenario/Study layer over the scalar oracle (repro_torch.core) and
# the batched DSE engine (repro_torch.dse) — see DESIGN.md §repro_torch.api.
from repro_torch.api.registry import (DRIVERS, OBJECTIVES, Objective,  # noqa: F401
                                Registry)
from repro_torch.api.scenario import SCENARIO_SCHEMA, Scenario  # noqa: F401
from repro_torch.api.result import (RESULT_SCHEMA, DesignRecord,  # noqa: F401
                              StudyResult, record_from_point,
                              record_from_search, record_from_sweep,
                              records_from_sweep)
from repro_torch.api.study import Study, run  # noqa: F401
