"""Event-driven timeline validator: the scalar engine, the batch path
the study runs and the fidelity harness.

``compile_step`` turns a design point into a per-microbatch task DAG
under a pipeline schedule, ``replay`` runs it through the fluid
discrete-event engine on the host (the ground truth),
``compile_batch`` vector-compiles design points into wavefront rows,
``replay_rows`` / ``replay_batch`` run the pipeline wavefront over K
records at once on the chosen device (``repro_torch.kernels.wavefront``),
``stamp_validation`` stamps a study's top records with the result, and
the ``validate_*`` harness behind ``cli validate`` sweeps the scenario
zoo comparing event against analytic step times.

The validate layer is loaded lazily so that ``repro_torch.api`` itself
(Scenario schedule validation) can import this package without a cycle.
"""
from repro_torch.events.dag import (SCHEDULES, StepProgram, TaskSpec,  # noqa: F401
                                    compile_step, device_op_order)
from repro_torch.events.engine import EventResult, replay  # noqa: F401
from repro_torch.events.batch import replay_batch, replay_rows  # noqa: F401
from repro_torch.events.compile_batch import (CompiledBatch,  # noqa: F401
                                              compile_batch)

_LAZY = ("validate_scenario", "validate_zoo", "stamp_validation",
         "fidelity_table", "FIDELITY_SCHEMA", "DEFAULT_TOLERANCE")


def __getattr__(name):
    if name in _LAZY:
        from repro_torch.events import validate as _v
        return getattr(_v, name)
    raise AttributeError(
        f"module 'repro_torch.events' has no attribute {name!r}")


__all__ = ["SCHEDULES", "StepProgram", "TaskSpec", "compile_step",
           "device_op_order", "EventResult", "replay", "replay_batch",
           "replay_rows", "CompiledBatch", "compile_batch", *_LAZY]
