"""Event-driven timeline: the batch path the study runs.

``compile_batch`` vector-compiles design points into wavefront rows,
``replay_rows`` / ``replay_batch`` run the pipeline wavefront over K
records at once on the chosen device (``repro_torch.kernels.wavefront``)
and ``stamp_validation`` stamps a study's top records with the result.
The scalar discrete-event engine and the fidelity harness behind
``cli validate`` come with that command.

The validate layer is loaded lazily so that ``repro_torch.api`` itself
(Scenario schedule validation) can import this package without a cycle.
"""
from repro_torch.events.dag import (SCHEDULES, StepProgram, TaskSpec,  # noqa: F401
                                    compile_step, device_op_order)
from repro_torch.events.batch import replay_batch, replay_rows  # noqa: F401
from repro_torch.events.compile_batch import (CompiledBatch,  # noqa: F401
                                              compile_batch)

_LAZY = ("stamp_validation",)


def __getattr__(name):
    if name in _LAZY:
        from repro_torch.events import validate as _v
        return getattr(_v, name)
    raise AttributeError(
        f"module 'repro_torch.events' has no attribute {name!r}")


__all__ = ["SCHEDULES", "StepProgram", "TaskSpec", "compile_step",
           "device_op_order", "replay_batch", "replay_rows",
           "CompiledBatch", "compile_batch", *_LAZY]
