from repro_torch.runtime.fault_tolerance import (FaultTolerantLoop,  # noqa: F401
                                                 Watchdog)
