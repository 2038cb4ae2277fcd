from repro_torch.checkpoint.manager import (CheckpointManager,  # noqa: F401
                                            restore_pytree, save_pytree)
