from repro_torch.checkpoint.manager import (CheckpointConfig,
                                            CheckpointManager, latest_step,
                                            restore, save)

__all__ = ["CheckpointManager", "CheckpointConfig", "latest_step",
           "restore", "save"]
