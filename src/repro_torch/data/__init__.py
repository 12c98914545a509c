from repro_torch.data.pipeline import (DataConfig, SyntheticLMDataset,
                                       build_pipeline, host_shard_slice)

__all__ = ["DataConfig", "SyntheticLMDataset", "build_pipeline",
           "host_shard_slice"]
