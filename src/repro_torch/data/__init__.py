from repro_torch.data.pipeline import (DataConfig, host_shard_batch,
                                       make_iterator, synthetic_batch)

__all__ = ["DataConfig", "host_shard_batch", "make_iterator",
           "synthetic_batch"]
