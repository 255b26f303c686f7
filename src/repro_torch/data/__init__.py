from repro_torch.data.pipeline import (DataConfig, host_shard_batch,
                                       make_iterator, rank_rows,
                                       synthetic_batch)

__all__ = ["DataConfig", "host_shard_batch", "make_iterator", "rank_rows",
           "synthetic_batch"]
