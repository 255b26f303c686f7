"""Optimizer side of training: AdamW, the learning-rate schedule and
error-feedback gradient compression (PyTorch-port counterpart of
``repro/optim``)."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     clip_by_global_norm, global_norm)
from repro_torch.optim.compression import (CompressionConfig,
                                           compress_state_init,
                                           compressed_gradient)
from repro_torch.optim.schedule import Schedule, make_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm",
           "global_norm", "CompressionConfig", "compress_state_init",
           "compressed_gradient", "Schedule", "make_schedule"]
