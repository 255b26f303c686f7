"""Optimizer side of training: AdamW, the learning-rate schedule and
error-feedback gradient compression (PyTorch-port counterpart of
``repro/optim``)."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     clip_by_global_norm, global_norm,
                                     opt_state_specs)
from repro_torch.optim.compression import (CompressionConfig,
                                           compress_state_init,
                                           compressed_gradient,
                                           compressed_psum)
from repro_torch.optim.schedule import Schedule, make_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm",
           "global_norm", "opt_state_specs", "CompressionConfig",
           "compress_state_init", "compressed_gradient", "compressed_psum",
           "Schedule", "make_schedule"]
