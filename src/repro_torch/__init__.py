"""PyTorch/CUDA port of the Loom reproduction (the JAX package ``repro``
is its reference).

    import repro_torch
    from repro_torch import configs
    from repro_torch.core.policy import uniform_policy
    session = repro_torch.compile(configs.get("paper_cnn"),
                                  uniform_policy(8, 8), mode="serve_packed",
                                  backend="cuda")
    logits = session.classify(images)      # NHWC float [B, 32, 32, 3]

The package imports torch and numpy only. Its CUDA kernels are built on
first use (``repro_torch.kernels._build``), never at import.
"""
from repro_torch.api.plan import ExecutionPlan, LayerPlan, build_plan
from repro_torch.api.session import ServingSession, compile

__all__ = ["ExecutionPlan", "LayerPlan", "ServingSession", "build_plan",
           "compile"]
