"""mamba2-370m [ssm]: 48L d1024 attention-free, vocab 50280 padded to
50304, d_state 128, SSD (state-space duality), after arXiv:2405.21060.
Mamba blocks only (no FFN), as in the release; the six projections are
Loom linears, the recurrence stays float32."""
from repro_torch.models.ssm import SSMConfig
from repro_torch.models.transformer import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m", family="ssm",
        n_layers=48, d_model=1024, vocab=50304,
        pattern=(LayerSpec(kind="mamba", ffn="none"),),
        ssm=SSMConfig(d_model=1024, d_state=128, d_conv=4, expand=2,
                      head_dim=64),
        sub_quadratic=True, max_seq=524288)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm",
        n_layers=2, d_model=64, vocab=256,
        pattern=(LayerSpec(kind="mamba", ffn="none"),),
        ssm=SSMConfig(d_model=64, d_state=16, d_conv=4, expand=2,
                      head_dim=16, chunk=16),
        sub_quadratic=True, max_seq=128, remat="none")
