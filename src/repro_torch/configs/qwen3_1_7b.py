"""qwen3-1.7b [dense]: 28L d2048 16H (GQA kv=8) d_head 128 d_ff=6144
vocab=151936, qk-norm, rope theta 1e6, after the published
Qwen/Qwen3-1.7B config."""
from repro_torch.models.transformer import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b", family="dense",
        n_layers=28, d_model=2048, vocab=151936,
        n_heads=16, n_kv_heads=8, d_head=128, d_ff=6144,
        qk_norm=True, rope_theta=1e6, pattern=(LayerSpec(),), max_seq=32768)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-smoke", family="dense",
        n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
        qk_norm=True, pattern=(LayerSpec(),), max_seq=128,
        remat="none")
