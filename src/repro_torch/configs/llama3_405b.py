"""llama3-405b [dense]: 126L d16384 128H (GQA kv=8) d_ff=53248
vocab=128256, rope theta 500k, after arXiv:2407.21783."""
from repro_torch.models.transformer import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b", family="dense",
        n_layers=126, d_model=16384, vocab=128256,
        n_heads=128, n_kv_heads=8, d_head=128, d_ff=53248,
        rope_theta=5e5, pattern=(LayerSpec(),), max_seq=32768)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-smoke", family="dense",
        n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=2, d_head=16, d_ff=192,
        pattern=(LayerSpec(),), max_seq=128,
        remat="none")
