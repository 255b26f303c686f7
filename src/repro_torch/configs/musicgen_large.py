"""musicgen-large [audio]: 48L d2048 32H (kv=32, MHA) d_ff=8192
vocab=2048, gelu, a decoder over EnCodec tokens, after arXiv:2306.05284.
The EnCodec frontend is a stub: the inputs are the codec token ids."""
from repro_torch.models.transformer import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", family="audio",
        n_layers=48, d_model=2048, vocab=2048,
        n_heads=32, n_kv_heads=32, d_head=64, d_ff=8192,
        activation="gelu", rope_theta=1e4,
        pattern=(LayerSpec(),), max_seq=32768)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke", family="audio",
        n_layers=2, d_model=64, vocab=64,
        n_heads=4, n_kv_heads=4, d_head=16, d_ff=128,
        activation="gelu", pattern=(LayerSpec(),), max_seq=128,
        remat="none")
