"""nemotron-4-340b [dense]: 96L d18432 96H (GQA kv=8) d_head=192
d_ff=73728 vocab=256000, a squared-ReLU ungated MLP, after
arXiv:2402.16819."""
from repro_torch.models.transformer import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b", family="dense",
        n_layers=96, d_model=18432, vocab=256000,
        n_heads=96, n_kv_heads=8, d_head=192, d_ff=73728,
        activation="relu2", ffn_gated=False, rope_theta=1e4,
        pattern=(LayerSpec(),), max_seq=32768)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-smoke", family="dense",
        n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=2, d_head=16, d_ff=192,
        activation="relu2", ffn_gated=False,
        pattern=(LayerSpec(),), max_seq=128,
        remat="none")
