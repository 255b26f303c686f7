"""gemma3-12b [dense]: 48L d3840 16H (GQA kv=8) d_head=256 d_ff=15360
vocab=262144, qk-norm, a 5:1 local (sliding window 1024) : global
pattern, after the published google/gemma-3-12b-pt config."""
from repro_torch.models.transformer import LayerSpec, ModelConfig

LOCAL_WINDOW = 1024


def config() -> ModelConfig:
    pattern = tuple(LayerSpec(window=LOCAL_WINDOW) for _ in range(5)) + (
        LayerSpec(window=None),)
    return ModelConfig(
        name="gemma3-12b", family="dense",
        n_layers=48, d_model=3840, vocab=262144,
        n_heads=16, n_kv_heads=8, d_head=256, d_ff=15360,
        qk_norm=True, rope_theta=1e6, pattern=pattern, sub_quadratic=True,
        max_seq=524288)


def smoke_config() -> ModelConfig:
    pattern = (LayerSpec(window=16), LayerSpec(window=None))
    return ModelConfig(
        name="gemma3-smoke", family="dense",
        n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
        qk_norm=True, pattern=pattern, sub_quadratic=True, max_seq=128,
        remat="none")
