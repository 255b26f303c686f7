"""llama-3.2-vision-90b [vlm]: 100L d8192 64H (GQA kv=8) d_ff=28672
vocab=128256, a cross-attention image layer every 5th layer, after the
published meta-llama/Llama-3.2-90B-Vision config. The vision frontend is
a stub: prefill takes precomputed image embeddings [B, n_img_tokens =
4096, d_model], and the cross layers attend over them (their K/V
projected into the cache at prefill)."""
from repro_torch.models.transformer import LayerSpec, ModelConfig


def _pattern():
    return tuple(LayerSpec(kind="attn") for _ in range(4)) + (
        LayerSpec(kind="cross"),)


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b", family="vlm",
        n_layers=100, d_model=8192, vocab=128256,
        n_heads=64, n_kv_heads=8, d_head=128, d_ff=28672,
        rope_theta=5e5, pattern=_pattern(), n_img_tokens=4096,
        max_seq=32768)


def smoke_config() -> ModelConfig:
    pattern = (LayerSpec(kind="attn"), LayerSpec(kind="cross"))
    return ModelConfig(
        name="vision-smoke", family="vlm",
        n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
        pattern=pattern, n_img_tokens=32, max_seq=128,
        remat="none")
