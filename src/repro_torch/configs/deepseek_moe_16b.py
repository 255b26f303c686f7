"""deepseek-moe-16b [moe]: 28L d2048 16H (kv=16, MHA) d_ff=1408/expert,
vocab=102400, 64 routed experts top-6 + 2 shared (fine-grained), after
arXiv:2401.06066 and the published config. Layer 0 is a dense FFN (d_ff
10944), as in the release; layers 1..27 are MoE."""
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LayerSpec, ModelConfig


def config() -> ModelConfig:
    moe = MoEConfig(d_model=2048, d_ff=1408, n_experts=64, top_k=6,
                    n_shared=2, shared_d_ff=2816)
    pattern = (LayerSpec(kind="attn", ffn="dense"),) + tuple(
        LayerSpec(kind="attn", ffn="moe") for _ in range(27))
    return ModelConfig(
        name="deepseek-moe-16b", family="moe",
        n_layers=28, d_model=2048, vocab=102400,
        n_heads=16, n_kv_heads=16, d_head=128, d_ff=10944,
        rope_theta=1e4, pattern=pattern, moe=moe, max_seq=32768)


def smoke_config() -> ModelConfig:
    moe = MoEConfig(d_model=64, d_ff=32, n_experts=8, top_k=3,
                    n_shared=1, shared_d_ff=64)
    pattern = (LayerSpec(kind="attn", ffn="dense"),
               LayerSpec(kind="attn", ffn="moe"))
    return ModelConfig(
        name="deepseek-smoke", family="moe",
        n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=4, d_head=16, d_ff=128,
        pattern=pattern, moe=moe, max_seq=128,
        remat="none")
