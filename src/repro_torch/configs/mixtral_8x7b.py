"""mixtral-8x7b [moe]: 32L d4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
MoE 8 experts top-2, sliding-window attention (4096), after
arXiv:2401.04088 and the published config."""
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LayerSpec, ModelConfig

WINDOW = 4096


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="moe",
        n_layers=32, d_model=4096, vocab=32000,
        n_heads=32, n_kv_heads=8, d_head=128, d_ff=14336,
        rope_theta=1e6,
        pattern=(LayerSpec(kind="attn", ffn="moe", window=WINDOW),),
        moe=MoEConfig(d_model=4096, d_ff=14336, n_experts=8, top_k=2,
                      expert_parallel=False),
        sub_quadratic=True, max_seq=524288)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke", family="moe",
        n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
        pattern=(LayerSpec(kind="attn", ffn="moe", window=32),),
        moe=MoEConfig(d_model=64, d_ff=128, n_experts=4, top_k=2,
                      expert_parallel=False),
        sub_quadratic=True, max_seq=128, remat="none")
