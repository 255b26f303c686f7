"""jamba-v0.1-52b [hybrid]: 32L d4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2, mamba:attention 7:1 interleave, MoE on
every other layer, after arXiv:2403.19887 and the published config.
Period-8 pattern: [m, m, m, a, m, m, m, m], the MoE FFN on odd
positions."""
from repro_torch.models.moe import MoEConfig
from repro_torch.models.ssm import SSMConfig
from repro_torch.models.transformer import LayerSpec, ModelConfig


def _pattern():
    return tuple(LayerSpec(kind="attn" if i == 3 else "mamba",
                           ffn="moe" if i % 2 == 1 else "dense")
                 for i in range(8))


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        n_layers=32, d_model=4096, vocab=65536,
        n_heads=32, n_kv_heads=8, d_head=128, d_ff=14336,
        rope_theta=1e6, pattern=_pattern(),
        moe=MoEConfig(d_model=4096, d_ff=14336, n_experts=16, top_k=2),
        ssm=SSMConfig(d_model=4096, d_state=16, d_conv=4, expand=2,
                      head_dim=64),
        sub_quadratic=True, max_seq=524288)


def smoke_config() -> ModelConfig:
    pattern = (LayerSpec(kind="mamba", ffn="dense"),
               LayerSpec(kind="attn", ffn="moe"))
    return ModelConfig(
        name="jamba-smoke", family="hybrid",
        n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
        pattern=pattern,
        moe=MoEConfig(d_model=64, d_ff=128, n_experts=4, top_k=2),
        ssm=SSMConfig(d_model=64, d_state=16, d_conv=4, expand=2,
                      head_dim=16, chunk=16),
        sub_quadratic=True, max_seq=128, remat="none")
