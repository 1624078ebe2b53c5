"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 + dense residual FFN in parallel
[hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.models.model import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=4864,
        vocab=32000,
        head_dim=128,
        mixer_pattern=("attn",),
        mlp_pattern=("moe",),
        n_experts=128,
        experts_per_token=2,
        moe_dense_residual=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        head_dim=32,
        mixer_pattern=("attn",),
        mlp_pattern=("moe",),
        n_experts=4,
        experts_per_token=2,
        moe_dense_residual=True,
    )
