"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff=2048(per expert)
vocab=129280, MoE 1 shared + 256 routed top-8, MLA attention, MTP head
[arXiv:2412.19437].  First 3 layers use a dense FFN (d_ff 18432)."""
from repro_torch.models.model import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,
        d_ff=2048,  # per-expert FFN width
        vocab=129280,
        head_dim=128,
        attn_kind="mla",
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_rope_dim=64,
        mixer_pattern=("attn",),
        mlp_pattern=("moe",),
        first_dense_layers=3,
        first_dense_ff=18432,
        n_experts=256,
        experts_per_token=8,
        n_shared_experts=1,
        mtp_depth=1,
        capacity_factor=1.25,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b-smoke",
        n_layers=3,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=64,
        vocab=512,
        head_dim=32,
        attn_kind="mla",
        q_lora_rank=48,
        kv_lora_rank=32,
        qk_rope_dim=16,
        mixer_pattern=("attn",),
        mlp_pattern=("moe",),
        first_dense_layers=1,
        first_dense_ff=128,
        n_experts=4,
        experts_per_token=2,
        n_shared_experts=1,
        mtp_depth=1,
    )
