"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2 — Mamba+attention 1:7 interleave, MoE
every other layer [arXiv:2403.19887]."""
from repro_torch.models.model import ModelConfig

# period of 8: 1 attention layer + 7 mamba layers; MoE on odd positions
_MIXER = ("ssm", "ssm", "ssm", "attn", "ssm", "ssm", "ssm", "ssm")
_MLP = ("dense", "moe", "dense", "moe", "dense", "moe", "dense", "moe")


def full() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=65536,
        mixer_pattern=_MIXER,
        mlp_pattern=_MLP,
        n_experts=16,
        experts_per_token=2,
        ssm_state=16,
        ssm_head_dim=64,
        ssm_expand=2,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b-smoke",
        n_layers=4,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab=512,
        mixer_pattern=("ssm", "attn", "ssm", "ssm"),
        mlp_pattern=("dense", "moe", "dense", "moe"),
        n_experts=4,
        experts_per_token=2,
        ssm_state=16,
        ssm_head_dim=32,
        ssm_chunk=32,
    )
