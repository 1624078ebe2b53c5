"""mamba2-780m [ssm]: 48L d_model=1536, attention-free, d_ff=0 (mixer-only
blocks), vocab=50280, ssm_state=128 — SSD / state-space duality
[arXiv:2405.21060]."""
from repro_torch.models.model import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m",
        n_layers=48,
        d_model=1536,
        n_heads=1,  # unused (attention-free)
        n_kv_heads=1,
        d_ff=0,
        vocab=50280,
        head_dim=64,
        mixer_pattern=("ssm",),
        mlp_pattern=("none",),
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m-smoke",
        n_layers=2,
        d_model=128,
        n_heads=1,
        n_kv_heads=1,
        d_ff=0,
        vocab=512,
        head_dim=64,
        mixer_pattern=("ssm",),
        mlp_pattern=("none",),
        ssm_state=16,
        ssm_head_dim=32,
        ssm_chunk=32,
    )
