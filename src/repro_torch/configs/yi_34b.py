"""yi-34b [dense]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000 —
llama-architecture GQA [arXiv:2403.04652]."""
from repro_torch.models.model import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="yi-34b",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=20480,
        vocab=64000,
        head_dim=128,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="yi-34b-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,  # 56 heads in full; reduced keeps GQA ratio
        n_kv_heads=2,
        d_ff=256,
        vocab=512,
        head_dim=32,
    )
