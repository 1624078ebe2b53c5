"""deepseek-7b [dense]: 30L d_model=4096 32H (MHA: kv=32) d_ff=11008
vocab=102400 — llama-architecture [arXiv:2401.02954]."""
from repro_torch.models.model import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b",
        n_layers=30,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        d_ff=11008,
        vocab=102400,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab=512,
    )
