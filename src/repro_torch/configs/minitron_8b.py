"""minitron-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=16384
vocab=256000 — pruned Nemotron [arXiv:2407.14679]."""
from repro_torch.models.model import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=16384,
        vocab=256000,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab=512,
    )
