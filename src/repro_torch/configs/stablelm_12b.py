"""stablelm-12b [dense]: 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352 [hf:stabilityai/stablelm-2-1_6b family]."""
from repro_torch.models.model import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        d_ff=13824,
        vocab=100352,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b-smoke",
        n_layers=2,
        d_model=160,
        n_heads=4,
        n_kv_heads=2,
        d_ff=320,
        vocab=512,
    )
