"""llama-3.2-vision-90b [vlm]: 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — cross-attention image layers every 5th layer
[hf:meta-llama/Llama-3.2-11B-Vision scaled to 90B].

The ViT/projector frontend is a STUB: inputs include precomputed projected
vision tokens (B, n_vis, d_model)."""
from repro_torch.models.model import ModelConfig

_MIXER = ("cross", "attn", "attn", "attn", "attn")
_MLP = ("dense",) * 5


def full() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b",
        n_layers=100,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=28672,
        vocab=128256,
        mixer_pattern=_MIXER,
        mlp_pattern=_MLP,
        input_kind="tokens+vision",
        n_vision_tokens=1601,  # 1 tile of 1600 patches + class token
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b-smoke",
        n_layers=4,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab=512,
        mixer_pattern=("cross", "attn", "attn", "attn"),
        mlp_pattern=("dense",) * 4,
        input_kind="tokens+vision",
        n_vision_tokens=17,
    )
