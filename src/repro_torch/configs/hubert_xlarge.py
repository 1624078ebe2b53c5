"""hubert-xlarge [audio]: 48L d_model=1280 16H d_ff=5120 vocab=504 —
encoder-only (same backbone as wav2vec2) [arXiv:2106.07447].

The conv/mel frontend is a STUB: inputs are precomputed frame embeddings
(B, S, frame_dim) projected by a single linear layer; the loss is masked
codebook prediction over 504 classes.  Encoder-only => no decode shapes
(skips recorded in DESIGN.md / EXPERIMENTS.md)."""
from repro_torch.models.model import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        d_ff=5120,
        vocab=504,
        causal=False,
        input_kind="frames",
        frame_dim=512,  # conv feature-extractor output dim (w2v2/HuBERT)
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab=64,
        causal=False,
        input_kind="frames",
        frame_dim=32,
    )
