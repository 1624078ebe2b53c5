"""PyTorch/CUDA port of the Byz-VR-MARINA-PP reproduction.

The JAX package ``repro`` is the reference; this package keeps its layout
and names.  Its entry points run on the card (``device=None`` means
"cuda") and raise where there is none, unless the caller passes
``device="cpu"``, which runs the kernels' plain PyTorch versions.
"""
