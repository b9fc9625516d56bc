"""PyTorch/CUDA port of the SHRINK codec for NVIDIA Hopper (H100).

Mirrors ``repro`` module for module (``repro_torch.core.semantics`` <->
``repro.core.semantics``, ...) and never imports it or JAX.  The codec's
entry points run on the card unless the caller passes ``device="cpu"``.
"""
