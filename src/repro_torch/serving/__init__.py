"""Serving utilities in PyTorch, counterpart of ``repro.serving``.  So far
the KV-cache store (``kvcache``)."""
