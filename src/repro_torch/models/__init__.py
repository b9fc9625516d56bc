"""Model building blocks in PyTorch, counterpart of ``repro.models``.  So
far only the decode-cache containers the serving KV store needs."""
