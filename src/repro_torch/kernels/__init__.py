"""Hand-written CUDA kernels (``csrc/*.cu``) with their plain torch
versions; ``ops`` holds the public entry points.

One module a kernel family, each with its ``*_cuda`` launcher, its
``*_plain`` torch version and the wrapper that picks by device:
``cone_scan`` (Alg. 3), ``rans`` (encode and decode), ``residual_quant``
(and the ladder ``pyramid_quant``), ``dequant`` (and
``pyramid_reconstruct``), ``base_fit`` (the tensor codec's line),
``segment_agg``, ``flash_attention`` and ``interval_stats``.
"""
