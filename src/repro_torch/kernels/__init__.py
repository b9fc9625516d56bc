"""Hand-written CUDA kernels (``csrc/*.cu``) with their plain torch
versions; ``ops`` holds the public entry points."""
