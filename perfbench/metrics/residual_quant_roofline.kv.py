"""residual_quant_roofline.kv: the least time the card could take to
quantize the parked caches' residuals over the device time of the port's
``residual_quant`` kernel (``csrc/residual_quant.cu``) in the trace.

For each of K and V of a session of n elements parked: the bf16 cache
read (2n bytes), the int8 residuals written (n) and each block's
parameters written (theta and slope in bf16, the step in float32: 8 bytes
a block), at the memory's rate."""
from harness.peaks import HBM_BYTES_PER_S
from harness.readers import kernel_seconds, share

PATTERNS = (r"residual_quant_kernel",)


def park_bytes(n: int, block: int) -> int:
    return 2 * n + n + 8 * (-(-n // block))


def read(view):
    if view is None or view.trace is None:
        return None
    need = sum(2 * park_bytes(n, view.block) for n in view.elements)
    return share(need / HBM_BYTES_PER_S, kernel_seconds(view.trace, PATTERNS))
