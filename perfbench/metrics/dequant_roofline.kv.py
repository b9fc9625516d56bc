"""dequant_roofline.kv: the least time the card could take to restore the
parked caches over the device time of the port's ``dequant`` kernel
(``csrc/dequant.cu``) in the trace.

For each of K and V of a session of n elements restored: the int8
residuals read (n bytes), each block's parameters read (8 bytes a block)
and the bf16 cache written (2n), at the memory's rate."""
from harness.peaks import HBM_BYTES_PER_S
from harness.readers import kernel_seconds, share

PATTERNS = (r"dequant_kernel",)


def restore_bytes(n: int, block: int) -> int:
    return n + 8 * (-(-n // block)) + 2 * n


def read(view):
    if view is None or view.trace is None:
        return None
    need = sum(2 * restore_bytes(n, view.block) for n in view.elements)
    return share(need / HBM_BYTES_PER_S, kernel_seconds(view.trace, PATTERNS))
