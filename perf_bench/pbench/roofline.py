"""The yardstick of the port's kernels: the card's published peaks and the
work of each launch, counted from its shape (each input byte read once,
each output byte written once)."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_BYTES_PER_S = 3.35e12       # HBM3
PEAK_F32_OPS_PER_S = 67e12       # float32 outside the tensor cores


def k1_bytes(P: int, A: int, Q: int, B: int, W: int) -> int:
    """K1 (``cross_check``): the int64 descriptor words and the bool flags
    of both sets read once; best_b and best_d (int32) and matched (bool)
    written once per a-row."""
    return 8 * W * (P * A + Q * B) + P * A + Q * B + 9 * P * A


def k1_ops(P: int, A: int, Q: int, B: int, W: int) -> int:
    """K1's distance work as 32-bit operations (xor, popcount, add a word
    pair).  K1 does it with b1 tensor-core MMAs, for which the data sheet
    gives no rate, so no peak divides this count: K1's least time is its
    bytes bound alone."""
    return 3 * P * A * B * W


def k1_least_s(shape) -> float:
    return k1_bytes(*shape) / PEAK_BYTES_PER_S


def k2_bytes(B: int, H: int, W: int) -> int:
    """K2 (``wavefront_relax``): the traversal costs and the seed
    potential read once, the potential written once (float32)."""
    return 3 * 4 * B * H * W


def k2_ops(B: int, H: int, W: int, n_iter: int) -> int:
    """K2's min-plus work: a cell and Jacobi iteration takes 8 neighbour
    adds, 8 mins, the diagonal multiply and the final min."""
    return 18 * B * H * W * n_iter


def k2_least_s(shape) -> tuple[float, str]:
    """(least seconds, "operations" or "bytes") of a K2 launch of shape
    (B, H, W, n_iter) on the float32 units."""
    B, H, W, n_iter = shape
    t_bytes = k2_bytes(B, H, W) / PEAK_BYTES_PER_S
    t_ops = k2_ops(B, H, W, n_iter) / PEAK_F32_OPS_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
