"""SELECT: the T smallest of each query's n estimates, from (B, n) float32
to T (value, id) pairs of 4 bytes each.

The B x n estimates read once (not the threshold ladder's passes), the
B x T selection written once; one compare an estimate."""
KERNELS = (r"\bselect_ladder_kernel\b", r"\bselect_pass_kernel\b",
           r"\bselect_compact_kernel\b")


def cost(B: int, n: int, T: int) -> tuple[int, int]:
    """(bytes, FLOPs)."""
    return 4 * B * n + 8 * B * T, B * n
