"""ESTIMATE: projected squared distances of B projected queries (B, m) to
the n projected rows (n, m), written out as (B, n) float32.

Each input byte read once, each output byte written once; one
multiply-add (2 FLOPs) a dimension of each (query, row) pair."""
KERNELS = (r"\bpairwise_narrow_kernel\b", r"\bpairwise_wide_kernel\b")


def cost(B: int, n: int, m: int) -> tuple[int, int]:
    """(bytes, FLOPs)."""
    return 4 * (B * m + n * m + B * n), 2 * B * n * m
