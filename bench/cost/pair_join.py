"""JOIN of the closest-pair query: the k nearest pairs of n rows (n, d)
sorted by their key (n,), skipping pairs whose key gap is past reach.

The rows and keys read once, the k answers (squared distance and the two
positions) written once; one multiply-add a dimension of each pair the
filter must verify (``pairs``: the pairs whose key gap is within reach
of the answer's k-th distance, counted by the reference)."""
KERNELS = (r"\bpair_join_kernel\b",)


def cost(n: int, d: int, k: int, pairs: int) -> tuple[int, int]:
    """(bytes, FLOPs)."""
    return 4 * (n * d + n) + 12 * k, 2 * d * pairs
