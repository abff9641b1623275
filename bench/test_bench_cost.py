"""The cost models (bench/cost/<kernel>.py) against hand counts, and their
kernel names against the program's CUDA sources."""
import re
from pathlib import Path

import pytest

from bench.lib.harness import BENCH, CSRC, load_module
from bench.lib.profiling import csrc_kernel_names

KERNELS = sorted(p.stem for p in (BENCH / "cost").glob("*.py"))


def test_estimate_by_hand():
    cost = load_module(BENCH / "cost" / "estimate.py")
    # 2 queries, 3 rows, m = 4: read 2*4 + 3*4 floats, write 2*3; 2*3*4 MACs
    assert cost.cost(B=2, n=3, m=4) == (4 * (8 + 12 + 6), 2 * 24)


def test_select_by_hand():
    cost = load_module(BENCH / "cost" / "select.py")
    # 2 rows of 10 estimates read once, 2 x 3 (value, id) pairs written
    assert cost.cost(B=2, n=10, T=3) == (4 * 20 + 8 * 6, 20)


def test_verify_by_hand():
    cost = load_module(BENCH / "cost" / "verify.py")
    # 5 distinct rows of d = 4, 2 x 3 candidate ids, 2 queries, 2 x 2 answers
    # of (distance, id); a MAC a dimension of 6 (query, candidate) pairs
    assert cost.cost(B=2, T=3, d=4, k=2, rows=5) == (4 * (20 + 6 + 8 + 8), 2 * 6 * 4)


def test_pair_join_by_hand():
    cost = load_module(BENCH / "cost" / "pair_join.py")
    # 6 rows of d = 3 and their keys read, 2 answers of 12 bytes, 7 pairs
    assert cost.cost(n=6, d=3, k=2, pairs=7) == (4 * (18 + 6) + 24, 2 * 3 * 7)


@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_names_exist_in_the_program(kernel):
    names = csrc_kernel_names(CSRC)
    cost = load_module(BENCH / "cost" / f"{kernel}.py")
    assert cost.KERNELS
    for pattern in cost.KERNELS:
        rx = re.compile(pattern)
        assert any(rx.search(f"void {n}<8>(float const*, int)") for n in names), pattern


def test_csrc_names_are_read():
    names = csrc_kernel_names(CSRC)
    assert {"pair_join_kernel", "select_pass_kernel", "verify_dist_kernel",
            "pairwise_narrow_kernel", "topk_kernel"} <= names
    assert Path(CSRC).is_dir()
