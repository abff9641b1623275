"""Shared test configuration.

NOTE: do NOT set XLA_FLAGS / device-count here — smoke tests and
benchmarks must see the real single-device CPU backend.  Only
launch/dryrun.py forces the 512-device placeholder topology, and the
multidevice CI leg exports XLA_FLAGS=--xla_force_host_platform_device_count=8
in its environment BEFORE pytest starts (see .github/workflows/ci.yml).
"""
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "multidevice: needs >1 jax device (run under "
        "XLA_FLAGS=--xla_force_host_platform_device_count=8); the "
        "multi_devices fixture SKIPS — never silently passes — on one "
        "device")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the repro_torch CUDA "
        "kernels); SKIPS visibly where torch.cuda.is_available() is false")


@pytest.fixture()
def multi_devices():
    """Gate for shard_map-over-real-devices tests: yields the device
    count when >1, and skips VISIBLY otherwise, so a multidevice test
    collected on a single-device host shows up as 's', not a vacuous
    pass."""
    import jax

    n = jax.device_count()
    if n < 2:
        pytest.skip(
            "needs >1 jax device: run under "
            "XLA_FLAGS=--xla_force_host_platform_device_count=8")
    return n


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def make_clustered(n: int, d: int, n_clusters: int = 20, spread: float = 0.5,
                   scale: float = 4.0, seed: int = 0) -> np.ndarray:
    """Clustered Gaussian mixture — matches the 'structured' regime of the
    paper's real datasets (low LID relative to ambient d)."""
    r = np.random.default_rng(seed)
    centers = r.normal(size=(n_clusters, d)) * scale
    asg = r.integers(0, n_clusters, n)
    return (centers[asg] + r.normal(size=(n, d)) * spread).astype(np.float32)
