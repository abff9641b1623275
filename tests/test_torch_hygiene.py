"""What the port must never do: import JAX, the JAX package or msgpack
(the WAL's codec is the port's own, so no msgpack need be installed),
carry on quietly on the CPU, fall back from a kernel to its plain
version, or build anywhere but an ignored directory."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, counts, ops

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", PORT_FILES + ["chip_smoke.py"])
def test_source_imports_no_jax_and_nothing_of_repro(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    """Every submodule of repro_torch, and chip_smoke's module-level code,
    in a fresh interpreter: neither jax nor repro may end up loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'msgpack'))\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]), bad)\n"
    )
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT)])}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded, bad = out.stdout.split(" ", 1)
    assert int(loaded) >= 15 and bad.strip() == "[]", out.stdout


@pytest.mark.parametrize("entry", ["build_index", "build_flat_index", "FlatBackend",
                                   "flat_index_from_arrays", "flat-pq", "cp_fused_search",
                                   "train_codec", "codec_from_arrays", "streaming",
                                   "StreamingIndex.from_arrays", "pmtree",
                                   "PMTreeBackend.from_arrays", "PMLSH", "PMLSH_CP",
                                   "multiprobe", "srs", "bucket_families_from_arrays",
                                   "recover", "QualityAuditor",
                                   "QualityAuditor.for_index", "ShardedFlatIndex",
                                   "DistributedFlatIndex", "DistributedCP",
                                   "make_data_mesh", "sharded-flat"])
def test_entry_points_default_to_cuda_and_raise_without_it(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device works here")
    from repro_torch.convert import (
        bucket_families_from_arrays,
        codec_from_arrays,
        flat_index_from_arrays,
    )
    from repro_torch.core import (
        PMLSH,
        PMLSH_CP,
        DistributedCP,
        DistributedFlatIndex,
        ShardedFlatIndex,
        build_flat_index,
    )
    from repro_torch.core.cp_fused import cp_fused_search
    from repro_torch.index import FlatBackend, IndexConfig, PMTreeBackend, build_index
    from repro_torch.launch import make_data_mesh
    from repro_torch.obs import QualityAuditor
    from repro_torch.quant import train_codec
    from repro_torch.resilience import recover
    from repro_torch.stream import StreamingIndex

    data = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    call = {"build_index": lambda: build_index(data),
            "build_flat_index": lambda: build_flat_index(data),
            "FlatBackend": lambda: FlatBackend(data),
            "flat_index_from_arrays": lambda: flat_index_from_arrays(
                data, np.ones((8, 15), np.float32), m=15),
            "flat-pq": lambda: build_index(data, IndexConfig(backend="flat-pq")),
            "cp_fused_search": lambda: cp_fused_search(data, 5),
            "train_codec": lambda: train_codec("sq8", data),
            "codec_from_arrays": lambda: codec_from_arrays(
                scale=np.ones(8, np.float32), offset=np.zeros(8, np.float32)),
            "streaming": lambda: build_index(data, IndexConfig(
                backend="streaming", options={"segment_backend": "flat"})),
            "StreamingIndex.from_arrays": lambda: StreamingIndex.from_arrays(
                data, np.ones((8, 15), np.float32),
                IndexConfig(backend="streaming", options={"segment_backend": "flat"})),
            "pmtree": lambda: build_index(data, IndexConfig(backend="pmtree")),
            "PMTreeBackend.from_arrays": lambda: PMTreeBackend.from_arrays(
                data, np.ones((8, 15), np.float32)),
            "PMLSH": lambda: PMLSH(data),
            "PMLSH_CP": lambda: PMLSH_CP(data),
            "multiprobe": lambda: build_index(data, IndexConfig(backend="multiprobe")),
            "srs": lambda: build_index(data, IndexConfig(backend="srs")),
            "bucket_families_from_arrays": lambda: bucket_families_from_arrays(
                [(np.ones((8, 5), np.float32), np.zeros(5, np.float32), 4.0)]),
            "recover": lambda: recover(durable_dir()),
            "QualityAuditor": lambda: QualityAuditor(lambda: (np.arange(64), data)),
            # an index that names no device: the auditor's default, the card
            "QualityAuditor.for_index": lambda: QualityAuditor.for_index(
                type("Rows", (), {"data": data, "d": 8, "config": IndexConfig()})()),
            "ShardedFlatIndex": lambda: ShardedFlatIndex(data, shards=2),
            "DistributedFlatIndex": lambda: DistributedFlatIndex(data),
            "DistributedCP": lambda: DistributedCP(data),
            "make_data_mesh": lambda: make_data_mesh(4),
            "sharded-flat": lambda: build_index(data, IndexConfig(
                backend="sharded-flat", options={"shards": 2}))}[entry]

    def durable_dir():  # a directory a CPU index wrote, recovered by default
        d = tmp_path / "durable"
        build_index(data, IndexConfig(backend="streaming", options={
            "segment_backend": "flat", "durability": {"dir": str(d)}}), device="cpu").close()
        return d

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def _wrapper_calls():
    from repro_torch.kernels import (
        adc,
        pair_join,
        pairwise_dist,
        project_dist,
        select,
        topk,
        verify,
    )

    z = torch.zeros
    return {
        "adc_dist": lambda: adc.adc_dist(torch.zeros(4, 3, dtype=torch.uint8), z(2, 3, 8)),
        "pair_join": lambda: pair_join.pair_join(z(9, 3), z(9), 2, thresh2=1.0),
        "pairwise_sq_dist": lambda: pairwise_dist.pairwise_sq_dist(z(2, 3), z(4, 3)),
        "pairwise_sq_dist_rows": lambda: pairwise_dist.pairwise_sq_dist_rows(
            z(2, 3), z(2, 4, 3)),
        "project_dist": lambda: project_dist.project_dist(z(4, 3), z(3, 2), z(2, 2)),
        "radius_select": lambda: select.radius_select(z(2, 9), z(2), 3, T_pad=5),
        "topk_smallest": lambda: topk.topk_smallest(z(2, 9), 3),
        "verify_topk": lambda: verify.verify_topk(
            z(9, 3), z(2, 3), torch.zeros(2, 4, dtype=torch.int32), 2),
    }


@pytest.mark.parametrize("name", sorted(counts.LAUNCHES))
def test_kernel_wrapper_raises_on_a_cpu_tensor(name):
    before = dict(counts.LAUNCHES)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        _wrapper_calls()[name]()
    assert counts.LAUNCHES == before


def test_ops_routes_cpu_tensors_to_plain_and_checks_force():
    before = dict(counts.LAUNCHES)
    q, x = torch.rand(2, 5), torch.rand(7, 5)
    assert ops.pairwise_sq_dist(q, x).shape == (2, 7)
    assert counts.LAUNCHES == before  # the plain version launches nothing
    with pytest.raises(ValueError, match="force"):
        ops.pairwise_sq_dist(q, x, force="interpret")


def test_build_targets_sm90a_under_an_ignored_directory():
    assert "arch=compute_90a,code=sm_90a" in _build.ARCH_FLAGS
    rel = _build.BUILD_ROOT.relative_to(ROOT).as_posix()
    assert rel == "build/repro_torch"
    ignored = {line.strip() for line in (ROOT / ".gitignore").read_text().splitlines()}
    assert ignored & {"build/", "/build/", "build"}
    assert sorted(p.name for p in _build.CSRC.glob("*.cu")) == [
        "adc.cu", "common.cu", "pair_join.cu", "pairwise_dist.cu", "project_dist.cu",
        "select.cu", "topk.cu", "verify.cu"]


def test_build_without_nvcc_raises():
    if shutil.which("nvcc") or pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_cuda(alone, tmp_path):
    """No card (or no repo beside it): non-zero exit and no result line."""
    if torch.cuda.is_available() and not alone:
        pytest.skip("CUDA is present: chip_smoke runs for real here")
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
