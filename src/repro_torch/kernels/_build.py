"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` source compiles for ``sm_90a`` with plain ``nvcc``
(one process per source, all started together) into an object, and one
more ``nvcc -shared`` links the objects into a single library with a C
interface.  The library goes under ``build/repro_torch/`` at the root
of the checkout, in a directory named by a hash of the sources and the
flags: an edited source builds anew, an unchanged one loads what was
built before.  The build runs at the first kernel call, never at
import, and a failed build raises with the compiler's output.

Pointers and the stream cross as ``c_void_p``; every launch entry
returns ``cudaGetLastError()`` and :func:`check` raises on a non-zero
code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["ARCH_FLAGS", "BUILD_ROOT", "build", "check", "load", "nvcc"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"

_P, _I = ctypes.c_void_p, ctypes.c_int
_L, _D = ctypes.c_longlong, ctypes.c_double
# name → (restype, argtypes) of every C entry the wrappers call
SIGNATURES = {
    "rt_error_string": (ctypes.c_char_p, [_I]),
    "pairwise_sq_dist_launch": (_I, [_P, _P, _P, _I, _I, _I, _P]),
    "pairwise_sq_dist_rows_launch": (_I, [_P, _P, _P, _I, _I, _I, _P]),
    "radius_select_scratch_ints": (ctypes.c_longlong, [_I, _I]),
    "radius_select_launch": (_I, [_P, _P, _P, _I, _I, _I,
                                  _P, _P, _P, _P, _P, _P]),
    "verify_topk_group_size": (_I, [_I, _I]),
    "verify_topk_chunk": (_I, [_I, _I]),
    "verify_topk_scratch_bytes": (_L, [_I, _I, _I, _I, _I]),
    "verify_topk_launch": (_I, [_P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _P]),
    "adc_dist_launch": (_I, [_P, _L, _P, _P, _I, _I, _I, _I, _P]),
    "pair_join_scratch_bytes": (_L, [_I, _I, _I]),
    "pair_join_launch": (_I, [_P, _P, _I, _I, _I, _I, _D, _P, _P, _P, _P, _P, _L, _P]),
    "topk_smallest_launch": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "project_dist_launch": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def nvcc() -> str:
    """Path of nvcc: on PATH, else the toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("repro_torch: nvcc not found; the CUDA kernels "
                       "build only where the CUDA toolkit is installed")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for flag in ARCH_FLAGS + NVCC_FLAGS:
        h.update(flag.encode() + b"\0")
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile and link the library unless this digest is built; returns
    its path.  The compiler's output (ptxas' register and shared-memory
    report included) is kept beside it in ``build.log``."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tool = nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [tool, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            objs.append(str(obj))
        log, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if not failed:
            tmp_lib = Path(tmp) / LIB_NAME
            link = subprocess.run(
                [tool, *ARCH_FLAGS, "-shared", *objs, "-o", str(tmp_lib)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            log.append(f"== link (rc {link.returncode})\n{link.stdout}")
            if link.returncode != 0:
                failed.append("link")
            else:
                os.replace(tmp_lib, lib_path)  # atomic: concurrent builds agree
        (out_dir / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"repro_torch: nvcc failed on {failed}:\n"
                           + "\n".join(log))
    return lib_path


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with typed C entries."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch entry reported a CUDA error."""
    if err != 0:
        msg = load().rt_error_string(err).decode(errors="replace")
        raise RuntimeError(f"repro_torch: {what} failed: CUDA error {err} ({msg})")
