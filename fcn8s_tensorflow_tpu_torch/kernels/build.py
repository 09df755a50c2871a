"""Build and load the package's CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface and include no PyTorch header, so
``nvcc`` compiles them for Hopper (``sm_90a``) in seconds, one process per
source started together, and links the objects into one shared library that
``ctypes`` loads. The library is built at first use into
``build/torch_kernels/`` beside the package, under a name that carries the
hash of the sources and the flags, so an edited source rebuilds and an
unchanged one is reused. Nothing here runs at import time: the CPU tests
import every module, and the CPU has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# dtype codes of csrc/common.cuh
FLOAT32, BFLOAT16, UINT8, INT32 = 0, 1, 2, 3

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "fcn8s_maxpool2x2_nhwc": [_P, _P, _I64, _I64, _I64, _I64, _I, _P],
    "fcn8s_maxpool2x2_code_nhwc": [_P, _P, _P, _I64, _I64, _I64, _I64, _I, _P],
    "fcn8s_maxpool2x2_bwd_nhwc": [_P, _P, _P, _I64, _I64, _I64, _I64, _I, _P],
    "fcn8s_ce_sum_per_sample": [_P, _P, _P, _P, _P, _I, _I64, _I, _I64, _I, _I, _I, _P],
    "fcn8s_ce_sum_weighted": [_P, _P, _P, _P, _P, _I, _I64, _I, _I, _I, _I, _P],
    "fcn8s_ce_grad": [_P, _P, _P, _P, _P, _I64, _I, _I64, _I, _I, _I, _I, _I, _P],
    "fcn8s_confmat_accumulate": [_P, _P, _P, _P, _I64, _I, _I64, _I, _I, _P],
    "fcn8s_conv1_core": [_P, _P, _P, _P, _I64, _I, _I64, _I, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(put nvcc on PATH or set CUDA_HOME)")


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libfcn8s_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for them exists; return its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    sources = sorted(CSRC_DIR.glob("*.cu"))
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    # one nvcc per source, all started together; then one link
    compiles = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for src, obj in zip(sources, objects)]
    failures = []
    for proc in compiles:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failures.append(f"{' '.join(proc.args)} ({proc.returncode}):\n{log}")
    tmp = out.with_name(f"{tag}.tmp.so")
    if not failures:
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            failures.append(f"link ({link.returncode}):\n{link.stdout}\n{link.stderr}")
    for obj in objects:
        obj.unlink(missing_ok=True)
    if failures:
        raise RuntimeError("nvcc failed: " + "\n".join(failures))
    os.replace(tmp, out)  # atomic: a concurrent process sees a whole library or none
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.fcn8s_error_string.argtypes = [ctypes.c_int]
    lib.fcn8s_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if rc != 0:
        msg = library().fcn8s_error_string(rc).decode()
        raise RuntimeError(f"{name} failed to launch: CUDA error {rc} ({msg})")
