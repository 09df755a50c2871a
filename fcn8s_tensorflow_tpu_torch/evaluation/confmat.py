"""ctypes binding to the native confusion-matrix kernel, and its numpy twins.

Port of ``fcn8s_tensorflow_tpu/evaluation/confmat.py`` over the port's own
copy of the C++ source (``native/confusion_matrix.cpp``). It is host code:
the reference's Cython kernel, multithreaded, not a TPU kernel. The library
is compiled at first use with ``g++`` (``$CXX`` if set) and the JAX
package's Makefile flags into ``build/torch_native/`` beside the package,
under a name that carries the hash of the source, the compiler, the flags and
the host CPU (``-march=native``), so an edited source or another machine
rebuilds. Concurrent first uses (test workers) each compile to a private
name and ``os.replace`` it into place: a loader sees a whole library or none.

Unlike the JAX binding, a failed build raises, naming the compiler; nothing
falls back to numpy quietly. The numpy bodies are explicit plain twins
(``*_plain``) that the tests hold the library against. The wrappers also
check that every id indexes the matrix (the C++ kernel does not).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "native" / "confusion_matrix.cpp"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-pthread")


def _compiler() -> str:
    return os.environ.get("CXX", "g++")


def _host_cpu() -> str:
    """What ``-march=native`` compiles for: the CPU's model and flags."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return "".join(sorted(set(lines)))
    except OSError:
        return platform.machine() + platform.processor()


def library_path() -> Path:
    """Where the library for the current source, compiler and host lives."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    for part in (_compiler(), " ".join(CXX_FLAGS), _host_cpu()):
        digest.update(part.encode())
    return BUILD_DIR / f"libconfmat_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless a library for it exists; return its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = _compiler()
    if shutil.which(cxx) is None:
        raise RuntimeError(f"{cxx} not found: the native confusion matrix "
                           f"({SOURCE.name}) is built with it at first use")
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed to build {SOURCE.name} ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded library, built on the first call."""
    lib = ctypes.CDLL(str(build()))
    p, u64 = ctypes.c_void_p, ctypes.c_uint64
    lib.confusion_matrix_u8_mt.argtypes = [p, p, u64, ctypes.c_uint32, p, ctypes.c_int32]
    lib.confusion_matrix_u8_mt.restype = None
    lib.validate_labels_u8.argtypes = [p, u64, p]
    lib.validate_labels_u8.restype = ctypes.c_int64
    lib.instance_tp_size_u8.argtypes = [p, p, u64, ctypes.c_int32, ctypes.c_uint8, p, p]
    lib.instance_tp_size_u8.restype = None
    return lib


def native_available() -> bool:
    """Whether the native library builds and loads here (the JAX binding's
    name). It reports a failed build as False instead of raising; every
    other entry point raises it."""
    try:
        library()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False
    return True


def _checked_pair(prediction, ground_truth, conf_matrix):
    """Flat uint8 views and the matrix's dim, with the JAX binding's checks
    and the index bound the C++ kernel relies on."""
    pred = np.ascontiguousarray(prediction, dtype=np.uint8).reshape(-1)
    gt = np.ascontiguousarray(ground_truth, dtype=np.uint8).reshape(-1)
    if pred.size != gt.size:
        raise ValueError(f"size mismatch: pred {pred.size} vs gt {gt.size}")
    if conf_matrix.dtype != np.uint64 or not conf_matrix.flags.c_contiguous:
        raise ValueError("conf_matrix must be C-contiguous uint64")
    dim = conf_matrix.shape[0]
    if conf_matrix.shape != (dim, dim):
        raise ValueError(f"conf_matrix must be square, got {conf_matrix.shape}")
    if gt.size and max(int(gt.max()), int(pred.max())) >= dim:
        raise ValueError(f"an id is >= the matrix dim {dim}: gt max {int(gt.max())}, "
                         f"pred max {int(pred.max())}")
    return pred, gt, dim


def accumulate_confusion(prediction: np.ndarray, ground_truth: np.ndarray,
                         conf_matrix: np.ndarray, *, n_threads: int | None = None) -> np.ndarray:
    """``conf_matrix[gt, pred] += 1`` over all pixels, in place, through the
    native kernel (its threaded variant above 2^20 pixels).

    ``conf_matrix`` must be a C-contiguous uint64 (dim, dim) array;
    prediction/ground_truth are uint8 arrays of identical size, ids < dim."""
    pred, gt, dim = _checked_pair(prediction, ground_truth, conf_matrix)
    library().confusion_matrix_u8_mt(gt.ctypes.data, pred.ctypes.data, gt.size, dim,
                                     conf_matrix.ctypes.data, n_threads or (os.cpu_count() or 1))
    return conf_matrix


def accumulate_confusion_plain(prediction: np.ndarray, ground_truth: np.ndarray,
                               conf_matrix: np.ndarray) -> np.ndarray:
    """``accumulate_confusion``'s numpy twin: a flat bincount of gt*dim+pred."""
    pred, gt, dim = _checked_pair(prediction, ground_truth, conf_matrix)
    counts = np.bincount(gt.astype(np.int64) * dim + pred, minlength=dim * dim)
    conf_matrix += counts.reshape(dim, dim).astype(np.uint64)
    return conf_matrix


def _valid_lut(valid_labels) -> np.ndarray:
    lut = np.zeros(256, dtype=np.uint8)
    lut[np.asarray(list(valid_labels), dtype=np.int64)] = 1
    return lut


def find_invalid_label(ground_truth: np.ndarray, valid_labels) -> int:
    """Index of the first GT pixel with a label outside ``valid_labels``,
    or -1 (the reference's 'Unknown label' check)."""
    gt = np.ascontiguousarray(ground_truth, dtype=np.uint8).reshape(-1)
    lut = _valid_lut(valid_labels)
    return int(library().validate_labels_u8(gt.ctypes.data, gt.size, lut.ctypes.data))


def find_invalid_label_plain(ground_truth: np.ndarray, valid_labels) -> int:
    """``find_invalid_label``'s numpy twin."""
    gt = np.ascontiguousarray(ground_truth, dtype=np.uint8).reshape(-1)
    bad = np.nonzero(~_valid_lut(valid_labels)[gt].astype(bool))[0]
    return int(bad[0]) if bad.size else -1


def _instance_inputs(prediction, instance_map):
    pred = np.ascontiguousarray(prediction, dtype=np.uint8).reshape(-1)
    inst = np.ascontiguousarray(instance_map, dtype=np.int32).reshape(-1)
    if pred.size != inst.size:
        raise ValueError(f"size mismatch: pred {pred.size} vs instances {inst.size}")
    return pred, inst


def instance_tp_size(prediction: np.ndarray, instance_map: np.ndarray,
                     inst_id: int, label_id: int) -> tuple[int, int]:
    """(true positives, instance size) for one instance id — the per-instance
    hot loop of the pixel evaluator's instance-weighted stats."""
    pred, inst = _instance_inputs(prediction, instance_map)
    tp, size = ctypes.c_uint64(), ctypes.c_uint64()
    library().instance_tp_size_u8(pred.ctypes.data, inst.ctypes.data, pred.size, int(inst_id),
                                  int(label_id), ctypes.byref(tp), ctypes.byref(size))
    return tp.value, size.value


def instance_tp_size_plain(prediction: np.ndarray, instance_map: np.ndarray,
                           inst_id: int, label_id: int) -> tuple[int, int]:
    """``instance_tp_size``'s numpy twin."""
    pred, inst = _instance_inputs(prediction, instance_map)
    mask = inst == inst_id
    return int(np.count_nonzero(pred[mask] == label_id)), int(np.count_nonzero(mask))
