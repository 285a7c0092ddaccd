"""ctypes bridge to the native host ops (the port's copy of
detectron_tpu/native/__init__.py; source host_ops.cpp beside this file).

The library is compiled with g++ at the first call (never at import) into
build/detectron_tpu_torch/ at the repository root, under a name that
carries a hash of the source and the flags, as ops/cuda/build.py does for
the CUDA kernels: an edited source rebuilds, an unchanged one is reused.
There is no fallback: a failed build or load raises with g++'s output (the
JAX package logs a warning and runs its numpy code instead).

Each function gives the bits of its numpy twin, the `*_plain` functions of
data/rle.py and utils/boxes.py, which callers use only to check these.
Each counts its calls in its `calls` attribute. bbox_overlaps has no
caller in the port: utils/boxes.bbox_overlaps stays numpy, as the JAX
package's does (its boxes.py does not dispatch to the native copy either);
it is bound so that the copy of host_ops.cpp stays whole and held, by the
tests, against the JAX package's native function and the numpy one.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "host_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "detectron_tpu_torch"
# -ffp-contract=off: no fused multiply-adds, so every operation rounds as
# the numpy twin's does.
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off")

_lock = threading.Lock()
_lib = None


def library_path(build_dir=BUILD_DIR):
    """The library's path: its name carries a hash of the source and the
    flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return Path(build_dir) / "host_ops-{}.so".format(h.hexdigest()[:16])


def build(cxx=None, build_dir=BUILD_DIR):
    """Compile host_ops.cpp with `cxx` (default: g++ on PATH) unless its
    library is in build_dir; returns the library's path. Raises
    RuntimeError naming the compiler, with its output, if it is missing or
    fails."""
    target = library_path(build_dir)
    if target.exists():
        return target
    cxx = cxx or shutil.which("g++") or "g++"
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name("{}.{}.tmp".format(target.name, os.getpid()))
    cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError("building the native host ops needs a C++ "
                           "compiler; {} could not run: {}".format(cxx, e)
                           ) from e
    if proc.returncode != 0:
        raise RuntimeError("{} failed to build {} (exit {}):\n{}{}".format(
            cxx, SOURCE, proc.returncode, proc.stdout, proc.stderr))
    os.replace(tmp, target)
    return target


def _bind(lib):
    f32, f64 = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(
        ctypes.c_double)
    i32, i64 = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int64)
    u8, u32 = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(
        ctypes.c_uint32)
    sigs = {
        "nms_f32": (ctypes.c_int, [f32, i64, ctypes.c_int, ctypes.c_double,
                                   ctypes.c_int, i32]),
        "nms_f64": (ctypes.c_int, [f64, i64, ctypes.c_int, ctypes.c_double,
                                   ctypes.c_int, i32]),
        "bbox_overlaps": (None, [f64, ctypes.c_int, f64, ctypes.c_int, f64]),
        "rle_decode": (ctypes.c_int, [u32, ctypes.c_int, u8,
                                      ctypes.c_int64]),
        "rle_encode": (ctypes.c_int, [u8, ctypes.c_int64, u32]),
        "poly_to_counts": (ctypes.c_int, [f64, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, u32]),
        "rle_intersection": (ctypes.c_int64, [u32, ctypes.c_int, u32,
                                              ctypes.c_int]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def lib():
    """The loaded library, built at the first call. Raises if the build or
    the load fails."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
    return _lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _counted(fn):
    """Give fn a `calls` count, raised by one at each call (under a lock:
    the engine's post pool calls from several threads)."""
    count_lock = threading.Lock()

    def wrapper(*args):
        with count_lock:
            wrapper.calls += 1
        return fn(*args)

    wrapper.calls = 0
    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


@_counted
def nms(dets, thresh):
    """Greedy NMS; the bits of utils/boxes.nms_plain. dets: (N, 5)
    float32 or float64 [x1, y1, x2, y2, score]. Returns the kept indices
    in descending-score order."""
    dets = np.asarray(dets)
    if dets.dtype not in (np.float32, np.float64):
        raise TypeError("nms takes float32 or float64 dets, not "
                        + str(dets.dtype))
    n = dets.shape[0]
    if n == 0:
        return []
    dets = np.ascontiguousarray(dets)
    # The twin's visiting order and the type its `ovr > thresh` compares
    # in: float32 against a Python float, float64 against a numpy float64.
    order = np.ascontiguousarray(dets[:, 4].argsort()[::-1], np.int64)
    single = np.result_type(dets.dtype, thresh) == np.float32
    keep = np.empty(n, np.int32)
    if dets.dtype == np.float32:
        n_keep = lib().nms_f32(_ptr(dets, ctypes.c_float),
                               _ptr(order, ctypes.c_int64), n,
                               float(thresh), int(single),
                               _ptr(keep, ctypes.c_int))
    else:
        n_keep = lib().nms_f64(_ptr(dets, ctypes.c_double),
                               _ptr(order, ctypes.c_int64), n,
                               float(thresh), int(single),
                               _ptr(keep, ctypes.c_int))
    return keep[:n_keep].tolist()


@_counted
def bbox_overlaps(boxes, query):
    """Pairwise IoU (N, K), +1 edge convention; the bits of
    utils/boxes.bbox_overlaps."""
    boxes = np.ascontiguousarray(boxes, np.float64)
    query = np.ascontiguousarray(query, np.float64)
    out = np.zeros((boxes.shape[0], query.shape[0]), np.float64)
    if out.size:
        lib().bbox_overlaps(_ptr(boxes, ctypes.c_double), boxes.shape[0],
                            _ptr(query, ctypes.c_double), query.shape[0],
                            _ptr(out, ctypes.c_double))
    return out


@_counted
def rle_decode(counts, h, w):
    """Run-length counts -> (h, w) uint8 mask (column-major runs)."""
    counts = np.ascontiguousarray(counts, np.uint32)
    mask = np.empty(h * w, np.uint8)
    rc = lib().rle_decode(_ptr(counts, ctypes.c_uint32), len(counts),
                          _ptr(mask, ctypes.c_uint8), h * w)
    if rc != 0:
        raise ValueError("RLE does not match shape ({}, {})".format(h, w))
    return mask.reshape((h, w), order="F")


@_counted
def rle_encode(mask):
    """(H, W) mask, any nonzero value 1 -> run-length counts."""
    h, w = mask.shape
    # Column-major bytes; the C++ takes any nonzero byte as 1, so a uint8
    # or bool mask goes as it is and any other type as mask != 0.
    mask = np.asfortranarray(mask)
    if mask.dtype not in (np.uint8, np.bool_):
        mask = np.asfortranarray(mask != 0)
    flat = mask.reshape(-1, order="F").view(np.uint8)
    counts = np.empty(h * w + 1, np.uint32)
    m = lib().rle_encode(_ptr(flat, ctypes.c_uint8), h * w,
                         _ptr(counts, ctypes.c_uint32))
    return counts[:m].tolist()


@_counted
def poly_to_counts(xy, h, w):
    """One polygon [x0, y0, x1, y1, ...] -> RLE counts over (h, w)."""
    xy = np.ascontiguousarray(xy, np.float64)
    counts = np.empty(h * w + 2, np.uint32)
    m = lib().poly_to_counts(_ptr(xy, ctypes.c_double), len(xy) // 2, h, w,
                             _ptr(counts, ctypes.c_uint32))
    return counts[:m].tolist()


@_counted
def rle_intersection(counts_a, counts_b):
    """Pixels set in both of two RLEs' counts, without decoding."""
    a = np.ascontiguousarray(counts_a, np.uint32)
    b = np.ascontiguousarray(counts_b, np.uint32)
    return int(lib().rle_intersection(_ptr(a, ctypes.c_uint32), len(a),
                                      _ptr(b, ctypes.c_uint32), len(b)))
