"""Build the CUDA kernels from csrc/ with nvcc and load them with ctypes.

Each source compiles on its own into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), under
build/detectron_tpu_torch/ at the repository root. A library's file name
carries a hash of its source, the headers in csrc/ and the flags, so an
edited source or header rebuilds and an unchanged one is reused.
build_all() starts one nvcc per missing library, all at once, and waits
for them. Nothing is built when a module is imported: the first launch
builds.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "detectron_tpu_torch"
SOURCES = ("nms_keep_mask.cu", "roi_window_pool.cu", "roi_window_accum.cu",
           "roi_window_accum_det.cu", "stem_pool.cu", "fused_res2.cu",
           "channel_epilogue.cu")
# No --use_fast_math: an approximate divide would flip NMS keep bits at
# the IoU threshold. -Xptxas -v reports each kernel's registers, shared
# memory and spills (kept in LOGS).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded = {}
# nvcc's output for each source built by this process.
LOGS = {}


def nvcc_path():
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("building the CUDA kernels needs nvcc (the CUDA "
                       "toolkit); none found on PATH or in /usr/local/cuda")


def library_path(source):
    """The library of `source`: its name carries a hash of the source, of
    every header in CSRC (a source may include any of them) and of the
    flags."""
    src = CSRC / source
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / "{}-{}.so".format(src.stem, h.hexdigest()[:16])


def build_all():
    """Compile every source whose library is missing, in parallel. Returns
    {source: library path}; raises with nvcc's output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for source in SOURCES:
        target = library_path(source)
        if target.exists():
            continue
        tmp = target.with_name("{}.{}.tmp".format(target.name, os.getpid()))
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        jobs.append((source, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for source, target, tmp, proc in jobs:
        out, _ = proc.communicate()
        LOGS[source] = out
        if proc.returncode != 0:
            errors.append("{}:\n{}".format(source, out))
        else:
            os.replace(tmp, target)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return {source: library_path(source) for source in SOURCES}


def load(source, symbol, argtypes):
    """The C function `symbol` of `source`'s library (built on first use),
    with its argtypes set and an int return (cudaGetLastError())."""
    with _lock:
        fn = _loaded.get((source, symbol))
        if fn is None:
            lib = ctypes.CDLL(str(build_all()[source]))
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[(source, symbol)] = fn
    return fn


def sass_counts(source, kernel, opcodes):
    """How often each of `opcodes` occurs in the SASS of the functions of
    `source`'s library (built on first use) whose mangled name holds
    `kernel`, from the toolkit's cuobjdump: {opcode: count}."""
    tool = Path(nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(build_all()[source])],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    bodies = [f for f in text.split("Function : ")[1:]
              if kernel in f.split("\n", 1)[0]]
    if not bodies:
        raise RuntimeError("no function {} in the SASS of {}".format(
            kernel, source))
    return {op: sum(f.count(op) for f in bodies) for op in opcodes}


def check(err, name):
    if err != 0:
        raise RuntimeError("{} launch failed: CUDA error {}".format(name, err))
