"""Builds the CUDA sources under ``csrc/`` and binds them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under ``_build/``
(listed in ``.gitignore``) the first time it is needed.  A library's file
name carries a hash of its source, of the headers under ``csrc/`` and of
the compiler flags, so an edited source is rebuilt and a stale library is
never loaded.  Building a plain C interface takes seconds; nothing here
includes PyTorch's headers.

Every C entry point takes its pointers and the CUDA stream as
``void*`` (``ctypes.c_void_p``) and returns ``cudaGetLastError()`` right
after its launch; ``check`` turns a non-zero status into an exception.
An elementwise kernel also takes the elements per access that
``vector_width`` chooses for its tensors.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import torch

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBRARIES: Dict[str, ctypes.CDLL] = {}
_FUNCTIONS: Dict[str, ctypes._CFuncPtr] = {}


def sources() -> List[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    source = CSRC_DIR / f"{name}.cu"
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


# A launch takes packs only where each stream moves at least this many
# bytes: a smaller launch sits at the launch floor, where one element per
# thread keeps more threads in flight to cover the latency.
MIN_PACKED_BYTES = 512 * 1024


def vector_width(length: int, *tensors, elements: int) -> int:
    """Elements per access for a kernel that walks runs of ``length``
    consecutive elements of each tensor, every run starting at a multiple
    of ``length``, in packs of ``elements``: ``elements`` when ``length`` is
    a multiple of it, the first tensor holds at least ``MIN_PACKED_BYTES``
    and every tensor's data is aligned to a pack, else 1.  All the tensors
    share one element size."""
    size = tensors[0].element_size()
    if (length % elements or tensors[0].numel() * size < MIN_PACKED_BYTES
            or any(t.data_ptr() % (elements * size) for t in tensors)):
        return 1
    return elements


def channels_last(*tensors) -> bool:
    """The storage of an elementwise kernel's (N, C, H, W) tensors: True
    where every tensor is channels-last-contiguous (the CUDA kernels' one
    storage; a tensor whose channels or pixels are one is both), False
    where every tensor is contiguous NCHW (which only the plain versions
    take).  Any other strides raise."""
    if all(t.is_contiguous(memory_format=torch.channels_last) for t in tensors):
        return True
    if all(t.is_contiguous() for t in tensors):
        return False
    raise ValueError("the tensors must all be channels-last-contiguous or all contiguous "
                     f"NCHW, got strides {[t.stride() for t in tensors]}")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compiles the named sources (default: all) that are not built yet.

    One ``nvcc`` per source, all started together.  Returns nvcc's output
    (``-Xptxas=-v`` register and spill report) per source it built; raises
    with that output if any compile fails.
    """
    pending = [n for n in (sources() if names is None else names)
               if not library_path(n).exists()]
    if not pending:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs, logs, failures = [], {}, []
    try:
        for name in pending:
            out = library_path(name)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            log_path = BUILD_DIR / f"{name}.{os.getpid()}.log"
            with open(log_path, "w") as log:
                proc = subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
                    stdout=log, stderr=subprocess.STDOUT)
            jobs.append((name, proc, tmp, out, log_path))
        for name, proc, tmp, out, log_path in jobs:
            proc.wait()
            logs[name] = log_path.read_text()
            log_path.unlink()
            if proc.returncode == 0:
                os.replace(tmp, out)
            else:
                tmp.unlink(missing_ok=True)
                failures.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n"
                                f"{logs[name]}")
    finally:
        for _, proc, *_ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failures:
        raise RuntimeError("\n".join(failures))
    return logs


def function(library: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of ``csrc/<library>.cu``, building and
    loading the library on first use, with its argument types declared."""
    key = f"{library}:{symbol}"
    fn = _FUNCTIONS.get(key)
    if fn is None:
        lib = _load(library)
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCTIONS[key] = fn
    return fn


def _load(library: str) -> ctypes.CDLL:
    lib = _LIBRARIES.get(library)
    if lib is None:
        path = library_path(library)
        if not path.exists():
            build([library])
        lib = ctypes.CDLL(str(path))
        lib.pvg_error_string.argtypes = [ctypes.c_int]
        lib.pvg_error_string.restype = ctypes.c_char_p
        _LIBRARIES[library] = lib
    return lib


def check(status: int, library: str, what: str) -> None:
    """Raises if a C entry point returned a non-zero CUDA status."""
    if status != 0:
        message = _load(library).pvg_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({message})")
