"""Build and load the port's CUDA kernels (one shared library, ctypes).

Every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc``
process, all started together, and the objects are linked into one
``.so`` under ``<repo>/build/kernels/``, named by a digest of the sources
and flags so an edited source never loads a stale library.  The sources
expose a plain C interface (pointers, ints and the CUDA stream), so no
PyTorch header is compiled.  The build runs at the first launch, never
at import, and ``--use_fast_math`` is deliberately absent: the kernels
rely on IEEE division and square root.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the port's CUDA kernels need "
                           "the CUDA toolkit (set CUDA_HOME or PATH)")
    return str(path)


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libreprotorch_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the sources (in parallel) into the shared library."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, obj, proc in procs:
            log, _ = proc.communicate()
            if verbose and log:
                print(log, end="")
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        lib_tmp = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(lib_tmp),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(lib_tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' shared library."""
    return ctypes.CDLL(str(build()))


def timed_build(verbose: bool = False) -> float:
    """Build and load; returns the wall seconds it took."""
    t0 = time.perf_counter()
    build(verbose=verbose)
    load_library()
    return time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def c_function(name: str, argtypes: tuple):
    """The library's C entry ``name`` with its argument types set; every
    entry returns the launch's ``cudaGetLastError()`` as an int."""
    fn = getattr(load_library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_launch(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def check_tensor(x: torch.Tensor, what: str, *, dtype, shape, device):
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape``
    on ``device`` — the kernels take nothing else."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{what}: expected a tensor, got {type(x)}")
    if x.device != device:
        raise ValueError(f"{what}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{what}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


PTR = ctypes.c_void_p      # device pointers and the stream
INT = ctypes.c_int
I64 = ctypes.c_longlong


def empty_launch(device: torch.device, blocks: int = 1,
                 threads: int = 32):
    """Launch the library's empty kernel (``csrc/empty.cu``: ``blocks``
    blocks of ``threads`` threads that do nothing) on the current stream:
    timed, it is what a launch alone costs the card.  Not one of the
    ported kernels, and counted nowhere."""
    if device.type != "cuda":
        raise ValueError(f"empty_launch: needs a CUDA device, not {device}")
    fn = c_function("empty_launch", (INT, INT, PTR))
    with torch.cuda.device(device):
        rc = fn(blocks, threads, stream_ptr(device))
    check_launch(rc, "empty")
