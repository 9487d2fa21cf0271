"""Helpers shared by the kernel packages: device dispatch, input checks,
the lane-group choice of the CSR pull kernels, and the build and load of
the hand-written CUDA kernels.

Device dispatch takes the place of the JAX package's ``auto_interpret``: a
wrapper given CUDA tensors launches its kernel (or raises), a wrapper given
CPU tensors runs its plain PyTorch version.  There is no fallback from one to
the other.

Each kernel is one CUDA C++ source ``csrc/<name>.cu`` (which may include
the ``csrc/*.cuh`` headers) with a plain C entry ``<name>_launch`` that
returns ``cudaGetLastError()`` (the dense min-plus kernels have one entry
an element type: ``<name>_launch``, ``<name>_bf16_launch`` and
``<name>_f16_launch``).  It is compiled with ``nvcc`` for
``sm_90a`` into ``build/kernels/`` at the repository root, on first use,
under a name keyed by a hash of the sources and the flags, and loaded with
``ctypes``.  Nothing is compiled at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


INT32_MAX = 2**31 - 1
#: element types of the dense min-plus kernels, labels and matrix alike
DENSE_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device (launch the kernel),
    False when every tensor lies on the CPU (run the plain version)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device type {dev.type!r}")
    if dev.index != torch.cuda.current_device():
        # the C entries launch on the calling thread's current device
        raise ValueError(f"tensors on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return True


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          shape: tuple) -> None:
    """Raise unless ``t`` has this dtype and shape and is contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_dense(labels: torch.Tensor, name: str, shape: tuple,
                adj: torch.Tensor) -> None:
    """Raise unless ``labels`` has this shape, ``adj`` is (n, n) with n
    the last dimension of ``shape``, both are contiguous and both have one
    dtype of ``DENSE_DTYPES``, the same one (every dense engine takes its
    labels' dtype from the matrix, so no caller mixes them)."""
    if labels.dtype not in DENSE_DTYPES:
        raise TypeError(f"{name} must be one of {DENSE_DTYPES}, "
                        f"got {labels.dtype}")
    check(labels, name, labels.dtype, shape)
    check(adj, "adj", labels.dtype, (shape[-1], shape[-1]))


def check_csr(dist: torch.Tensor, indptr: torch.Tensor,
              indices: torch.Tensor, weights: torch.Tensor, *,
              row_base: int | None = None) -> None:
    """Raise unless ``(indptr, indices, weights)`` is an int32 / int32 /
    float32 CSR whose arc count fits in int32 (the CUDA pull kernels index
    arcs with 32 bits), with one row a label of ``dist`` or, given
    ``row_base``, one row a label of the block ``dist[row_base:row_base +
    rows]``."""
    n, m = indptr.shape[0] - 1, indices.shape[0]
    check(dist, "dist", torch.float32,
          (n if row_base is None else dist.shape[0],))
    if row_base is not None and not 0 <= row_base <= dist.shape[0] - n:
        raise ValueError(f"rows [{row_base}, {row_base + n}) are not labels "
                         f"of dist ({dist.shape[0]},)")
    check(indptr, "indptr", torch.int32, (n + 1,))
    check(indices, "indices", torch.int32, (m,))
    check(weights, "weights", torch.float32, (m,))
    if m > INT32_MAX:
        raise ValueError(f"{m} arcs do not fit in int32 offsets")


def lane_group(n: int, m: int) -> int:
    """Lanes a row for the CSR pull kernels: the largest power of two
    below the mean degree ``m / n`` (1 where the mean is at most 1), at
    most a warp (32)."""
    g = 1
    while g < 32 and 2 * g * n < m:
        g *= 2
    return g


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc (PATH or /usr/local/cuda)")
    return path


def library_path(name: str) -> Path:
    """Where the shared library of ``csrc/<name>.cu`` is built, keyed by a
    hash of the source, the headers beside it and the compiler flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names) -> None:
    """Compile every kernel in ``names`` whose library is missing, one
    ``nvcc`` for each source, all started together; raise with the
    compiler's output if any fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode == 0:
            os.replace(tmp, out)          # atomic: concurrent builds agree
        else:
            failed.append(f"{name}:\n{log}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def c_entry(lib: ctypes.CDLL, entry: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry ``<entry>_launch`` of a loaded library, with its
    ``ctypes`` signature and an ``int`` (cudaError) result."""
    fn = getattr(lib, f"{entry}_launch")
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def launcher(name: str, argtypes: tuple, entry: str | None = None):
    """The C entry ``<entry>_launch`` (``entry`` defaults to ``name``) of
    kernel ``name``, built if needed, with its ``ctypes`` signature
    (pointers and the stream as ``c_void_p``)."""
    build([name])
    return c_entry(ctypes.CDLL(str(library_path(name))), entry or name,
                   argtypes)


def build_variant(source: Path, tag: str, defines=()) -> ctypes.CDLL:
    """``source`` (a kernel of another tree, a build of this tree's with
    ``-D<define>`` for each of ``defines``, or a tool's probe) compiled
    with the port's flags into ``build/kernels/<stem>-<tag>.so`` and
    loaded; raise with the compiler's output if it fails.  For the
    measurement tools: the port's own kernels go through :func:`build`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"{source.stem}-{tag}.so"
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines),
                        "-o", str(out), str(source)],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source} ({tag}):\n{r.stdout}")
    return ctypes.CDLL(str(out))


def stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as the kernels take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on_error(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
