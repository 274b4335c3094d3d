"""Build the CUDA kernels from `repro_torch/csrc/` and load them.

Each `csrc/*.cu` file has a plain C interface and becomes a shared library
of its own, compiled by `nvcc` for `sm_90a` at first CUDA use and loaded
with ctypes. All sources compile at once, one `nvcc` process each. A
library's file name carries a hash of its source, the shared `csrc/*.cuh`
headers and the flags, so an edited source or header rebuilds; the
libraries live in `build/repro_torch_kernels/` at the root of the
checkout.

Nothing here runs at import: the CPU path never builds anything.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# Libraries whose entry points have their argtypes declared (`load`).
_BOUND: Dict[str, ctypes.CDLL] = {}


class NvccError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise NvccError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(src: Path) -> Path:
    # Every source may include the shared headers, so they enter each hash.
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"


def build_all(verbose: bool = False) -> Dict[str, ctypes.CDLL]:
    """Compile every source that has no up-to-date library, in parallel,
    and load all of them. Returns {source stem: library}."""
    with _LOCK:
        sources = sorted(CSRC.glob("*.cu"))
        todo = [s for s in sources if s.stem not in _LIBS]
        procs = []
        for src in todo:
            out = _lib_path(src)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS]
            if verbose:
                cmd.append("-Xptxas=-v")
            cmd += ["-o", str(tmp), str(src)]
            procs.append((src, tmp, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failures = []
        for src, tmp, out, proc in procs:
            log, _ = proc.communicate()
            if verbose and log:
                print(f"[nvcc {src.name}]\n{log}", flush=True)
            if proc.returncode != 0:
                failures.append(f"{src.name}:\n{log}")
            else:
                os.replace(tmp, out)
        if failures:
            raise NvccError("nvcc failed:\n" + "\n".join(failures))
        for src in todo:
            _LIBS[src.stem] = ctypes.CDLL(str(_lib_path(src)))
        return dict(_LIBS)


def check_arg(t, name: str, dtype, ndim: int, device=None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of the given dtype and
    rank (and on `device`, when given): what every kernel wrapper takes."""
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-d {dtype}, got "
                         f"{t.dim()}-d {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def check_status(status: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")


def stream_ptr(t) -> int:
    """The raw handle of the current CUDA stream of `t`'s device, looked up
    on every launch (never cached: graph capture and `torch.cuda.stream`
    make another stream current)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The library built from `csrc/<name>.cu`, with argtypes declared and
    an int (cudaError_t) result for every entry point in `signatures`. The
    entry points are declared at the first call; later calls return the
    same library at the cost of a dict lookup, so each library has one
    signature table."""
    lib = _BOUND.get(name)
    if lib is not None:
        return lib
    lib = _LIBS.get(name) or build_all()[name]
    for fn, argtypes in signatures.items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    _BOUND[name] = lib
    return lib
