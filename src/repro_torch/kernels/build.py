"""Build and load the hand-written CUDA kernels (``repro_torch/csrc``).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with a
plain C interface and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/lib<name>_<hash>.so csrc/<name>.cu

The library name carries a hash of the source and the flags, so an edited
source is never served by a stale build.  Builds happen at first use (never
at import: the CPU test host has no ``nvcc``); :func:`build` compiles several
sources in parallel, one ``nvcc`` process each.

Every C entry point takes device pointers (``tensor.data_ptr()``), ``int``
sizes and the CUDA stream (``torch.cuda.current_stream().cuda_stream``),
launches on that stream without synchronising, and returns
``cudaGetLastError()``; :func:`check` raises on a non-zero code.

``launch_counts`` holds one integer per kernel wrapper, incremented where
the wrapper launches its kernel and nowhere else, so a run can prove that
its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: launches per kernel wrapper (see module docstring)
launch_counts: Dict[str, int] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def count_launch(name: str):
    launch_counts[name] = launch_counts.get(name, 0) + 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the repro_torch CUDA "
        "kernels are compiled at first use on a host with the CUDA toolkit")


def lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that has no current build, all ``nvcc``
    processes started together.  Returns {name: ptxas report} for the ones
    built here; raises RuntimeError naming the first source that failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + failed[0])
    return reports


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; ``signatures`` maps
    each C function to its ctypes argtypes (restype is ``c_int``)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str):
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors, dtypes=None):
    """Validate the tensors a kernel wrapper passes by pointer: all on one
    CUDA device, contiguous, and (when given) of the expected dtypes."""
    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if t.device != dev:
            raise ValueError(f"{name}: argument {i} on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} is not contiguous")
        if dtypes is not None and t.dtype != dtypes[i]:
            raise TypeError(f"{name}: argument {i} has dtype {t.dtype}, "
                            f"expected {dtypes[i]}")
