"""Shared plumbing for the hand-written CUDA kernels of the port.

One copy of the rules every kernel wrapper follows, so the kernels cannot
drift apart:

  * `resolve_device`: entry points default to ``"cuda"`` and refuse to run
    quietly on the CPU when no card is present.
  * `kernel_library`: builds each ``csrc/*.cu`` source with ``nvcc`` for
    ``sm_90a`` into a shared library with a plain C interface, at first
    use, keyed on a hash of the sources, and loads it with ``ctypes``. The
    sources build in parallel (one ``nvcc`` per source, all started
    together). Nothing is built or imported when a module is imported.
  * `check_launch`: every C entry point returns ``cudaGetLastError()``;
    a non-zero code raises.
  * launch counters: each wrapper adds one to its counter where it launches
    its kernel and nowhere else, so a run can show that its main path went
    through the kernels (`reset_launch_counts` / `launch_counts`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

#: kernel name -> CUDA source (relative to the package). The build list:
#: every kernel of the port is built from exactly these files.
KERNEL_SOURCES = {
    "flash_attention_fwd": "csrc/flash_attention_fwd.cu",
    "paged_decode_attention": "csrc/paged_decode.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LAUNCHES = {name: 0 for name in KERNEL_SOURCES}
_LIBS: dict = {}
_BUILD_LOCK = threading.Lock()


def ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller
    asks for another. A CUDA device with no card present raises — the
    port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


# ------------------------------------------------------------ counters

def count_launch(name: str) -> None:
    _LAUNCHES[name] += 1


def launch_counts() -> dict:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


# --------------------------------------------------------------- build

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME or "
                           "/usr/local/cuda/bin); the CUDA kernels cannot "
                           "be built")
    return path


def _source_hash(src: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> str:
    src = os.path.join(_PKG_DIR, KERNEL_SOURCES[name])
    return os.path.join(BUILD_DIR, f"{name}-{_source_hash(src)}.so")


def build_kernels(names=None) -> dict:
    """Compile every named kernel source that has no up-to-date library,
    one ``nvcc`` process per source, all started together. Returns
    {name: library path}. Raises with the compiler's output on failure."""
    names = list(KERNEL_SOURCES if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    paths = {}
    for name in names:
        out = _lib_path(name)
        paths[name] = out
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        src = os.path.join(_PKG_DIR, KERNEL_SOURCES[name])
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n"
                          f"{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)   # atomic: a concurrent build sees all or none
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def kernel_library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel `name`, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        with _BUILD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                path = build_kernels([name])[name]
                lib = ctypes.CDLL(path)
                _LIBS[name] = lib
    return lib


def check_launch(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


def current_stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
