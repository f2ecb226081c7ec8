"""Shared plumbing for the hand-written CUDA kernels of the port.

One copy of the rules every kernel wrapper follows, so the kernels cannot
drift apart:

  * `resolve_device`: entry points default to ``"cuda"`` and refuse to run
    quietly on the CPU when no card is present.
  * `kernel_library`: builds each ``csrc/*.cu`` source with ``nvcc`` for
    ``sm_90a`` into a shared library with a plain C interface, at first
    use, keyed on a hash of the sources, and loads it with ``ctypes``. The
    sources build in parallel (one ``nvcc`` per source, all started
    together); kernels that share a source share its library. Nothing is
    built or imported when a module is imported.
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
import re
import shutil
import subprocess
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

#: kernel name -> CUDA source (relative to the package). The build list:
#: every kernel of the port is built from exactly these files. Each name
#: is the C entry point of its source and has its own launch counter; the
#: paged-decode variants over model-dtype, int8 and int4 caches each have
#: a source of their own over one kernel template (csrc/paged_decode.cuh,
#: the cache format a parameter), so the three build in parallel; the
#: flash-attention forward and its varlen form share one source, and so
#: do the backward kernels (dQ; dK and dV; each with its varlen form), the
#: three FlashMask kernels and the fused norm (RMS and LayerNorm kinds),
#: rotary, SwiGLU and dropout + add kernels. The flash forward, backward
#: and FlashMask sources share their tile bodies through
#: csrc/flash_attention_tc.cuh and csrc/flash_attention_tiles.cuh; every
#: header under csrc/ is part of each source's build hash.
KERNEL_SOURCES = {
    "flash_attention_fwd": "csrc/flash_attention_fwd.cu",
    "flash_attention_bwd_dq": "csrc/flash_attention_bwd.cu",
    "flash_attention_bwd_dkv": "csrc/flash_attention_bwd.cu",
    "flash_attention_varlen_fwd": "csrc/flash_attention_fwd.cu",
    "flash_attention_varlen_bwd_dq": "csrc/flash_attention_bwd.cu",
    "flash_attention_varlen_bwd_dkv": "csrc/flash_attention_bwd.cu",
    "flashmask_fwd": "csrc/flashmask_attention.cu",
    "flashmask_bwd_dq": "csrc/flashmask_attention.cu",
    "flashmask_bwd_dkv": "csrc/flashmask_attention.cu",
    "paged_decode_attention": "csrc/paged_decode.cu",
    "paged_decode_attention_int8": "csrc/paged_decode_int8.cu",
    "paged_decode_attention_int4": "csrc/paged_decode_int4.cu",
    "quant_matmul": "csrc/quant_matmul.cu",
    "fused_rms_norm_fwd": "csrc/fused_norm.cu",
    "fused_rms_norm_bwd": "csrc/fused_norm.cu",
    "rope_qk": "csrc/fused_norm.cu",
    "swiglu_fwd": "csrc/fused_norm.cu",
    "swiglu_bwd": "csrc/fused_norm.cu",
    "fused_layer_norm_fwd": "csrc/fused_norm.cu",
    "fused_layer_norm_bwd": "csrc/fused_norm.cu",
    "dropout_add_fwd": "csrc/fused_norm.cu",
    "dropout_add_bwd": "csrc/fused_norm.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    """Hash of the flags, the source and every header under csrc/ (a
    header edit rebuilds the sources that may include it)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC_DIR, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _lib_path(rel_src: str) -> str:
    src = os.path.join(_PKG_DIR, rel_src)
    stem = os.path.splitext(os.path.basename(rel_src))[0]
    return os.path.join(BUILD_DIR, f"{stem}-{_source_hash(src)}.so")


def build_kernels(names=None) -> dict:
    """Compile the source of every named kernel that has no up-to-date
    library, one ``nvcc`` process per source, all started together.
    Returns {name: library path}. Raises with the compiler's output on
    failure."""
    names = list(KERNEL_SOURCES if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for rel in sorted({KERNEL_SOURCES[n] for n in names}):
        out = _lib_path(rel)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(_PKG_DIR, rel)]
        procs[rel] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT), tmp, out)
    failed = []
    for rel, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{rel}: nvcc exit {proc.returncode}\n"
                          f"{log.decode(errors='replace')}")
            continue
        with open(f"{out}.log", "wb") as f:   # ptxas's -v report
            f.write(log)
        os.replace(tmp, out)   # atomic: a concurrent build sees all or none
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {n: _lib_path(KERNEL_SOURCES[n]) for n in names}


def ptxas_usage(rel_src: str) -> dict:
    """{mangled kernel name: {"registers", "stack", "spill_stores",
    "spill_loads"}} from the ``-Xptxas -v`` report of the source's build
    (kept beside its library)."""
    with open(f"{_lib_path(rel_src)}.log") as f:
        log = f.read()
    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            usage[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            usage[name].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[name]["registers"] = int(m.group(1))
    return usage


def kernel_library(name: str) -> ctypes.CDLL:
    """The loaded shared library holding kernel `name`, built at first
    use (one library per source)."""
    rel = KERNEL_SOURCES[name]
    lib = _LIBS.get(rel)
    if lib is None:
        with _BUILD_LOCK:
            lib = _LIBS.get(rel)
            if lib is None:
                lib = ctypes.CDLL(build_kernels([name])[name])
                _LIBS[rel] = lib
    return lib


def check_launch(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


def current_stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
