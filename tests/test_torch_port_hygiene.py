"""Hygiene of the port package `paddle_tpu_torch`.

It must import without jax and without paddle_tpu (it runs on a GPU box
that has neither), refuse to run quietly on the CPU when no device is
given and no card is present, and build its kernels from the CUDA
sources it names.
"""
import ast
import os
import subprocess
import sys

import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.core import flags as port_flags
from paddle_tpu_torch.jit.api import default_buckets
from paddle_tpu_torch.ops import _cuda_common

PKG = os.path.dirname(paddle_tpu_torch.__file__)
MODULES = sorted(
    "paddle_tpu_torch." + os.path.relpath(os.path.join(root, f), PKG)
    [:-3].replace(os.sep, ".").replace(".__init__", "")
    for root, _, files in os.walk(PKG) for f in files if f.endswith(".py"))


def test_import_pulls_in_neither_jax_nor_paddle_tpu():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib')) or m == 'paddle_tpu' or m.startswith("
            "'paddle_tpu.')]\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    root = os.path.dirname(PKG)
    res = subprocess.run([sys.executable, "-S", "-c", code], cwd=root,
                         env=dict(env, PYTHONPATH=os.pathsep.join(
                             [root] + sys.path)),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]


def test_no_source_imports_jax_or_paddle_tpu():
    offenders = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                for n in names:
                    top = n.split(".")[0]
                    if top in ("jax", "jaxlib", "paddle_tpu"):
                        offenders.append(f"{path}: {n}")
    assert not offenders, offenders


def test_default_device_is_cuda_and_refuses_without_card(monkeypatch):
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.text.models import (LlamaForCausalLM,
                                              llama_tiny_config)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _cuda_common.resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(llama_tiny_config())
    model = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model, max_slots=1)
    assert ServingEngine(model, max_slots=1, device="cpu").device.type \
        == "cpu"


def test_kernel_sources_exist_and_are_the_build_list():
    srcs = {os.path.basename(p) for p in _cuda_common.KERNEL_SOURCES.values()}
    on_disk = {f for f in os.listdir(_cuda_common.CSRC_DIR)
               if f.endswith((".cu", ".cuh"))}
    assert srcs == on_disk == {"flash_attention_fwd.cu", "paged_decode.cu"}
    for name, rel in _cuda_common.KERNEL_SOURCES.items():
        with open(os.path.join(PKG, rel)) as f:
            src = f.read()
        assert f'extern "C" int {name}(' in src
        assert "cudaGetLastError" in src and "Replaces:" in src
    assert "arch=compute_90a,code=sm_90a" in _cuda_common.NVCC_FLAGS
    assert set(_cuda_common.launch_counts()) == set(
        _cuda_common.KERNEL_SOURCES)


def test_flags_and_buckets_match_reference():
    import paddle_tpu  # noqa: F401
    from paddle_tpu.core.flags import flag
    from paddle_tpu.jit.api import default_buckets as ref_buckets

    for name in ("FLAGS_kv_block_size", "FLAGS_serving_slots",
                 "FLAGS_kv_cache_dtype"):
        assert port_flags.flag(name) == flag(name)
    for n in list(range(0, 70)) + [511, 512, 513, 1024, 1500, 4097]:
        assert default_buckets(n) == ref_buckets(n)
    assert _cuda_common.ceil_to(17, 16) == 32
