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


def test_module_list_covers_every_subpackage():
    """The import checks walk the whole package, the recompute wrapper's
    `distributed/` included."""
    for mod in ("paddle_tpu_torch.distributed",
                "paddle_tpu_torch.distributed.fleet",
                "paddle_tpu_torch.distributed.fleet.utils",
                "paddle_tpu_torch.incubate.nn.functional.fused_loss",
                "paddle_tpu_torch.amp", "paddle_tpu_torch.jit",
                "paddle_tpu_torch.jit.api", "paddle_tpu_torch.core.graphs",
                "paddle_tpu_torch.core.tensor", "paddle_tpu_torch.autograd",
                "paddle_tpu_torch.ops.op_table", "paddle_tpu_torch.linalg",
                "paddle_tpu_torch.nn.layer_base",
                "paddle_tpu_torch.nn.initializer",
                "paddle_tpu_torch.nn.utils",
                "paddle_tpu_torch.nn.functional.attention",
                "paddle_tpu_torch.nn.layer.transformer",
                "paddle_tpu_torch.nn.layer.rnn",
                "paddle_tpu_torch.nn.layer.extended",
                "paddle_tpu_torch.framework_io",
                "paddle_tpu_torch.text.models._layers",
                "paddle_tpu_torch.fft", "paddle_tpu_torch.signal",
                "paddle_tpu_torch.geometric", "paddle_tpu_torch.text.viterbi",
                "paddle_tpu_torch.incubate",
                "paddle_tpu_torch.incubate.autograd",
                "paddle_tpu_torch.incubate.distributed"):
        assert mod in MODULES, mod


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
    from paddle_tpu_torch.text.models import (
        BertConfig, BertForSequenceClassification, BertModel, GPTConfig,
        GPTForCausalLM, LlamaForCausalLM, bert_from_numpy, gpt_from_numpy,
        llama_tiny_config)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _cuda_common.resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(llama_tiny_config())
    gpt = GPTConfig(vocab_size=64, hidden_size=32, num_hidden_layers=1,
                    num_attention_heads=2, max_position_embeddings=16)
    bert = BertConfig(vocab_size=64, hidden_size=32, num_hidden_layers=1,
                      num_attention_heads=2, intermediate_size=64,
                      max_position_embeddings=16)
    for build in (lambda: GPTForCausalLM(gpt), lambda: BertModel(bert),
                  lambda: BertForSequenceClassification(bert),
                  lambda: gpt_from_numpy(gpt, {}),
                  lambda: bert_from_numpy(bert, {})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    assert GPTForCausalLM(gpt, device="cpu").device.type == "cpu"
    assert BertForSequenceClassification(bert, device="cpu").device.type \
        == "cpu"
    with pytest.raises(NotImplementedError, match="item 10, 'GPT serving'"):
        ServingEngine(GPTForCausalLM(gpt, device="cpu"), max_slots=1,
                      device="cpu")
    model = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model, max_slots=1)
    assert ServingEngine(model, max_slots=1, device="cpu").device.type \
        == "cpu"


def test_layers_default_to_cuda_and_refuse_without_card(monkeypatch,
                                                        tmp_path):
    """nn: making a Layer (its parameters go to the Tensor API's current
    device), `Layer.to("cuda")` and `load` onto the current device raise
    RuntimeError with no card unless the caller chose the CPU."""
    import numpy as np

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.core import device as port_device

    prev = port_device._current
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        port_device._current = None
        for build in (lambda: nn.Linear(2, 2), lambda: nn.LayerNorm(4),
                      lambda: nn.Sequential(nn.Conv2D(1, 2, 3)),
                      lambda: nn.TransformerEncoderLayer(8, 2, 16),
                      lambda: nn.LSTM(2, 3)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                build()
        pt.set_device("cpu")
        layer = nn.Linear(2, 2)
        assert layer.weight.place.is_cpu_place()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            layer.to("cuda")
        assert layer.to("cpu").weight.place.is_cpu_place()
        path = str(tmp_path / "w.pd")
        pt.save(layer.state_dict(), path)
        port_device._current = None
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt.load(path)
        assert np.asarray(pt.load(path, return_numpy=True)["weight"]).shape \
            == (2, 2)
    finally:
        port_device._current = prev


def test_grad_scaler_defaults_to_cuda_and_refuses_without_card(monkeypatch):
    """GradScaler keeps its scale on `device`, "cuda" unless the caller
    asks for another; to_static has no device of its own."""
    from paddle_tpu_torch import amp, jit

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        amp.GradScaler()
    assert amp.GradScaler(device="cpu").get_loss_scaling().device.type \
        == "cpu"
    sf = jit.to_static(lambda x: x * 2)
    for _ in range(3):
        assert sf(torch.ones(2)).device.type == "cpu"


def test_kernel_sources_exist_and_are_the_build_list():
    srcs = {os.path.basename(p) for p in _cuda_common.KERNEL_SOURCES.values()}
    on_disk = {f for f in os.listdir(_cuda_common.CSRC_DIR)
               if f.endswith(".cu")}
    assert srcs == on_disk == {"flash_attention_fwd.cu",
                               "flash_attention_bwd.cu", "paged_decode.cu",
                               "paged_decode_int8.cu", "paged_decode_int4.cu",
                               "quant_matmul.cu", "fused_norm.cu",
                               "flashmask_attention.cu",
                               "fused_optimizer.cu"}
    # the headers, part of every source's hash: the CUDA-core flash tile
    # bodies, the tensor-core ones (which include them), the Hopper
    # plumbing the tensor-core kernels share, and the paged decode
    # template its three sources instantiate
    headers = {f for f in os.listdir(_cuda_common.CSRC_DIR)
               if f.endswith(".cuh")}
    assert headers == {"flash_attention_tiles.cuh", "flash_attention_tc.cuh",
                       "hopper_common.cuh", "paged_decode.cuh"}
    with open(os.path.join(_cuda_common.CSRC_DIR,
                           "flash_attention_tc.cuh")) as f:
        tc = f.read()
    assert '#include "flash_attention_tiles.cuh"' in tc
    assert '#include "hopper_common.cuh"' in tc
    for rel, header in (
            ("csrc/quant_matmul.cu", "hopper_common.cuh"),
            ("csrc/flash_attention_fwd.cu", "flash_attention_tc.cuh"),
            ("csrc/flash_attention_bwd.cu", "flash_attention_tc.cuh"),
            ("csrc/flashmask_attention.cu", "flash_attention_tc.cuh"),
            ("csrc/paged_decode.cu", "paged_decode.cuh"),
            ("csrc/paged_decode_int8.cu", "paged_decode.cuh"),
            ("csrc/paged_decode_int4.cu", "paged_decode.cuh")):
        with open(os.path.join(PKG, rel)) as f:
            assert f'#include "{header}"' in f.read()
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
                 "FLAGS_kv_cache_dtype", "FLAGS_weight_only_dtype",
                 "FLAGS_prefix_cache", "FLAGS_chunked_prefill_tokens",
                 "FLAGS_prefix_cache_max_blocks"):
        assert port_flags.flag(name) == flag(name)
    for n in list(range(0, 70)) + [511, 512, 513, 1024, 1500, 4097]:
        assert default_buckets(n) == ref_buckets(n)
    assert _cuda_common.ceil_to(17, 16) == 32


def test_fused_ops_flag_diverges_from_reference_until_ported():
    """FLAGS_pallas_fused_ops equals the reference's default (True) now
    that K3-K5 are ported; set_flags writes known flags only, and bool
    flags parse from the environment as in the reference."""
    import paddle_tpu  # noqa: F401
    from paddle_tpu.core.flags import _parse as ref_parse
    from paddle_tpu.core.flags import flag

    assert flag("FLAGS_pallas_fused_ops") is True
    assert port_flags.flag("FLAGS_pallas_fused_ops") is True
    for text in ("1", "true", "False", "off", "yes"):
        assert port_flags._parse(text, False) == ref_parse(text, False)
    port_flags.set_flags({"pallas_fused_ops": False})
    try:
        assert port_flags.flag("FLAGS_pallas_fused_ops") is False
    finally:
        port_flags.set_flags({"FLAGS_pallas_fused_ops": True})
    with pytest.raises(KeyError):
        port_flags.set_flags({"FLAGS_no_such_flag": 1})


def test_build_hash_covers_the_headers(tmp_path, monkeypatch):
    """A source's library is keyed on the source and every csrc/*.cuh it
    may include: editing the shared tile header rebuilds the flash and
    FlashMask sources."""
    src = tmp_path / "k.cu"
    src.write_text('#include "t.cuh"\n')
    hdr = tmp_path / "t.cuh"
    hdr.write_text("// v1\n")
    monkeypatch.setattr(_cuda_common, "CSRC_DIR", str(tmp_path))
    before = _cuda_common._source_hash(str(src))
    assert _cuda_common._source_hash(str(src)) == before
    hdr.write_text("// v2\n")
    assert _cuda_common._source_hash(str(src)) != before


def test_ptxas_usage_reads_the_build_report(tmp_path, monkeypatch):
    """chip_smoke's PTXAS line: each kernel's registers, stack and spills
    from the `-Xptxas -v` report a build keeps beside its library."""
    monkeypatch.setattr(_cuda_common, "BUILD_DIR", str(tmp_path))
    rel = "csrc/flash_attention_bwd.cu"
    report = (
        "ptxas info    : Compiling entry function '_Z7kernelAv' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _Z7kernelAv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 232 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_Z7kernelBv' for "
        "'sm_90a'\n"
        "    8 bytes stack frame, 12 bytes spill stores, 24 bytes spill "
        "loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers\n")
    with open(_cuda_common._lib_path(rel) + ".log", "w") as f:
        f.write(report)
    assert _cuda_common.ptxas_usage(rel) == {
        "_Z7kernelAv": {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                        "registers": 232},
        "_Z7kernelBv": {"stack": 8, "spill_stores": 12, "spill_loads": 24,
                        "registers": 168}}
