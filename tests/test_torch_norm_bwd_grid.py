"""The fused norm backward (K3 RMS and K3-LN) on the CPU: its launch plan,
the plan's copy of the kernel's layout constants, the wrapper path up to
the C call, and its plain version against paddle_tpu's Pallas backward at
the main paths' widths.

On the card `fused_rms_norm_bwd` / `fused_layer_norm_bwd` run the row
kernel of csrc/fused_norm.cu: a row group of ceil(h / 1024) warps takes
one row at a time, a block holds max(1, 8 // that) groups, one block per
SM over a contiguous row range; each block writes one f32 partial row of dw
(and db) and a second kernel adds the partial rows in a fixed order.
Here:
  * `norm_bwd_plan` is pinned at the main paths' shapes and around its
    switches: ceil(h / 1024) warps a row (the layout switches past 1024,
    2048, ...), the wide path past MAX_HIDDEN / MAX_HIDDEN_LN and for
    rows that are not 16-byte vectors; `norm_bwd_plan_for` finds those
    from the tensors' dtype, width and pointers;
  * the Python layout constants equal the C source's (`kGroupCols`,
    `kBlockWarps`, `kMaxGroupWarps`, `kWideCols`), which the C launcher
    recomputes the row groups from;
  * the kernel's walk (block b: rows [b * rpb, b * rpb + rpb); group g of
    it: rows r0 + g, r0 + g + groups, ...) owns every row exactly once, in
    at most one block per SM, with one partial row per block;
  * the CUDA wrapper path (the wrappers' checks, plan, scratch and C
    call), run on CPU tensors with the C call replaced by a stand-in that
    records its arguments: the plan's blocks and rows a block, the
    partial rows [blocks (x 2), h], no `coef` on the row kernel's route
    and the f32 [2 * rows] `coef` on the wide path, one launch counted;
  * the port's plain backward against paddle_tpu's Pallas backward
    (interpret mode) at h = 768, 1024 and 2048 on 2 x 9 rows.
Tolerances, of each output's largest |value|: f32 dx 1e-5 (f32 sums in
another order), dw and db 1e-4 (summed in f32 over rows in another
order), bf16 2^-7 (each side rounds its f32 result once to bf16).
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (x64 and the package's jax setup)
from paddle_tpu.ops import pallas_norm as pn

from paddle_tpu_torch.ops import _cuda_common
from paddle_tpu_torch.ops import fused_norm as fn

SMS = 132
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


# ------------------------------------------------------------- the plan

@pytest.mark.parametrize("rows,h,top,vec,want", [
    # LLaMA 1B (RMS), GPT-3 medium and BERT-base (LayerNorm)
    (4096, 2048, fn.MAX_HIDDEN, True, ("rows", 2, 4, 128, 32)),
    (4096, 1024, fn.MAX_HIDDEN_LN, True, ("rows", 1, 8, 128, 32)),
    (8192, 768, fn.MAX_HIDDEN_LN, True, ("rows", 1, 8, 131, 63)),
    (4099, 2048, fn.MAX_HIDDEN, True, ("rows", 2, 4, 129, 32)),
    (8195, 768, fn.MAX_HIDDEN_LN, True, ("rows", 1, 8, 131, 63)),
    # fewer rows than a block's warps, and the tiny chip_smoke rows
    (7, 80, fn.MAX_HIDDEN_LN, True, ("rows", 1, 8, 1, 7)),
    (66, 64, fn.MAX_HIDDEN, True, ("rows", 1, 8, 9, 8)),
    # the widest rows the row kernel takes, and one element past them
    (33, 12288, fn.MAX_HIDDEN, True, ("rows", 12, 1, 33, 1)),
    (33, 11264, fn.MAX_HIDDEN_LN, True, ("rows", 11, 1, 33, 1)),
    (33, 12296, fn.MAX_HIDDEN, True, ("wide", 0, 0, 33, 1)),
    (33, 11272, fn.MAX_HIDDEN_LN, True, ("wide", 0, 0, 33, 1)),
    (4096, 16384, fn.MAX_HIDDEN, True, ("wide", 0, 0, 66, 63)),
    # rows that are not 16-byte vectors: the one-element wide path
    (7, 100, fn.MAX_HIDDEN, False, ("wide", 0, 0, 7, 1)),
    (4096, 1024, fn.MAX_HIDDEN_LN, False, ("wide", 0, 0, 512, 8)),
])
def test_plan_pinned(rows, h, top, vec, want):
    assert tuple(fn.norm_bwd_plan(rows, h, SMS, top, vec)) == want


@pytest.mark.parametrize("h,warps", [(8, 1), (768, 1), (1024, 1), (1032, 2),
                                     (2048, 2), (2056, 3), (3072, 3),
                                     (4096, 4), (6144, 6), (11264, 11),
                                     (12288, 12)])
def test_layout_switches_at_the_named_widths(h, warps):
    """One warp a row up to h = 1024 (GPT's, BERT's widths), two up to
    2048 (LLaMA's), one more each 1024 past that; max(1, 8 // warps)
    groups a block, so a block is 8 warps or fewer up to h = 8192, one
    group of at most 12 warps (384 threads) past it."""
    plan = fn.norm_bwd_plan(4096, h, SMS, fn.MAX_HIDDEN, True)
    assert plan.route == "rows"
    assert (plan.row_warps, plan.groups) == (warps, max(1, 8 // warps))
    assert plan.row_warps * plan.groups <= max(8, warps) <= 12


def _source_constants():
    """{name: value} of csrc/fused_norm.cu's integer `constexpr`s, each
    evaluated from the ones above it (those that are not plain
    arithmetic of them are left out)."""
    path = os.path.join(os.path.dirname(fn.__file__), os.pardir, "csrc",
                        "fused_norm.cu")
    with open(path) as f:
        text = f.read()
    found = {}
    for name, expr in re.findall(r"constexpr\s+(?:int|size_t)\s+(\w+)\s*=\s*"
                                 r"([^;]+);", text):
        try:
            found[name] = eval(expr, {"__builtins__": {}}, dict(found))
        except (NameError, SyntaxError, TypeError):
            pass
    return found


@pytest.mark.parametrize("expr,want", [
    ("kGroupCols", fn._GROUP_COLS),
    ("kBlockWarps", fn._BLOCK_WARPS),
    ("kWideCols", fn._WIDE_COLS),
    ("kMaxGroupWarps * kGroupCols", fn.MAX_HIDDEN),
    ("kMaxGroupWarps * kGroupCols >= MAX_HIDDEN_LN", True)])
def test_layout_constants_match_the_source(expr, want):
    """The plan's row layout and the C launcher's are one: the launcher
    recomputes a row group's warps and a block's groups from h with these
    constants, and refuses rows wider than kMaxGroupWarps groups of
    kGroupCols; the plan sends those to the wide path."""
    found = _source_constants()
    assert eval(expr, {"__builtins__": {}},
                found | {"MAX_HIDDEN_LN": fn.MAX_HIDDEN_LN}) == want


@pytest.mark.parametrize("dtype,h,moved,route", [
    ("float32", 1024, None, "rows"),
    ("bfloat16", 768, None, "rows"),
    ("float32", 102, None, "wide"),    # not 4-element vectors
    ("bfloat16", 100, None, "wide"),   # 4-element but not 8-element
    ("bfloat16", 1024, "s", "wide"),   # s one element off 16 bytes
    ("bfloat16", 1024, "dy", "wide"),  # an f32 dy one element off
    ("bfloat16", 1024, "ds", "wide"),  # ds one element off
])
def test_plan_for_reads_the_tensors(dtype, h, moved, route):
    """`norm_bwd_plan_for`, the plan the wrappers launch: the row kernel
    for rows of 16-byte vectors of s's dtype with every tensor on 16
    bytes, the one-element wide path otherwise; an f32 dy beside a bf16 s
    (the train steps' plain norm) counts only its start."""
    rows = 9
    make = {"s": (rows, h, TDT[dtype]), "dy": (rows, h, torch.float32),
            "ds": (rows, h, TDT[dtype]), "w": (h, None, TDT[dtype])}
    t = {}
    for name, (a, b, dt) in make.items():
        size = a if b is None else a * b
        flat = torch.zeros(size + 1, dtype=dt)
        t[name] = (flat[1:] if name == moved else flat[:size]).view(
            (a,) if b is None else (a, b))
    plan = fn.norm_bwd_plan_for(t["s"], t["w"], t["dy"], t["ds"],
                                fn.MAX_HIDDEN, SMS)
    assert plan == fn.norm_bwd_plan(rows, h, SMS, fn.MAX_HIDDEN,
                                    route == "rows")
    assert plan.route == route


def _owners(plan, rows):
    """{row: (block, group, k)}: the row kernel's walk, as the C code
    takes it (block b, group g: its k-th row r0 + g + k * groups)."""
    seen = {}
    for b in range(plan.blocks):
        r0 = b * plan.rpb
        r1 = min(rows, r0 + plan.rpb)
        for g in range(plan.groups):
            for k, r in enumerate(range(r0 + g, r1, plan.groups)):
                assert r not in seen, (r, seen[r], (b, g, k))
                seen[r] = (b, g, k)
    return seen


@pytest.mark.parametrize("sms", [132, 114, 8])
@pytest.mark.parametrize("rows", [1, 7, 12, 66, 600, 4096, 4099, 8195])
@pytest.mark.parametrize("h", [64, 768, 1024, 2048, 2056, 12288])
def test_every_row_owned_once(sms, rows, h):
    """Every row belongs to exactly one (block, group); one wave of at
    most one block per SM; the groups of a full block take rows that
    differ in number by at most one; the partial rows are the blocks."""
    plan = fn.norm_bwd_plan(rows, h, sms, fn.MAX_HIDDEN, True)
    owners = _owners(plan, rows)
    assert sorted(owners) == list(range(rows))
    assert plan.blocks <= sms
    assert (plan.blocks - 1) * plan.rpb < rows <= plan.blocks * plan.rpb
    per = {}
    for b, g, _ in owners.values():
        per[(b, g)] = per.get((b, g), 0) + 1
    for b in range(plan.blocks - 1):
        counts = [per.get((b, g), 0) for g in range(plan.groups)]
        assert sum(counts) == plan.rpb and max(counts) - min(counts) <= 1


def _inputs(rs, rows, h, dtype, layer):
    x = rs.randn(rows, h).astype("float32") + (4.0 if layer else 0.0)
    t = {n: torch.from_numpy(a).to(TDT[dtype]) for n, a in (
        ("s", x), ("dy", rs.randn(rows, h).astype("float32")),
        ("ds", rs.randn(rows, h).astype("float32")))}
    wv = rs.randn(h).astype("float32")
    if layer:
        t["w"], t["b"] = torch.from_numpy(wv), torch.from_numpy(
            rs.randn(h).astype("float32"))
        _, _, t["rstd"], t["mean"] = fn.layer_norm_fwd_reference(
            t["s"], None, t["w"], t["b"], 1e-5)
    else:
        t["w"] = torch.from_numpy(wv).to(TDT[dtype])
        _, _, t["rstd"] = fn.rms_norm_fwd_reference(t["s"], None, t["w"],
                                                    1e-6)
        t["mean"] = None
    return t


def _rel(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


# -------------------------------------------------- the wrapper path

def _stand_in(seen, layer, t):
    """A stand-in for the C entry: checks the input pointers and records
    the grid and the scratch it is given; it writes nothing."""
    def entry(*args):
        if layer:
            (s, w, rstd, mean, dy, ds, dx, dw, db, part, coef, rows, h,
             blocks, rpb, xdt, ydt, stream) = args
        else:
            (s, w, rstd, dy, ds, dx, dw, part, coef, rows, h, blocks, rpb,
             xdt, ydt, stream) = args
        assert s == t["s"].data_ptr() and dy == t["dy"].data_ptr()
        assert (ds is None) == (t["ds"] is None) and part
        seen.append((rows, h, blocks, rpb, coef is not None))
        return 0
    return entry


@pytest.mark.parametrize("layer", [False, True], ids=["rms", "ln"])
@pytest.mark.parametrize("rows,h,offset,want_route", [
    (300, 1024, 0, "rows"), (37, 2056, 0, "rows"),
    (300, 1024, 1, "wide"),      # a row off 16 bytes: the one-element path
    (9, 12296, 0, "wide")])      # past MAX_HIDDEN (and MAX_HIDDEN_LN)
@pytest.mark.parametrize("add", [False, True], ids=["plain", "add"])
def test_wrapper_launches_the_plan(monkeypatch, layer, rows, h, offset,
                                   want_route, add):
    rs = np.random.RandomState(h + offset)
    t = _inputs(rs, rows, h, "bfloat16", layer)
    if offset:
        flat = torch.empty(rows * h + offset, dtype=t["s"].dtype)
        flat[offset:] = t["s"].reshape(-1)
        t["s"] = flat[offset:].view(rows, h)
    if not add:
        t["ds"] = None
    seen = []

    class Lib:
        pass

    name = "fused_layer_norm_bwd" if layer else "fused_rms_norm_bwd"
    top = fn.MAX_HIDDEN_LN if layer else fn.MAX_HIDDEN
    plan = fn.norm_bwd_plan_for(t["s"], t["w"], t["dy"], t["ds"], top, SMS)
    assert plan.route == want_route
    lib = Lib()
    setattr(lib, name, _stand_in(seen, layer, t))
    monkeypatch.setattr(fn, "_plain", lambda name, *tensors: False)
    monkeypatch.setattr(fn, "kernel_library", lambda n: lib)
    monkeypatch.setattr(fn, "current_stream", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {
                            "multi_processor_count": SMS}))
    empty, sizes = torch.empty, []

    def recording_empty(*size, **kw):
        if kw.get("dtype") == torch.float32:
            sizes.append(size[0] if len(size) == 1 else size)
        return empty(*size, **kw)

    monkeypatch.setattr(torch, "empty", recording_empty)
    _cuda_common.reset_launch_counts()
    if layer:
        got = fn.fused_layer_norm_bwd(t["s"], t["w"], t["rstd"], t["mean"],
                                      t["dy"], t["ds"])
        want = (t["s"].dtype, torch.float32, torch.float32)
    else:
        got = fn.fused_rms_norm_bwd(t["s"], t["w"], t["rstd"], t["dy"],
                                    t["ds"])
        want = (t["s"].dtype, t["w"].dtype)
    assert seen == [(rows, h, plan.blocks, plan.rpb, want_route == "wide")]
    # f32 scratch: the partial rows, then (wide path only) the row sums
    scratch = [((2 if layer else 1) * plan.blocks, h)] \
        + ([2 * rows] if want_route == "wide" else [])
    assert sizes[:len(scratch)] == scratch
    assert 2 * rows not in sizes[len(scratch):]
    assert _cuda_common.launch_counts()[name] == 1
    assert [g.dtype for g in got] == list(want)
    assert [g.shape for g in got] == [t["s"].shape] + [(h,)] * (len(got) - 1)


# ------------------------------------------- against paddle_tpu's Pallas

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [768, 1024, 2048])
@pytest.mark.parametrize("layer", [False, True], ids=["rms", "ln"])
def test_plain_backward_matches_pallas_at_main_widths(dtype, h, layer):
    """The port's plain backward (the kernels' CPU path and card
    yardstick) against `_norm_backward`, the
    reference's Pallas kernel in interpret mode, on the same 2 x 9 rows
    and saved statistics."""
    rs = np.random.RandomState(h + layer)
    t = _inputs(rs, 18, h, dtype, layer)
    s3, dy3 = t["s"].reshape(2, 9, h), t["dy"].reshape(2, 9, h)
    sj = jnp.asarray(t["s"].float().numpy()).astype(JDT[dtype])
    dyj = jnp.asarray(t["dy"].float().numpy()).astype(JDT[dtype])
    wj = jnp.asarray(t["w"].float().numpy()).astype(
        jnp.float32 if layer else JDT[dtype])
    rj = jnp.asarray(t["rstd"].numpy())[:, None]
    mj = None if not layer else jnp.asarray(t["mean"].numpy())[:, None]
    dx, dw, db = pn._norm_backward(sj, wj, rj, mj, dyj,
                                   "layer" if layer else "rms", layer)
    ref = {"dx": np.array(dx.astype(jnp.float32)),
           "dw": np.array(dw.astype(jnp.float32))}
    if layer:
        ref["db"] = np.array(db.astype(jnp.float32))
        got = fn.layer_norm_bwd_reference(s3, t["w"], t["rstd"], t["mean"],
                                          dy3)
    else:
        got = fn.rms_norm_bwd_reference(s3, t["w"], t["rstd"], dy3)
    half = dtype == "bfloat16"
    for key, g in zip(("dx", "dw", "db"), got):
        want = torch.from_numpy(ref[key]).reshape(g.shape)
        tol = 2 ** -7 if half and (key == "dx" or not layer) else (
            1e-5 if key == "dx" else 1e-4)
        assert _rel(g, want) <= tol, key


# ------------------------------------------- the profile's kernel kinds

@pytest.mark.parametrize("key,kind", [
    ("norm_fwd_kernel<__nv_bfloat16, float, float, 8, true, false>",
     "layer_norm_fwd"),
    ("norm_fwd_kernel<__nv_bfloat16, float, __nv_bfloat16, 8, false, "
     "false>", "rms_norm_fwd"),
    ("norm_bwd_rows_kernel<__nv_bfloat16, float, float, true>",
     "layer_norm_bwd"),
    ("norm_bwd_rows_kernel<__nv_bfloat16, float, __nv_bfloat16, false>",
     "rms_norm_bwd"),
    ("norm_bwd_sum_kernel<float, true>", "layer_norm_bwd"),
    ("norm_bwd_sum_kernel<float, false>", "rms_norm_bwd"),
    ("norm_bwd_coef_kernel<float, float, float, 4, true>", "layer_norm_bwd"),
    ("norm_bwd_wide_kernel<__half, float, __half, 1, false>",
     "rms_norm_bwd")])
def test_profile_kinds_follow_the_layer_flag(key, kind):
    """chip_smoke's PROFILE_TRAIN* put each norm kernel's time under its
    kind by the template's LAYER flag (the forward's fifth argument, each
    backward kernel's last), whatever dw's dtype."""
    import chip_smoke

    name = f"void (anonymous namespace)::{key}(float const*, int, int)"
    assert chip_smoke._kernel_kind(name) == kind
