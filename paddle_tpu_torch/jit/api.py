"""`to_static`: a function run as one captured CUDA graph per
specialization.

Port of paddle_tpu/jit/api.py (`CompiledFunction`, `to_static`,
`BucketAxis`, `default_buckets`, `not_to_static`, `ignore_module`), with
the reference's phases, keys, guards, bucketing and graph-break rules;
the XLA program becomes a CUDA graph (`core.graphs`, the mechanism the
serving engine's programs use):

  call 1 of a key: plain eager execution (warm-up: lazy state such as
          optimizer moments, master weights, cuBLAS handles and kernel
          modules is created here).
  call 2: eager discovery. A dispatch mode records every tensor that
          existed before the call and that the call reads (the captures)
          or writes in place (the mutations: `spec.ro_caps`,
          `spec.mut_caps`); the kernel wrappers report the tensors their
          launches touch (`ops._cuda_common.count_launch`), which the
          dispatcher does not see on a card. It also detects graph
          breaks: a host read of a tensor's value (`.item()`, `float()`,
          `bool()`, `.tolist()`, `.numpy()`, a copy to the host,
          `nonzero`) and an explicit generator it cannot register. On a
          card the call runs on the side stream the graph will be
          captured on, which warms that stream (cuBLAS workspace).
  call 3 and later: the compiled program. On a card the tensor arguments
          are copied into static inputs, the function is captured once
          into a `torch.cuda.CUDAGraph` (into one memory pool per
          `CompiledFunction`, shared by its keys) and replayed, then
          replayed at every later call; on the CPU the function is called
          on the static inputs. The keys, guards, outputs and the marker
          that GradScaler and the optimizers read (`compiled_call_active`)
          are the same on both.

While a compiled call (discovery, capture or the CPU's static call) runs,
`compiled_call_active()` is true: `GradScaler.step` then takes the
reference's traced branch (zero the gradients on overflow, step anyway)
and an optimizer's `step()` reads its learning rate from `_lr_t` without
refreshing it from the host.

Keys (`_key`): the arguments' structure, each tensor's shape, dtype,
`stop_gradient` (not `requires_grad`) and device, and the value of every
non-tensor leaf. A graph reads fixed addresses, so before each replay the
guard compares the storage address of every capture and mutation with
the one it was captured with: a parameter rebound by `set_state_dict`,
`amp.decorate` or `p.data = ...` recaptures instead of reading stale
memory. `share_discovery=True`: a new key reuses the last discovery and
goes straight to the compiled program, as the reference's does (prime
with a small batch, then run the big one without an eager pass at full
size). `bucket_axes` pads the named arguments before the key lookup.

Outputs carry no autograd history, as the reference's, and are copied out
of the graph's static output, so they stay valid after the next call.

Graph breaks. A break found at discovery decides the third call: with
`full_graph=True` it raises RuntimeError; otherwise it warns once ("graph
break") and the function runs eagerly from then on (`_segmented` under
`FLAGS_to_static_segmented`, the default; `_fallback_eager` without it).
The reference's segmented mode runs the ops between breaks as lazily
compiled XLA segments; torch's eager ops on a card already run
asynchronously between the host reads, which is what those segments
buy, so the port's segments are its eager ops. Nothing was captured, and
discovery ran eagerly, so a function that breaks leaves no partial state.
A capture that fails for another reason raises, naming the function and
the key.

RNG: dropout draws from the default CUDA generator, which a graph
registers itself, so each replay draws new masks; an explicit CUDA
generator the function draws from is registered with the graph.

Not ported: `in_shardings` (distributed), `program_text` /
`program_jaxpr` / `program_index` (static analysis), `jit.save` /
`jit.load` and dy2static's control-flow rewriting (a tensor-valued `if`
is a graph break here); each raises NotImplementedError naming its ROADMAP
item.
"""
from __future__ import annotations

import functools
import hashlib
import time
import traceback
import warnings

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from ..core import graphs
from ..core.flags import flag
from ..core.tensor import Tensor
from ..obs import costs as _costs
from ..obs import train_flight as _train_flight
from ..obs import watchdog as _watchdog
from ..obs.costs import extract_cost
from ..ops import _cuda_common

#: depth of the compiled calls (discoveries, captures, static calls) now
#: running; a module value, not a thread-local one, so the autograd
#: engine's worker threads see it too
_ACTIVE = [0]


def compiled_call_active() -> bool:
    """True while a `to_static` discovery, capture or static call runs."""
    return _ACTIVE[0] > 0


class _Active:
    def __enter__(self):
        _ACTIVE[0] += 1

    def __exit__(self, *exc):
        _ACTIVE[0] -= 1


def not_to_static(fn):
    """The reference's marker: `fn` runs as it is (the port's `to_static`
    only compiles what it wraps)."""
    return fn


def ignore_module(modules):
    return None


def default_buckets(n: int) -> int:
    """Round a dynamic length up to its bucket: next power of two up to 512,
    then multiples of 512."""
    if n <= 1:
        return 1
    if n <= 512:
        return 1 << (n - 1).bit_length()
    return ((n + 511) // 512) * 512


class BucketAxis:
    """Per-argument bucketing spec for to_static: pad tensor arg along
    `axis` up to the bucket boundary with `pad_value` (the wrapped
    function must be padding-neutral on that axis, e.g. labels padded
    with an ignore_index)."""

    __slots__ = ("axis", "pad_value", "buckets")

    def __init__(self, axis: int, pad_value=0, buckets=None):
        self.axis = axis
        self.pad_value = pad_value
        self.buckets = sorted(buckets) if buckets else None

    def round_up(self, n: int) -> int:
        if self.buckets is not None:
            for b in self.buckets:
                if n <= b:
                    return b
            return n  # beyond the largest bucket: no padding
        return default_buckets(n)


# ------------------------------------------------------------ pytrees

class _TensorLeaf:
    """A tensor's place among the leaves; `wrapped`: it was a Tensor (the
    Tensor API's wrapper), unwrapped to its torch tensor for the call and
    wrapped again for the function and its caller."""
    __slots__ = ("idx", "wrapped")

    def __init__(self, idx, wrapped=False):
        self.idx = idx
        self.wrapped = wrapped


def _flatten(obj, leaves):
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return _TensorLeaf(len(leaves) - 1)
    if isinstance(obj, Tensor):
        leaves.append(obj._data)
        return _TensorLeaf(len(leaves) - 1, True)
    if isinstance(obj, (list, tuple)):
        t = [_flatten(v, leaves) for v in obj]
        return tuple(t) if isinstance(obj, tuple) else t
    if isinstance(obj, dict):
        return {k: _flatten(obj[k], leaves) for k in obj}
    return obj


def _unflatten(struct, leaf_vals):
    if isinstance(struct, _TensorLeaf):
        v = leaf_vals[struct.idx]
        return Tensor._wrap(v) if struct.wrapped else v
    if isinstance(struct, list):
        return [_unflatten(v, leaf_vals) for v in struct]
    if isinstance(struct, tuple):
        return tuple(_unflatten(v, leaf_vals) for v in struct)
    if isinstance(struct, dict):
        return {k: _unflatten(v, leaf_vals) for k, v in struct.items()}
    return struct


def _struct_key(struct):
    if isinstance(struct, _TensorLeaf):
        return f"{'W' if struct.wrapped else 'T'}{struct.idx}"
    if isinstance(struct, (list, tuple)):
        inner = ",".join(_struct_key(v) for v in struct)
        return f"[{inner}]" if isinstance(struct, list) else f"({inner})"
    if isinstance(struct, dict):
        return "{" + ",".join(f"{k}:{_struct_key(v)}"
                              for k, v in struct.items()) + "}"
    return repr(struct)


# ----------------------------------------------------------- discovery

#: aten ops that read a tensor's value on the host (the graph breaks the
#: dispatcher shows)
_HOST_READS = {"aten::_local_scalar_dense", "aten::nonzero",
               "aten::masked_select", "aten::unique_consecutive",
               "aten::_unique2"}
#: tensor methods that hand a tensor's value to the host
_HOST_METHODS = {"tolist", "numpy", "item", "__bool__", "__float__",
                 "__int__", "__index__"}


def _storage_key(t):
    return t.untyped_storage().data_ptr() if t.numel() else None


class _Discovery:
    """What one discovery call saw: the tensors it read and wrote that
    existed before it (by storage), the explicit generators it drew from,
    and its graph breaks (reason, site)."""

    def __init__(self, arg_storages):
        self.created: set = set(arg_storages)
        self.reads: dict = {}       # storage -> tensor
        self.writes: dict = {}
        self.generators: list = []
        self.breaks: list = []
        self.cost = None            # obs.costs.extract_cost's count

    def on_read(self, t):
        if isinstance(t, torch.Tensor):
            k = _storage_key(t)
            if k is not None and k not in self.created:
                self.reads.setdefault(k, t)

    def on_write(self, t):
        if isinstance(t, torch.Tensor):
            k = _storage_key(t)
            if k is not None and k not in self.created:
                self.writes.setdefault(k, t)
                self.reads.setdefault(k, t)

    def on_created(self, t):
        if isinstance(t, torch.Tensor):
            k = _storage_key(t)
            if k is not None and k not in self.reads:
                self.created.add(k)

    def on_break(self, reason):
        site = ""
        for fr in reversed(traceback.extract_stack()[:-2]):
            if "paddle_tpu_torch/jit" not in fr.filename \
                    and "/torch/" not in fr.filename:
                site = f"{fr.filename}:{fr.lineno}"
                break
        self.breaks.append((reason, site))

    def on_kernel(self, reads, writes):
        for t in reads:
            self.on_read(t)
        for t in writes:
            self.on_write(t)


def _tensors_in(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors_in(v)


class _DispatchRecorder(TorchDispatchMode):
    """Records reads, in-place writes, outputs and host reads of the aten
    ops a discovery runs."""

    def __init__(self, disc):
        super().__init__()
        self.disc = disc

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        disc = self.disc
        name = func._schema.name
        if name in _HOST_READS:
            disc.on_break(f"{name} reads a tensor's value on the host")
        elif name in ("aten::_to_copy", "aten::copy_"):
            src = args[1] if name == "aten::copy_" else args[0]
            dst = args[0].device if name == "aten::copy_" \
                else kwargs.get("device")
            if isinstance(src, torch.Tensor) and src.device.type != "cpu" \
                    and dst is not None and torch.device(dst).type == "cpu":
                disc.on_break(f"{name} copies a device tensor to the host")
        gen = kwargs.get("generator")
        if isinstance(gen, torch.Generator) and gen.device.type == "cuda" \
                and all(g is not gen for g in disc.generators):
            disc.generators.append(gen)
        written = []
        for i, a in enumerate(func._schema.arguments):
            val = kwargs.get(a.name) if a.kwarg_only or i >= len(args) \
                else args[i]
            alias = a.alias_info
            for t in _tensors_in(val):
                if alias is not None and alias.is_write:
                    written.append(t)
                else:
                    disc.on_read(t)
        for t in written:
            disc.on_write(t)
        out = func(*args, **kwargs)
        for t in _tensors_in(out if isinstance(out, (list, tuple))
                             else [out]):
            if not any(t is w for w in written):
                disc.on_created(t)
        return out


class _MethodRecorder(TorchFunctionMode):
    """The host reads that run no aten op on the CPU (`tolist`, `numpy`,
    ...), seen at the torch-function level on both devices."""

    def __init__(self, disc):
        super().__init__()
        self.disc = disc

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in _HOST_METHODS or (name == "cpu" and args
                                     and isinstance(args[0], torch.Tensor)
                                     and args[0].device.type != "cpu"):
            self.disc.on_break(f"Tensor.{name} hands a tensor's value to "
                               "the host")
        return func(*args, **(kwargs or {}))


# -------------------------------------------------------- specializations

class _Specialization:
    """One key's compiled program: the discovery's captures (read-only
    and mutated), their storage addresses at the capture, the static
    inputs and, on a card, the captured graph."""

    __slots__ = ("captures", "ro_caps", "mut_caps", "ptrs", "inputs",
                 "in_struct", "captured", "out_struct", "generators",
                 "cost_entry")

    def guard_ok(self) -> bool:
        return [t.data_ptr() for t in self.captures] == self.ptrs


class CompiledFunction:
    def __init__(self, fn, input_spec=None, build_strategy=None,
                 backend=None, full_graph=False, donate_buffers=None,
                 bucket_axes=None, share_discovery=False,
                 in_shardings=None):
        if in_shardings is not None:
            raise NotImplementedError(
                "to_static(in_shardings=...) is not ported (ROADMAP Queue "
                "1, 'to_static in_shardings': distributed, After these)")
        functools.update_wrapper(self, fn)
        self._fn = fn
        self._cache: dict = {}        # key -> _Specialization
        self._state: dict = {}        # key -> call count
        self._discovered: dict = {}   # key -> _Discovery
        # donate_buffers is the reference's: a graph updates its captures
        # in place, so there is nothing to donate
        self._full_graph = full_graph
        self._fallback_eager = False
        self._segmented = False
        self._bucket_axes = {
            k: (v if isinstance(v, BucketAxis) else
                BucketAxis(*((v,) if isinstance(v, int) else tuple(v))))
            for k, v in (bucket_axes or {}).items()}
        self._share_discovery = share_discovery
        self._break_reason = None
        self._last_break_sites: list = []
        self._pool = None             # the graphs' memory pool (a card)
        self._warned = False

    @property
    def function(self):
        return self._fn

    def concrete_program(self):
        return None

    def _name(self) -> str:
        return getattr(self._fn, "__qualname__",
                       getattr(self._fn, "__name__", str(self._fn)))

    def graph_break_report(self) -> dict:
        """Capture coverage: whether a program was compiled, the
        fallback mode, the break's reason and its sites."""
        return {
            "function": self._name(),
            "transform": None,
            "compiled": bool(self._cache) and not self._segmented
            and not self._fallback_eager,
            "graphs": sum(s.captured is not None
                          for s in self._cache.values()),
            "segmented": self._segmented,
            "eager": self._fallback_eager,
            "break_reason": self._break_reason,
            "break_sites": list(self._last_break_sites),
            "segments": 0,
        }

    def program_text(self, key=None):
        raise NotImplementedError(
            "program_text / program_jaxpr / program_index (static analysis "
            "of the compiled program) are not ported (ROADMAP Queue 1, "
            "'to_static program_text')")

    program_jaxpr = program_text
    program_index = program_text

    def __get__(self, instance, owner):
        if instance is None:
            return self
        return functools.partial(self.__call__, instance)

    def _key(self, struct, leaves):
        spec = ";".join(f"{tuple(t.shape)}|{t.dtype}|{not t.requires_grad}"
                        f"|{t.device}" for t in leaves)
        return _struct_key(struct) + "##" + spec

    def _apply_buckets(self, args):
        out = list(args)
        for idx, spec in self._bucket_axes.items():
            if idx >= len(out) or not isinstance(out[idx], torch.Tensor):
                raise ValueError(
                    f"to_static(bucket_axes={{{idx}: ...}}): positional arg "
                    f"{idx} is "
                    + ("missing" if idx >= len(out)
                       else f"a {type(out[idx]).__name__}, not a Tensor")
                    + " — bucketed args must be passed positionally")
            t = out[idx]
            n = int(t.shape[spec.axis])
            m = spec.round_up(n)
            if m == n:
                continue
            pads = [0, 0] * t.dim()
            pads[2 * (t.dim() - 1 - spec.axis % t.dim()) + 1] = m - n
            out[idx] = torch.nn.functional.pad(t, pads,
                                               value=spec.pad_value)
        return tuple(out)

    def __call__(self, *args, **kwargs):
        if self._fallback_eager or self._segmented \
                or not flag("FLAGS_enable_to_static"):
            return self._fn(*args, **kwargs)
        if self._bucket_axes:
            args = self._apply_buckets(args)
        leaves: list = []
        struct = _flatten((args, kwargs), leaves)
        key = self._key(struct, leaves)
        n = self._state.get(key, 0)
        self._state[key] = n + 1
        shared = (self._share_discovery and key not in self._discovered
                  and bool(self._discovered))
        if n == 0 and not shared:
            return self._fn(*args, **kwargs)          # warm-up
        if n == 1 and not shared:
            return self._discover(key, leaves, args, kwargs)
        spec = self._cache.get(key)
        if spec is not None and not spec.guard_ok():
            spec = None                               # rebound: recapture
        if spec is None:
            return self._compile_and_run(key, struct, leaves, args, kwargs)
        return self._run(spec, leaves)

    # ------------------------------------------------------------ phases
    def _device(self, leaves):
        devs = {t.device for t in leaves if t.device.type == "cuda"}
        return next(iter(devs)) if devs else None

    def _discover(self, key, leaves, args, kwargs):
        disc = _Discovery({_storage_key(t) for t in leaves})
        dev = self._device(leaves)
        stream = graphs.side_stream(dev) if dev is not None else None
        prev = _cuda_common.set_kernel_recorder(disc)

        def call():
            return self._fn(*args, **kwargs)

        try:
            with _Active(), _DispatchRecorder(disc), _MethodRecorder(disc):
                # the cost ledger's count of the program (obs/costs.py)
                # rides this eager run
                if stream is None:
                    disc.cost, out = extract_cost(call, dev, args=leaves)
                else:
                    # on the side stream the graph will be captured on
                    caller = torch.cuda.current_stream(dev)
                    stream.wait_stream(caller)
                    with torch.cuda.stream(stream):
                        disc.cost, out = extract_cost(call, dev,
                                                      args=leaves)
                    caller.wait_stream(stream)
        finally:
            _cuda_common.set_kernel_recorder(prev)
        self._discovered[key] = disc
        return out

    def _on_break(self, disc, struct, leaves):
        reason, site = disc.breaks[0]
        self._break_reason = f"{site}: {reason}" if site else reason
        self._last_break_sites = [s for _, s in disc.breaks]
        name = self._name()
        if self._full_graph:
            raise RuntimeError(
                f"to_static(full_graph=True): '{name}' cannot be captured "
                f"as one graph — {self._break_reason}. Remove the host "
                "read, or pass full_graph=False to run it eagerly.")
        mode = "segmented" if flag("FLAGS_to_static_segmented") else "eager"
        if not self._warned:
            warnings.warn(
                f"to_static: graph break in '{name}' — {self._break_reason}"
                f"; running it eagerly from now on ({mode}: torch's eager "
                "ops are the segments between host reads)", stacklevel=4)
            self._warned = True
        if mode == "segmented":
            self._segmented = True
        else:
            self._fallback_eager = True
        a, k = _unflatten(struct, leaves)
        return self._fn(*a, **k)

    def _compile_and_run(self, key, struct, leaves, args, kwargs):
        disc = self._discovered.get(key)
        own = disc is not None
        if disc is None and self._share_discovery and self._discovered:
            disc = next(reversed(self._discovered.values()))
        if disc is None:
            return self._discover(key, leaves, args, kwargs)
        if disc.breaks:
            return self._on_break(disc, struct, leaves)
        spec = _Specialization()
        caps = list(disc.reads.values())
        muts = set(disc.writes)
        spec.captures = caps
        spec.mut_caps = [t for k, t in disc.reads.items() if k in muts]
        spec.ro_caps = [t for k, t in disc.reads.items() if k not in muts]
        spec.ptrs = [t.data_ptr() for t in caps]
        spec.generators = list(disc.generators)
        spec.inputs = [t.detach().clone().requires_grad_(t.requires_grad)
                       for t in leaves]
        spec.in_struct = struct
        spec.captured = None
        spec.out_struct = None
        spec.cost_entry = None
        dev = self._device(leaves)
        t0 = time.perf_counter()
        if dev is not None:
            self._capture(key, spec, dev)
        self._cache[key] = spec
        out = self._run(spec, leaves)
        self._record_compile(key, spec, disc.cost if own else None,
                             spec.captured.capture_s if dev is not None
                             else time.perf_counter() - t0)
        return out

    def _record_compile(self, key, spec, cost, wall_s):
        """The key's cost-ledger row (its discovery's count; a key that
        compiled from another key's shared discovery has none) and its
        watchdog compile event, grouped per CompiledFunction instance:
        distinct wrapped functions sharing a name must not pool into one
        recompile storm."""
        name = getattr(self._fn, "__name__", str(self._fn))
        inst = f"{name}@{id(self) & 0xffff:04x}"
        digest = hashlib.sha1(key.encode()).hexdigest()[:8]
        # the row is this function's (two wrapped steps of one name and
        # argument shapes are two programs)
        spec.cost_entry = _costs.record_program(
            "to_static", name, f"{inst}/{digest}", cost=cost,
            wall_s=wall_s)
        _watchdog.record_compile(
            "to_static", inst, key,
            wall_s=wall_s, donated=True,
            cost=spec.cost_entry.cost_summary())

    def _body(self, spec):
        """The function on the static inputs, as a compiled call; returns
        its output's tensor leaves (the structure goes to the spec)."""
        a, k = _unflatten(spec.in_struct, spec.inputs)
        with _Active():
            out = self._fn(*a, **k)
        out_leaves: list = []
        spec.out_struct = _flatten(out, out_leaves)
        return out_leaves

    def _capture(self, key, spec, dev):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        try:
            spec.captured = graphs.capture(
                lambda: self._body(spec), graphs.side_stream(dev),
                self._pool, spec.generators)
        except Exception as e:
            raise RuntimeError(
                f"to_static: capturing '{self._name()}' for key {key} "
                f"failed: {e}") from e

    def _load(self, spec, leaves):
        for dst, src in zip(spec.inputs, leaves):
            if dst.data_ptr() != src.data_ptr():
                dst.detach().copy_(src.detach())

    def _run(self, spec, leaves):
        """One compiled call: the arguments into the static inputs, then
        the graph replayed (a card) or the function called on them (the
        CPU); the outputs copied out, without autograd history."""
        # an instrumented fit's flight recorder takes the call as a
        # dispatch span carrying the program's ledger flops (one module
        # read when none is active)
        rec = _train_flight.current()
        t0 = time.perf_counter() if rec is not None else None
        if spec.captured is not None:
            spec.captured.replay(lambda: self._load(spec, leaves))
            outs = spec.captured.output
        else:
            self._load(spec, leaves)
            outs = self._body(spec)
        out = _unflatten(spec.out_struct,
                         [t.detach().clone() for t in outs])
        if rec is not None and spec.cost_entry is not None:
            rec.program_dispatch(getattr(self._fn, "__name__", "to_static"),
                                 t0, time.perf_counter(),
                                 entry=spec.cost_entry)
        return out


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, full_graph=False, bucket_axes=None,
              share_discovery=False, in_shardings=None, **kwargs):
    """Decorator/wrapper running a function as one captured CUDA graph per
    key (see the module note). full_graph=False (default): a graph break
    warns once and the function runs eagerly from then on; True: it
    raises. bucket_axes: {arg_position: BucketAxis | axis | (axis,
    pad_value)}: the named tensor args are padded up to bucket boundaries
    before the key lookup, so N lengths make O(log N) keys. Decorating an
    `nn.Module` replaces its `forward`."""

    def wrap(fn):
        if isinstance(fn, CompiledFunction):
            return fn
        donate = kwargs.get("donate_buffers")
        if isinstance(fn, torch.nn.Module):
            fn.forward = CompiledFunction(
                fn.forward, input_spec, build_strategy, backend, full_graph,
                donate_buffers=donate, bucket_axes=bucket_axes,
                share_discovery=share_discovery, in_shardings=in_shardings)
            return fn
        return CompiledFunction(fn, input_spec, build_strategy, backend,
                                full_graph, donate_buffers=donate,
                                bucket_axes=bucket_axes,
                                share_discovery=share_discovery,
                                in_shardings=in_shardings)

    if function is not None:
        return wrap(function)
    return wrap
