"""Crash-consistent checkpoint core: atomic, checksummed, restore-with-fallback.

Port of paddle_tpu/ckpt/core.py: the same write protocol, manifest (v2,
format "paddle-tpu-ckpt"), named fallback reasons, retries and
retention, so a checkpoint written by either package restores in the
other. One invariant:

    **a torn write can never be mistaken for a complete checkpoint.**

Write protocol (``save_checkpoint``):

  1. serialize every array leaf to raw bytes + sha256 into a fresh temp
     dir ``<root>/.tmp.step_N.<nonce>`` (one shard file per leaf),
     fsync'ing each file;
  2. write ``manifest.json`` (step, tree structure, per-shard sha256 /
     shape / dtype, framework + flags fingerprint) and fsync it;
  3. fsync the temp dir, then ``os.rename`` it to ``step_N/`` — the
     COMMIT POINT;
  4. rewrite the ``latest`` pointer file (atomic replace) LAST.

A crash at any point leaves either debris under ``.tmp.*`` that restore
never looks at, or a fully-committed dir with a possibly stale
``latest`` — both safe. Transient ``OSError``s retry with exponential
backoff (``FLAGS_ckpt_save_retries``) before surfacing as
``CheckpointSaveError``.

Restore (``restore_checkpoint``) verifies the manifest parses, carries
its ``complete`` marker, and that every shard exists with a matching
sha256 — and **falls back to the newest older checkpoint that verifies**,
recording a named reason per rejected candidate (``torn_manifest``,
``checksum_mismatch``, ``missing_shard``, ...). Retention
(``gc_checkpoints``) deletes strictly oldest-first, never touches the dir
``latest`` points to, only considers fully-committed dirs, and deletes
via rename-then-rmtree.

Leaves: the Tensor API's ``Tensor``s, torch tensors (on any device) and
numpy arrays. ``host_copy`` snapshots them on the host: numpy arrays for
the dtypes numpy has, CPU torch tensors for bfloat16 and the float8
kinds, which numpy has not without ml_dtypes. Those are written as their
raw bit patterns under the reference's dtype strings ("bfloat16", ...)
and read back as CPU torch tensors; every other leaf restores as a numpy
array, as in the reference.

Sharded leaves (``ShardedLeaf``, ``host_copy(sharded=True)``,
``manifest_shardings`` and a manifest's "sharded" nodes) wait for the
distributed entry and raise NotImplementedError naming it.

Fault-injection seam: tests monkeypatch the no-op ``_TEST_HOOKS``
registry to crash/corrupt/fail at exact protocol points (``_fire``).
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import time
import uuid
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.flags import flag

#: test/CI seam — maps hook-point name -> callable(**kw). Points fired:
#:   io_write(path)          before every file write (raise OSError here)
#:   shard_written(index, total, path)   after shard fsync
#:   manifest_written(path)  after manifest fsync, before commit
#:   pre_commit(tmp, final)  immediately before the atomic rename
#:   committed(path)         after rename (in-place corruption goes here)
#:   pre_latest(root)        before the latest-pointer update
_TEST_HOOKS: dict = {}

_MANIFEST = "manifest.json"
_LATEST = "latest"
_STEP_RE = re.compile(r"^step_(\d+)$")
_FORMAT = "paddle-tpu-ckpt"
#: manifest schema: v1 = one shard file per array leaf; v2 adds
#: "sharded" tree nodes (a leaf split into per-device sub-shards with its
#: mesh and partition spec), which the port's reader refuses until the
#: distributed entry. Its writer writes v2 manifests without them.
_VERSION = 2


class CheckpointError(RuntimeError):
    """Base for checkpoint subsystem errors."""


class CheckpointSaveError(CheckpointError):
    """A save failed after exhausting FLAGS_ckpt_save_retries."""


class CheckpointNotFoundError(CheckpointError):
    """No committed checkpoint under the root verified clean."""


def _fire(point: str, **kw):
    fn = _TEST_HOOKS.get(point)
    if fn is not None:
        fn(**kw)


# ----------------------------------------------------------- obs metrics
def _metrics():
    """Lazy handles into the obs default registry (checkpointing is a
    rare event, not a hot path — registry lookups per save are fine)."""
    from .. import obs

    reg = obs.default_registry()
    return {
        "save_s": reg.histogram("ckpt_save_seconds",
                                "one checkpoint commit (serialize + fsync "
                                "+ rename), retries included"),
        "restore_s": reg.histogram("ckpt_restore_seconds",
                                   "one restore (verify + load), fallback "
                                   "scan included"),
        "saves": reg.counter("ckpt_saves_total",
                             "checkpoint saves by outcome",
                             ("result",)),
        "restores": reg.counter("ckpt_restores_total",
                                "checkpoint restores by outcome",
                                ("result",)),
        "bytes": reg.counter("ckpt_bytes_written_total",
                             "shard + manifest bytes committed"),
        "last_step": reg.gauge("ckpt_last_step",
                               "step of the last committed checkpoint"),
    }


# ------------------------------------------------------------- tree spec
#: the dtypes numpy lacks (without ml_dtypes): stored as raw bit patterns
#: under these names, the reference's
_RAW_DTYPES = {torch.bfloat16: "bfloat16",
               torch.float8_e4m3fn: "float8_e4m3fn",
               torch.float8_e5m2: "float8_e5m2"}
_RAW_BY_NAME = {v: k for k, v in _RAW_DTYPES.items()}

_DISTRIBUTED = ("waits for the distributed entry (ROADMAP 'After these', "
                "Distributed)")


def _is_array_leaf(v):
    if type(v).__name__ in ("Tensor", "Parameter") and hasattr(v, "_data"):
        return True
    return isinstance(v, (np.ndarray, torch.Tensor))


def _leaf_host(v):
    """One leaf on the host: a numpy array, or a CPU torch tensor for the
    raw dtypes (a view of a CPU tensor's memory, no copy)."""
    if hasattr(v, "_data"):
        v = v._data
    if isinstance(v, torch.Tensor):
        t = v.detach()
        if t.dtype in _RAW_DTYPES:
            return t.cpu()
        return t.cpu().numpy()
    return np.asarray(v)


class ShardedLeaf:
    """A leaf split into per-device shards with its mesh and partition
    spec: not ported yet."""

    __slots__ = ("shape", "dtype", "mesh", "spec", "shards")

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"ckpt.ShardedLeaf {_DISTRIBUTED}")


def host_copy(tree, sharded=False):
    """Device→host snapshot of every array leaf (a copy: once it returns,
    in-place updates of the live tensors cannot change what gets
    written). numpy arrays, or CPU torch tensors for the raw dtypes (see
    the module note). ``sharded=True`` (per-shard snapshots of a sharded
    leaf) waits for the distributed entry."""
    if sharded:
        raise NotImplementedError(
            f"ckpt.host_copy(sharded=True) {_DISTRIBUTED}")
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [host_copy(v) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    if _is_array_leaf(tree):
        raw = tree._data if hasattr(tree, "_data") else tree
        if isinstance(raw, torch.Tensor):
            t = raw.detach()
            if t.device.type == "cpu":
                t = t.clone()        # don't alias a buffer the loop writes
            return _leaf_host(t)
        return np.array(raw)
    return tree


def _leaf_bytes(arr):
    """(raw bytes, shape, dtype string) of one host leaf."""
    if isinstance(arr, torch.Tensor):
        t = arr.contiguous()
        return (t.view(torch.uint8).numpy().tobytes(), list(t.shape),
                _RAW_DTYPES[t.dtype])
    arr = np.ascontiguousarray(arr)
    return arr.tobytes(order="C"), list(arr.shape), str(arr.dtype)


def _from_bytes(data, node):
    """One shard's bytes as the leaf the manifest describes."""
    name = node["dtype"]
    if name in _RAW_BY_NAME:
        t = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        return t.view(_RAW_BY_NAME[name]).reshape(node["shape"])
    arr = np.frombuffer(data, dtype=np.dtype(name))
    return arr.reshape(node["shape"]).copy()


def _encode_tree(tree, shards: list):
    """Tree -> JSON descriptor; array leaves appended to `shards` as
    (bytes, shape, dtype) and described in place (file/sha256 filled at
    write time)."""
    if isinstance(tree, dict):
        return {"t": "dict",
                "items": {str(k): _encode_tree(v, shards)
                          for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"t": "list" if isinstance(tree, list) else "tuple",
                "items": [_encode_tree(v, shards) for v in tree]}
    if _is_array_leaf(tree):
        data, shape, dtype = _leaf_bytes(_leaf_host(tree))
        idx = len(shards)
        shards.append(data)
        return {"t": "shard", "index": idx, "shape": shape,
                "dtype": dtype, "bytes": len(data)}
    if isinstance(tree, (bool, int, float, str)) or tree is None:
        return {"t": "obj", "value": tree}
    if isinstance(tree, (np.integer,)):
        return {"t": "obj", "value": int(tree)}
    if isinstance(tree, (np.floating,)):
        return {"t": "obj", "value": float(tree)}
    raise TypeError(
        f"checkpoint tree leaf of type {type(tree).__name__} is not "
        "serializable (arrays, dict/list/tuple containers and JSON "
        "scalars only)")


def _decode_tree(node, read_shard):
    t = node["t"]
    if t == "dict":
        return {k: _decode_tree(v, read_shard)
                for k, v in node["items"].items()}
    if t in ("list", "tuple"):
        items = [_decode_tree(v, read_shard) for v in node["items"]]
        return items if t == "list" else tuple(items)
    if t == "shard":
        return read_shard(node)
    if t == "sharded":
        raise NotImplementedError(
            f"restoring a sharded checkpoint leaf {_DISTRIBUTED}")
    if t == "obj":
        return node["value"]
    raise CheckpointError(f"unknown tree node type {t!r}")


def _iter_shard_nodes(node):
    if node["t"] == "dict":
        for v in node["items"].values():
            yield from _iter_shard_nodes(v)
    elif node["t"] in ("list", "tuple"):
        for v in node["items"]:
            yield from _iter_shard_nodes(v)
    elif node["t"] == "shard":
        yield node
    elif node["t"] == "sharded":
        yield from node["subshards"]


def manifest_shardings(manifest) -> dict:
    """Per-leaf sharding provenance of one manifest: not ported yet."""
    raise NotImplementedError(f"ckpt.manifest_shardings {_DISTRIBUTED}")


# ------------------------------------------------------------- raw files
def _fsync_dir(path):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_file(path, data: bytes, fsync=True):
    _fire("io_write", path=path)
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        if fsync:
            os.fsync(f.fileno())


def atomic_write_bytes(path, data: bytes, fsync=True):
    """Crash-consistent single-file write: temp file in the same dir,
    fsync, atomic replace, dir fsync."""
    atomic_write_stream(path, lambda f: f.write(data), fsync=fsync)


def atomic_write_stream(path, write_fn, fsync=True):
    """Streaming variant of :func:`atomic_write_bytes`: `write_fn(f)`
    writes into the temp file directly, so multi-GB payloads
    (``paddle.save`` pickles a whole state dict, framework_io.py) never
    materialize a second full copy in host memory."""
    d = os.path.dirname(path) or "."
    tmp = os.path.join(d, f".{os.path.basename(path)}.tmp.{uuid.uuid4().hex[:8]}")
    try:
        _fire("io_write", path=tmp)
        with open(tmp, "wb") as f:
            write_fn(f)
            f.flush()
            if fsync:
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if fsync:
        _fsync_dir(d)


def step_dir_name(step: int) -> str:
    return f"step_{int(step):08d}"


def _fingerprint(extra=None) -> dict:
    fp = {"format": _FORMAT, "torch": torch.__version__,
          "residual_dtype": str(flag("FLAGS_residual_dtype"))}
    if extra:
        fp.update(extra)
    return fp


# ------------------------------------------------------------------ save
def _save_once(root, step, tree, fingerprint_extra=None) -> dict:
    """One write-protocol attempt.  Raises on any failure, leaving its
    temp dir behind exactly as a crash would (restore ignores it;
    clean_debris sweeps it)."""
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, step_dir_name(step))
    tmp = os.path.join(root, f".tmp.{step_dir_name(step)}.{uuid.uuid4().hex[:8]}")
    os.makedirs(tmp)

    shards: list = []
    spec = _encode_tree(tree, shards)
    total_bytes = 0
    shard_files = []
    for i, data in enumerate(shards):
        fname = f"shard_{i:05d}.bin"
        _write_file(os.path.join(tmp, fname), data)
        shard_files.append(
            {"file": fname,
             "sha256": hashlib.sha256(data).hexdigest()})
        total_bytes += len(data)
        _fire("shard_written", index=i, total=len(shards),
              path=os.path.join(tmp, fname))
    for node in _iter_shard_nodes(spec):
        node.update(shard_files[node.pop("index")])

    manifest = {"format": _FORMAT, "version": _VERSION, "step": int(step),
                "shard_count": len(shards),
                "fingerprint": _fingerprint(fingerprint_extra),
                "tree": spec,
                "complete": True}
    mdata = json.dumps(manifest, indent=1).encode()
    _write_file(os.path.join(tmp, _MANIFEST), mdata)
    total_bytes += len(mdata)
    _fire("manifest_written", path=os.path.join(tmp, _MANIFEST))
    _fsync_dir(tmp)

    _fire("pre_commit", tmp=tmp, final=final)
    displaced = None
    if os.path.isdir(final):
        # re-save of the same step (e.g. a SIGTERM save after a periodic
        # one): displace the old dir with a bare rename and delete it
        # only AFTER the new commit lands.  The exposure window is two
        # renames; a crash inside it leaves the old checkpoint complete
        # under `.trash.*`, which restore scans as a last resort — the
        # previously-good state is never destroyed before its
        # replacement exists
        displaced = os.path.join(
            root, f".trash.{os.path.basename(final)}.{uuid.uuid4().hex[:8]}")
        os.rename(final, displaced)
    os.rename(tmp, final)          # <- the commit point
    _fsync_dir(root)
    if displaced is not None:
        shutil.rmtree(displaced, ignore_errors=True)
    _fire("committed", path=final)

    _fire("pre_latest", root=root)
    atomic_write_bytes(os.path.join(root, _LATEST),
                       step_dir_name(step).encode())
    return {"directory": final, "bytes": total_bytes,
            "shards": len(shards), "step": int(step)}


def save_checkpoint(root, step, tree, fingerprint_extra=None,
                    retries=None, host_copied=False, sharded=False) -> dict:
    """Commit `tree` as `<root>/step_N/` atomically.  Transient OSErrors
    retry with exponential backoff (`FLAGS_ckpt_save_retries`); the
    result dict records directory/bytes/shards.  Array leaves may still
    live on device — they are host-copied here unless the caller already
    snapshotted them (`host_copied=True`, the AsyncCheckpointer path:
    a second full memcpy of a multi-GB state would double peak host
    memory for nothing). ``sharded=True`` waits for the distributed
    entry (:func:`host_copy`)."""
    from ..obs.watchdog import record_ckpt_save

    m = _metrics()
    if retries is None:
        retries = int(flag("FLAGS_ckpt_save_retries"))
    backoff = float(flag("FLAGS_ckpt_retry_backoff_s"))
    host = tree if host_copied else host_copy(tree, sharded=sharded)
    t0 = time.perf_counter()
    last_err = None
    for attempt in range(max(retries, 0) + 1):
        try:
            res = _save_once(root, step, host, fingerprint_extra)
            wall = time.perf_counter() - t0
            result = "ok" if attempt == 0 else "retry_ok"
            m["save_s"].observe(wall)
            m["saves"].labels(result).inc()
            m["bytes"].inc(res["bytes"])
            m["last_step"].set(int(step))
            record_ckpt_save(step=int(step), wall_s=wall,
                             nbytes=res["bytes"], result=result,
                             attempts=attempt + 1)
            res["wall_s"] = wall
            res["attempts"] = attempt + 1
            return res
        except OSError as e:
            last_err = e
            if attempt < retries:
                time.sleep(backoff * (2 ** attempt))
    wall = time.perf_counter() - t0
    m["save_s"].observe(wall)
    m["saves"].labels("error").inc()
    record_ckpt_save(step=int(step), wall_s=wall, nbytes=0,
                     result="error", attempts=retries + 1)
    raise CheckpointSaveError(
        f"checkpoint save of step {step} failed after {retries + 1} "
        f"attempt(s): {last_err!r}") from last_err


# -------------------------------------------------------------- inspect
def list_checkpoints(root) -> list:
    """Committed (manifest-bearing) step dirs, oldest first."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        mobj = _STEP_RE.match(name)
        if not mobj:
            continue
        if os.path.isfile(os.path.join(root, name, _MANIFEST)):
            out.append((int(mobj.group(1)), name))
    return [name for _, name in sorted(out)]


def latest_pointer(root):
    """Target dir name of the `latest` pointer, or None."""
    try:
        with open(os.path.join(root, _LATEST)) as f:
            name = f.read().strip()
        return name if _STEP_RE.match(name) else None
    except OSError:
        return None


def _read_manifest(path):
    """(manifest, None) or (None, reason) for one committed dir."""
    mpath = os.path.join(path, _MANIFEST)
    if not os.path.isfile(mpath):
        return None, "missing_manifest"
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except ValueError:
        return None, "torn_manifest"
    except OSError:
        return None, "io_error"
    if manifest.get("format") != _FORMAT:
        return None, "wrong_format"
    if not manifest.get("complete") or "tree" not in manifest \
            or "step" not in manifest:
        return None, "manifest_incomplete"
    return manifest, None


def _read_shard_verified(path, node):
    """(bytes, None) or (None, reason): one read, size + sha256 checked."""
    spath = os.path.join(path, node["file"])
    try:
        with open(spath, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return None, "missing_shard"
    except OSError:
        return None, "io_error"
    if len(data) != int(node["bytes"]):
        return None, "bad_shard_size"
    if hashlib.sha256(data).hexdigest() != node["sha256"]:
        return None, "checksum_mismatch"
    return data, None


def verify_checkpoint(path):
    """(ok, reason) for one committed dir.  Reasons are the named
    vocabulary restore fallbacks report: missing_manifest, torn_manifest,
    manifest_incomplete, wrong_format, missing_shard, checksum_mismatch,
    bad_shard_size, io_error."""
    manifest, reason = _read_manifest(path)
    if reason:
        return False, reason
    for node in _iter_shard_nodes(manifest["tree"]):
        _, reason = _read_shard_verified(path, node)
        if reason:
            return False, reason
    return True, None


def _load_verified(path):
    """(tree, manifest, None) or (None, None, reason): ONE pass that
    reads each shard once, verifies its size + sha256, and decodes —
    nothing is returned unless EVERY shard verified (restore for a
    multi-GB state must not pay verify-then-reread double IO)."""
    manifest, reason = _read_manifest(path)
    if reason:
        return None, None, reason
    arrays = {}
    for node in _iter_shard_nodes(manifest["tree"]):
        data, reason = _read_shard_verified(path, node)
        if reason:
            return None, None, reason
        arrays[node["file"]] = _from_bytes(data, node)
    try:
        tree = _decode_tree(manifest["tree"],
                            lambda node: arrays[node["file"]])
    except CheckpointError:
        # a structurally damaged tree — fall back like a torn one
        return None, None, "bad_shard_layout"
    return tree, manifest, None


@dataclass
class RestoreResult:
    tree: object
    step: int
    directory: str
    manifest: dict
    #: checkpoints rejected on the way here: [{"directory", "reason"}].
    #: Non-empty means the newest checkpoint was damaged and restore
    #: FELL BACK to an older good one.
    fallbacks: list = field(default_factory=list)


def restore_checkpoint(root, step=None) -> RestoreResult:
    """Load the newest checkpoint that verifies (or exactly `step` when
    given).  Every candidate is checksum-verified BEFORE any state is
    returned; damaged candidates are recorded in ``fallbacks`` with a
    named reason and the scan continues to the next-newest committed
    dir.  Raises :class:`CheckpointNotFoundError` when nothing under
    `root` verifies."""
    from .. import obs

    m = _metrics()
    log = obs.get_logger(__name__)
    t0 = time.perf_counter()

    committed = list_checkpoints(root)
    if step is not None:
        candidates = [step_dir_name(step)]
    else:
        # newest-first scan behind the pointer target.  `.trash.step_*`
        # dirs join the scan at their step number (a crash caught them
        # mid-replacement — the displaced copy of a published step must
        # outrank OLDER committed dirs, while gc-retired trash is always
        # older than the kept checkpoints so retention is unaffected);
        # at equal step a committed dir ranks above its trash copy
        ranked = [(int(_STEP_RE.match(n).group(1)), 1, n)
                  for n in committed]
        if os.path.isdir(root):
            for name in os.listdir(root):
                tm = re.match(r"^\.trash\.step_(\d+)\.", name)
                if tm and os.path.isfile(
                        os.path.join(root, name, _MANIFEST)):
                    ranked.append((int(tm.group(1)), 0, name))
        candidates = []
        ptr = latest_pointer(root)
        if ptr is not None:
            candidates.append(ptr)
        candidates += [n for _, _, n in sorted(ranked, reverse=True)
                       if n not in candidates]

    fallbacks = []
    for name in candidates:
        path = os.path.join(root, name)
        tree, manifest, reason = _load_verified(path)
        if reason:
            fallbacks.append({"directory": path, "reason": reason})
            log.warning(
                f"checkpoint {path} failed verification ({reason}); "
                "falling back to the previous good checkpoint",
                key=f"ckpt-fallback:{reason}")
            continue
        m["restore_s"].observe(time.perf_counter() - t0)
        m["restores"].labels("fallback" if fallbacks else "ok").inc()
        return RestoreResult(tree=tree, step=int(manifest["step"]),
                             directory=path, manifest=manifest,
                             fallbacks=fallbacks)
    m["restore_s"].observe(time.perf_counter() - t0)
    m["restores"].labels("error").inc()
    detail = "; ".join(f"{f['directory']}: {f['reason']}"
                       for f in fallbacks) or "no committed checkpoints"
    raise CheckpointNotFoundError(
        f"no restorable checkpoint under {root} ({detail})")


# ----------------------------------------------------------- retention
def _retire(path):
    """Delete a dir via rename-then-rmtree: the rename is atomic, so a
    concurrent reader either opened the whole committed dir (its fds
    stay valid) or sees no dir at all — never a half-deleted one."""
    trash = os.path.join(
        os.path.dirname(path),
        f".trash.{os.path.basename(path)}.{uuid.uuid4().hex[:8]}")
    os.rename(path, trash)
    shutil.rmtree(trash, ignore_errors=True)


def gc_checkpoints(root, keep_last_n=None) -> list:
    """Retention: keep only the newest `keep_last_n` committed
    checkpoints (default `FLAGS_ckpt_keep_last_n`; <=0 keeps all).
    Deletes strictly oldest-first, never the dir `latest` points to, and
    only fully-committed dirs (a half-written `.tmp.*` or a foreign dir
    is never touched).  Returns the deleted dir names."""
    if keep_last_n is None:
        keep_last_n = int(flag("FLAGS_ckpt_keep_last_n"))
    if keep_last_n is None or keep_last_n <= 0:
        return []
    committed = list_checkpoints(root)   # oldest first
    protected = latest_pointer(root)
    deletable = [n for n in committed if n != protected]
    keep_total = max(keep_last_n, 1)
    # how many of the deletable ones survive alongside the protected dir
    n_delete = len(committed) - keep_total
    deleted = []
    for name in deletable:
        if n_delete <= 0:
            break
        _retire(os.path.join(root, name))
        deleted.append(name)
        n_delete -= 1
    return deleted


def clean_debris(root) -> list:
    """Sweep `.tmp.*` / `.trash.*` leftovers from crashed or failed
    saves.  A `.trash.step_N.*` dir that VERIFIES and has no committed
    `step_N` sibling is a checkpoint a crash caught mid-replacement —
    it is RESCUED (renamed back) instead of deleted, so the
    previously-good state survives even that two-rename window.  Only
    called from points that own the root (AsyncCheckpointer startup) —
    never concurrently with another process's in-flight save."""
    removed = []
    if not os.path.isdir(root):
        return removed
    for name in os.listdir(root):
        path = os.path.join(root, name)
        if name.startswith(".trash."):
            m = re.match(r"^\.trash\.(step_\d+)\.", name)
            if m and not os.path.isdir(os.path.join(root, m.group(1))) \
                    and verify_checkpoint(path)[0]:
                os.rename(path, os.path.join(root, m.group(1)))
                continue
            shutil.rmtree(path, ignore_errors=True)
            removed.append(name)
        elif name.startswith(".tmp."):
            shutil.rmtree(path, ignore_errors=True)
            removed.append(name)
    return removed
