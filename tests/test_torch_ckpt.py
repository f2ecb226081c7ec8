"""The port's checkpoint core held to paddle_tpu's on the CPU.

The cases of tests/test_ckpt.py (the atomic core, every fault the
`faultinject` harness injects through the core's `_fire` points, the
async saver, retention, the save audit), run through both packages where
a case needs no model (parametrized "ref" / "port": the same operations
must give the same results), and through the port alone where it trains
its toy model. Besides: checkpoints written by either package restore in
the other, f32, int and bf16 leaves bit for bit (the port writes bf16 as
raw 2-byte patterns under the reference's dtype string, without
ml_dtypes), and the sharded leaves wait for the distributed entry.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import json
import os

import numpy as np
import pytest
import torch

import faultinject as fi
from paddle_tpu import ckpt as ref_ckpt
from paddle_tpu import obs as ref_obs
from paddle_tpu.ckpt import core as ref_core

import paddle_tpu_torch as pt
from paddle_tpu_torch import ckpt as port_ckpt
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import obs as port_obs
from paddle_tpu_torch.ckpt import core as port_core
from paddle_tpu_torch.io import DataLoader, Dataset

PKGS = {"ref": (ref_ckpt, ref_obs, ref_core),
        "port": (port_ckpt, port_obs, port_core)}


@pytest.fixture(params=["ref", "port"])
def pkg(request, monkeypatch):
    """(ckpt, obs) of one package, with the fault-injection harness
    pointed at that package's `_fire` seam."""
    ck, ob, core = PKGS[request.param]
    monkeypatch.setattr(fi, "ckpt_core", core)
    return ck, ob


@pytest.fixture
def port_fi(monkeypatch):
    monkeypatch.setattr(fi, "ckpt_core", port_core)


# --------------------------------------------------------------- helpers
class _ToyData(Dataset):
    def __init__(self, n=16):
        rs = np.random.RandomState(42)
        self.x = rs.randn(n, 8).astype("float32")
        self.y = rs.randn(n, 4).astype("float32")

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def _build(seed):
    """The port's toy model with dropout (torch's generator), AdamW on a
    stepped LR schedule and a SHUFFLED resumable loader (numpy RNG)."""
    pt.set_device("cpu")
    pt.seed(seed)
    np.random.seed(seed)
    model = pnn.Sequential(pnn.Linear(8, 16), pnn.ReLU(), pnn.Dropout(0.3),
                           pnn.Linear(16, 4))
    sched = pt.optimizer.lr.StepDecay(0.01, step_size=3, gamma=0.5)
    opt = pt.optimizer.AdamW(learning_rate=sched,
                             parameters=model.parameters())
    loader = port_ckpt.ResumableLoader(
        DataLoader(_ToyData(), batch_size=2, shuffle=True))
    return model, opt, sched, loader, pnn.MSELoss()


def _train(model, opt, sched, loader, loss_fn, n_steps, start_step=0):
    model.train()
    losses = []

    def stream():
        while True:
            yield from loader

    it = stream()
    for _ in range(start_step, n_steps):
        x, y = next(it)
        loss = loss_fn(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        losses.append(float(loss.numpy()))
    return losses


def _state_tree(model, opt, loader, step):
    return port_ckpt.capture_train_state(model, opt, step=step,
                                         data_state=loader.state_dict())


def _same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    else:
        assert a == b


# ----------------------------------------------------------- atomic core
def test_roundtrip_nested_tree(pkg, tmp_path):
    ck, _ = pkg
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": [np.ones(3, np.int64), (1, "x", None)],
            "c": {"d": 2.5, "e": np.zeros((0, 4), np.float32)}}
    res = ck.save_checkpoint(str(tmp_path), 5, tree)
    assert res["step"] == 5 and res["shards"] == 3
    r = ck.restore_checkpoint(str(tmp_path))
    assert r.step == 5 and not r.fallbacks
    _same(r.tree, tree)


def test_manifest_fields(pkg, tmp_path):
    ck, _ = pkg
    ck.save_checkpoint(str(tmp_path), 3, {"x": np.ones(2)})
    man = json.load(open(os.path.join(str(tmp_path), ck.step_dir_name(3),
                                      "manifest.json")))
    assert man["format"] == "paddle-tpu-ckpt" and man["version"] == 2
    assert man["complete"] is True and man["step"] == 3
    node = man["tree"]["items"]["x"]
    assert node["dtype"] == "float64" and node["shape"] == [2]
    assert len(node["sha256"]) == 64


def test_latest_pointer_tracks_newest(pkg, tmp_path):
    ck, _ = pkg
    for s in (1, 2, 7):
        ck.save_checkpoint(str(tmp_path), s, {"x": np.full(2, float(s))})
    assert ck.latest_pointer(str(tmp_path)) == ck.step_dir_name(7)
    assert ck.list_checkpoints(str(tmp_path)) == [
        ck.step_dir_name(s) for s in (1, 2, 7)]
    assert ck.restore_checkpoint(str(tmp_path), step=2).step == 2


def test_atomic_write_bytes_replace_and_no_debris(pkg, tmp_path):
    ck, _ = pkg
    p = os.path.join(str(tmp_path), "f.bin")
    ck.atomic_write_bytes(p, b"one")
    ck.atomic_write_bytes(p, b"two")
    assert open(p, "rb").read() == b"two"
    assert os.listdir(str(tmp_path)) == ["f.bin"]


def test_paddle_save_is_atomic(port_fi, tmp_path):
    """The port's `paddle.save` writes through the core's atomic write: a
    failed write leaves the previous file and no debris."""
    pt.set_device("cpu")
    p = os.path.join(str(tmp_path), "m.pdparams")
    pt.save({"w": pt.to_tensor(np.ones(3, "float32"))}, p)
    with fi.io_errors(1):
        with pytest.raises(OSError):
            pt.save({"w": pt.to_tensor(np.zeros(3, "float32"))}, p)
    np.testing.assert_array_equal(pt.load(p)["w"].numpy(), np.ones(3))
    assert os.listdir(str(tmp_path)) == ["m.pdparams"]


# ------------------------------------------------------- fault injection
def test_crash_after_every_shard(port_fi, tmp_path):
    """Crash-after-shard-K for ALL K of a real train state: the torn temp
    dir is never mistaken for a checkpoint."""
    root = str(tmp_path)
    model, opt, sched, loader, loss_fn = _build(0)
    _train(model, opt, sched, loader, loss_fn, 2)
    tree = _state_tree(model, opt, loader, 2)
    port_ckpt.save_checkpoint(root, 1, tree)
    n = json.load(open(os.path.join(
        root, port_ckpt.step_dir_name(1), "manifest.json")))["shard_count"]
    assert n >= 10
    for k in range(n):
        with fi.crash_after_shard(k):
            with pytest.raises(fi.InjectedCrash):
                port_ckpt.save_checkpoint(root, 2 + k, tree)
        r = port_ckpt.restore_checkpoint(root)
        assert r.step == 1 and not r.fallbacks
    assert port_ckpt.list_checkpoints(root) == [port_ckpt.step_dir_name(1)]
    assert len(port_ckpt.clean_debris(root)) == n
    assert port_ckpt.restore_checkpoint(root).step == 1


def test_crash_before_commit(pkg, tmp_path):
    ck, _ = pkg
    root = str(tmp_path)
    ck.save_checkpoint(root, 1, {"x": np.ones(2)})
    with fi.crash_before_commit():
        with pytest.raises(fi.InjectedCrash):
            ck.save_checkpoint(root, 2, {"x": np.zeros(2)})
    r = ck.restore_checkpoint(root)
    assert r.step == 1
    np.testing.assert_array_equal(r.tree["x"], np.ones(2))


def test_crash_before_latest_update(pkg, tmp_path):
    ck, _ = pkg
    root = str(tmp_path)
    ck.save_checkpoint(root, 1, {"x": np.ones(2)})
    with fi.crash_before_latest():
        with pytest.raises(fi.InjectedCrash):
            ck.save_checkpoint(root, 2, {"x": np.zeros(2)})
    assert ck.latest_pointer(root) == ck.step_dir_name(1)
    assert ck.restore_checkpoint(root).step == 1
    ck.save_checkpoint(root, 3, {"x": np.full(2, 3.0)})
    assert ck.restore_checkpoint(root).step == 3


def test_torn_manifest_falls_back(pkg, tmp_path):
    ck, _ = pkg
    root = str(tmp_path)
    ck.save_checkpoint(root, 1, {"x": np.ones(2)})
    with fi.torn_manifest():
        ck.save_checkpoint(root, 2, {"x": np.zeros(2)})
    r = ck.restore_checkpoint(root)
    assert r.step == 1 and r.fallbacks[0]["reason"] == "torn_manifest"


def test_bit_flip_falls_back_with_reason(pkg, tmp_path):
    ck, _ = pkg
    root = str(tmp_path)
    ck.save_checkpoint(root, 1, {"x": np.ones(4)})
    with fi.bit_flip_shard(0, byte_offset=2):
        ck.save_checkpoint(root, 2, {"x": np.zeros(4)})
    r = ck.restore_checkpoint(root)
    assert r.step == 1
    assert r.fallbacks == [{"directory": os.path.join(
        root, ck.step_dir_name(2)), "reason": "checksum_mismatch"}]


def test_missing_shard_falls_back(pkg, tmp_path):
    ck, _ = pkg
    root = str(tmp_path)
    ck.save_checkpoint(root, 1, {"x": np.ones(4)})
    ck.save_checkpoint(root, 2, {"x": np.zeros(4)})
    os.unlink(os.path.join(root, ck.step_dir_name(2), "shard_00000.bin"))
    r = ck.restore_checkpoint(root)
    assert r.step == 1 and r.fallbacks[0]["reason"] == "missing_shard"


def test_all_candidates_damaged_is_named_error(pkg, tmp_path):
    ck, _ = pkg
    with fi.torn_manifest():
        ck.save_checkpoint(str(tmp_path), 1, {"x": np.ones(2)})
    with pytest.raises(ck.CheckpointNotFoundError, match="torn_manifest"):
        ck.restore_checkpoint(str(tmp_path))


def test_io_error_retries_to_success(pkg, tmp_path):
    ck, _ = pkg
    with fi.io_errors(2):
        res = ck.save_checkpoint(str(tmp_path), 1, {"x": np.ones(2)})
    assert res["attempts"] == 3
    assert ck.restore_checkpoint(str(tmp_path)).step == 1


def test_io_error_exhausts_retries_loudly(pkg, tmp_path):
    ck, _ = pkg
    with fi.io_errors(10 ** 6):
        with pytest.raises(ck.CheckpointSaveError,
                           match="injected IO error"):
            ck.save_checkpoint(str(tmp_path), 1, {"x": np.ones(2)},
                               retries=2)


# ------------------------------------------------------------ async saver
def test_overlap_snapshot_isolation(port_fi, tmp_path):
    """The next steps run while the commit is in flight; the committed
    bytes are the values at save() time and the training result is
    unchanged by the overlap."""
    root = str(tmp_path)
    model, opt, sched, loader, loss_fn = _build(0)
    w0 = model.state_dict()["0.weight"].numpy().copy()
    saver = port_ckpt.AsyncCheckpointer(root)
    with fi.slow_io(0.01):
        saver.save(1, _state_tree(model, opt, loader, 1))
        overlapped = _train(model, opt, sched, loader, loss_fn, 3)
        saver.wait()
    r = port_ckpt.restore_checkpoint(root)
    np.testing.assert_array_equal(r.tree["model"]["0.weight"], w0)
    assert not np.array_equal(model.state_dict()["0.weight"].numpy(), w0)
    assert _train(*_build(0), 3) == overlapped


def test_async_error_surfaces_on_wait(pkg, tmp_path):
    ck, _ = pkg
    saver = ck.AsyncCheckpointer(str(tmp_path))
    with fi.io_errors(10 ** 6):
        saver.save(1, {"x": np.ones(2)})
        with pytest.raises(ck.CheckpointSaveError):
            saver.wait()


def test_async_error_surfaces_on_next_save(pkg, tmp_path):
    ck, _ = pkg
    saver = ck.AsyncCheckpointer(str(tmp_path))
    with fi.io_errors(10 ** 6):
        saver.save(1, {"x": np.ones(2)})
        saver._q.join()
    with pytest.raises(ck.CheckpointSaveError):
        saver.save(2, {"x": np.ones(2)})
    saver.save(3, {"x": np.ones(2)})
    saver.wait()
    assert ck.restore_checkpoint(str(tmp_path)).step == 3


def test_abort_drops_queued_tail(pkg, tmp_path):
    ck, _ = pkg
    root = str(tmp_path)
    saver = ck.AsyncCheckpointer(root, max_in_flight=4)
    with fi.slow_io(0.02):
        for s in (1, 2, 3):
            saver.save(s, {"x": np.full(2, float(s))})
        saver.abort()
    assert len(ck.list_checkpoints(root)) < 3
    saver.save(9, {"x": np.ones(2)}, block=True)
    assert ck.restore_checkpoint(root).step == 9


def test_retention_runs_after_async_saves(pkg, tmp_path):
    ck, _ = pkg
    root = str(tmp_path)
    saver = ck.AsyncCheckpointer(root, keep_last_n=2)
    for s in range(1, 6):
        saver.save(s, {"x": np.full(2, float(s))})
    saver.wait()
    saver.close()
    assert ck.list_checkpoints(root) == [ck.step_dir_name(4),
                                         ck.step_dir_name(5)]


def test_blocking_save_drains_inflight_async_saves(pkg, tmp_path):
    ck, _ = pkg
    root = str(tmp_path)
    saver = ck.AsyncCheckpointer(root, max_in_flight=4)
    with fi.slow_io(0.02):
        saver.save(5, {"x": np.full(2, 5.0)})
        saver.save(6, {"x": np.full(2, 6.0)}, block=True)
    assert ck.latest_pointer(root) == ck.step_dir_name(6)
    saver.close()


def test_resave_same_step_never_destroys_good_state(pkg, tmp_path):
    ck, _ = pkg
    root = str(tmp_path)
    ck.save_checkpoint(root, 1, {"x": np.ones(2)})
    ck.save_checkpoint(root, 1, {"x": np.full(2, 2.0)})
    ck.save_checkpoint(root, 0, {"x": np.zeros(2)})
    ck.atomic_write_bytes(os.path.join(root, "latest"),
                          ck.step_dir_name(1).encode())
    os.rename(os.path.join(root, ck.step_dir_name(1)),
              os.path.join(root, ".trash.step_00000001.dead1"))
    r = ck.restore_checkpoint(root)
    assert r.step == 1
    np.testing.assert_array_equal(r.tree["x"], np.full(2, 2.0))
    assert ck.clean_debris(root) == []
    assert ck.list_checkpoints(root) == [ck.step_dir_name(0),
                                         ck.step_dir_name(1)]


def test_host_copy_copies_live_tensors():
    live = np.ones(4, np.float32)
    t = torch.ones(3)
    b = torch.ones(2, dtype=torch.bfloat16)
    snap = port_ckpt.host_copy({"a": live, "t": [t], "b": b})
    live[:] = 7.0
    t.fill_(7.0)
    b.fill_(7.0)
    np.testing.assert_array_equal(snap["a"], np.ones(4))
    np.testing.assert_array_equal(snap["t"][0], np.ones(3))
    assert isinstance(snap["b"], torch.Tensor) and snap["b"].dtype == \
        torch.bfloat16 and torch.equal(snap["b"], torch.ones(2).bfloat16())


# -------------------------------------------------------------- retention
def test_gc_never_deletes_latest_target(pkg, tmp_path):
    ck, _ = pkg
    root = str(tmp_path)
    for s in (1, 2, 3, 4):
        ck.save_checkpoint(root, s, {"x": np.ones(2)})
    ck.atomic_write_bytes(os.path.join(root, "latest"),
                          ck.step_dir_name(2).encode())
    assert ck.gc_checkpoints(root, keep_last_n=2) == [
        ck.step_dir_name(1), ck.step_dir_name(3)]


def test_gc_only_touches_committed_dirs(pkg, tmp_path):
    ck, _ = pkg
    root = str(tmp_path)
    for s in (1, 2, 3):
        ck.save_checkpoint(root, s, {"x": np.ones(2)})
    os.makedirs(os.path.join(root, "step_00000009"))
    os.makedirs(os.path.join(root, ".tmp.step_00000007.dead"))
    ck.gc_checkpoints(root, keep_last_n=1)
    left = sorted(os.listdir(root))
    assert "step_00000009" in left and ".tmp.step_00000007.dead" in left
    assert ck.list_checkpoints(root) == [ck.step_dir_name(3)]


def test_gc_zero_keeps_all(pkg, tmp_path):
    ck, _ = pkg
    for s in (1, 2, 3):
        ck.save_checkpoint(str(tmp_path), s, {"x": np.ones(2)})
    assert ck.gc_checkpoints(str(tmp_path), keep_last_n=0) == []


# ------------------------------------------------------ across packages
def _leaves():
    rs = np.random.RandomState(3)
    f32 = rs.randn(5, 7).astype(np.float32)
    bf = torch.from_numpy(rs.randn(4, 6).astype(np.float32)).bfloat16()
    return f32, rs.randint(0, 9, (3,)).astype(np.int64), bf


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_checkpoint_restores_in_the_other_package(writer, tmp_path):
    """Either package's checkpoint restores in the other: f32 and int
    leaves equal, bf16 leaves bit for bit (the 2-byte patterns)."""
    import jax.numpy as jnp

    f32, i64, bf = _leaves()
    bits = bf.view(torch.int16).numpy()
    root = str(tmp_path)
    if writer == "ref":
        ref_ckpt.save_checkpoint(root, 4, {
            "f": f32, "i": i64, "b": np.asarray(jnp.asarray(bf.float()
                                                           .numpy(),
                                                           jnp.bfloat16))})
        r = port_ckpt.restore_checkpoint(root)
        assert r.tree["b"].dtype == torch.bfloat16
        got_bits = r.tree["b"].view(torch.int16).numpy()
    else:
        port_ckpt.save_checkpoint(root, 4, {"f": f32, "i": i64, "b": bf})
        r = ref_ckpt.restore_checkpoint(root)
        assert str(r.tree["b"].dtype) == "bfloat16"
        got_bits = r.tree["b"].view(np.int16)
    assert r.step == 4 and not r.fallbacks
    np.testing.assert_array_equal(r.tree["f"], f32)
    np.testing.assert_array_equal(r.tree["i"], i64)
    np.testing.assert_array_equal(got_bits, bits)


def test_sharded_leaves_wait_for_the_distributed_entry(tmp_path):
    with pytest.raises(NotImplementedError, match="Distributed"):
        port_ckpt.ShardedLeaf((2,), "float32", {}, [], [])
    with pytest.raises(NotImplementedError, match="Distributed"):
        port_ckpt.host_copy({"x": np.ones(2)}, sharded=True)
    with pytest.raises(NotImplementedError, match="Distributed"):
        port_ckpt.manifest_shardings({"tree": {"t": "dict", "items": {}}})


def test_public_names_are_the_reference():
    assert sorted(port_ckpt.__all__) == sorted(ref_ckpt.__all__)
    for name in port_ckpt.__all__:
        assert hasattr(port_ckpt, name), name


# ------------------------------------------------------------- watchdog
def _findings(fs):
    return [f.to_dict() for f in fs]


@pytest.mark.parametrize("case", ["ok", "stalled", "failed"])
def test_ckpt_stall_audit_equals_reference(case):
    evs = [{"step": 1, "wall_s": 0.2, "bytes": 10, "result": "ok",
            "attempts": 1}]
    if case == "stalled":
        evs.append({"step": 2, "wall_s": 5.0, "bytes": 10, "result": "ok",
                    "attempts": 1})
    if case == "failed":
        evs.append({"step": 2, "wall_s": 0.1, "bytes": 0,
                    "result": "error", "attempts": 4})
    got = _findings(port_obs.audit_ckpt_stalls(evs, threshold=1.0))
    assert got == _findings(ref_obs.audit_ckpt_stalls(evs, threshold=1.0))
    sev = {f["severity"] for f in got}
    assert sev == ({"note"} if case == "ok" else {"warning"})


def test_saves_record_events_and_metrics(pkg, tmp_path):
    ck, ob = pkg
    ob.clear_events()
    ck.save_checkpoint(str(tmp_path), 1, {"x": np.ones(2)})
    evs = ob.ckpt_save_events()
    assert evs and evs[-1]["result"] == "ok" and evs[-1]["step"] == 1
    snap = ob.default_registry().to_dict()
    for name in ("ckpt_save_seconds", "ckpt_saves_total",
                 "ckpt_bytes_written_total", "ckpt_last_step"):
        assert name in snap, name


def test_stalled_save_dumps_the_training_flight_ring(tmp_path):
    from paddle_tpu_torch.core.flags import flag, set_flags
    from paddle_tpu_torch.obs import train_flight

    old = {k: flag(k) for k in ("FLAGS_ckpt_stall_seconds",
                                "FLAGS_obs_flight_dir")}
    rec = port_obs.TrainFlightRecorder(registry=port_obs.Registry())
    prev = train_flight.set_current(rec)
    set_flags({"FLAGS_ckpt_stall_seconds": 0.0,
               "FLAGS_obs_flight_dir": str(tmp_path / "dumps")})
    try:
        rec.step_begin(0, 0, 1.5, 1.5)        # no data wait
        rec.step_end(2.0, 0.5)
        port_obs.record_ckpt_save(1, 0.01, 10, "ok")
    finally:
        set_flags(old)
        train_flight.set_current(prev)
    assert rec.autodumps == 1
    assert "ckpt_stall" in rec.autodump_paths[0]
    assert port_obs.validate_trace(rec.autodump_paths[0])["steps"] == 1
