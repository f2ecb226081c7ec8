"""The port's `geometric` and `text.viterbi` held to paddle_tpu's on the
CPU (ROADMAP.md Queue 1 item 1f).

Message passing and segment reductions on the same seeded inputs:
values within 1e-6 of the largest |value| (f32 sums in another order),
gradients against the reference's tape, ties of max / min included (the
gradient split evenly among tied messages, as jnp's scatter-max);
`reindex_graph` / `reindex_heter_graph` exactly the reference's. The
samplers draw from the port's generator, the reference's from its jax
key, so their draws differ by design (ROADMAP.md Queue 3): they are held
to invariants (real neighbours, at most `sample_size`, no duplicates,
the same draw under the same seed). `viterbi_decode` / `ViterbiDecoder`
against the reference and the reference's brute-force cases
(tests/test_text_datasets.py).
"""
import itertools

import numpy as np
import pytest

import paddle_tpu as paddle

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import device as port_device

REDUCE = ["sum", "mean", "max", "min"]
MESSAGE = ["add", "sub", "mul", "div"]


@pytest.fixture(autouse=True, scope="module")
def _setup():
    prev = port_device._current
    pt.set_device("cpu")
    old = paddle.get_flags(["FLAGS_eager_defer_vjp"])
    paddle.set_flags({"FLAGS_eager_defer_vjp": False})
    yield
    paddle.set_flags(old)
    port_device._current = prev


def _np(t):
    return np.asarray(t._data) if isinstance(t, paddle.Tensor) \
        else t.numpy()


def _close(got, want, tol=1e-6):
    assert str(got.dtype) == str(want.dtype)
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _graph(seed=0, ties=False):
    rs = np.random.RandomState(seed)
    x = rs.randn(6, 3).astype("float32")
    e = rs.randn(9, 3).astype("float32") + 2.0
    if ties:
        x = np.round(x).astype("float32")      # many equal messages
        e = np.round(e).astype("float32")
    src = rs.randint(0, 6, 9).astype("int64")
    dst = np.array([0, 0, 1, 1, 1, 3, 3, 4, 0], "int64")
    return x, e, src, dst


def _run(pkg, fn, floats, ints):
    """(output, gradients of the float inputs) of fn on pkg's Tensors."""
    ts = [pkg.to_tensor(a, stop_gradient=False) for a in floats]
    out = fn(pkg, *ts, *[pkg.to_tensor(a) for a in ints])
    (out * out).sum().backward()
    return out, [t.grad for t in ts]


def _both(fn, floats, ints):
    (po, pg), (ro, rg) = (_run(pkg, fn, floats, ints) for pkg in (pt,
                                                                   paddle))
    _close(po, ro)
    for a, b in zip(pg, rg):
        _close(a, b)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("reduce_op", REDUCE)
@pytest.mark.parametrize("out_size", [None, 8])
def test_send_u_recv(reduce_op, out_size, ties):
    x, _, src, dst = _graph(1, ties)
    _both(lambda pkg, t, s, d: pkg.geometric.send_u_recv(
        t, s, d, reduce_op=reduce_op, out_size=out_size), [x], [src, dst])


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("message_op,reduce_op",
                         list(itertools.product(MESSAGE, REDUCE)))
def test_send_ue_recv(message_op, reduce_op, ties):
    x, e, src, dst = _graph(2, ties)
    _both(lambda pkg, t, y, s, d: pkg.geometric.send_ue_recv(
        t, y, s, d, message_op=message_op, reduce_op=reduce_op),
        [x, e], [src, dst])


@pytest.mark.parametrize("message_op", MESSAGE)
def test_send_uv(message_op):
    x, _, src, dst = _graph(3)
    y = np.random.RandomState(4).rand(6, 3).astype("float32") + 0.5
    _both(lambda pkg, t, u, s, d: pkg.geometric.send_uv(
        t, u, s, d, message_op=message_op), [x, y], [src, dst])


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("pool", REDUCE)
def test_segment_reductions(pool, ties):
    rs = np.random.RandomState(5)
    data = rs.randn(7, 3).astype("float32")
    if ties:
        data = np.round(data).astype("float32")
    ids = np.array([0, 0, 1, 1, 1, 3, 3], "int64")    # segment 2 empty
    _both(lambda pkg, t, i: getattr(pkg.geometric, f"segment_{pool}")(t, i),
          [data], [ids])
    # the incubate aliases are the same functions
    assert getattr(pt.incubate, f"segment_{pool}") is \
        getattr(pt.geometric, f"segment_{pool}")


def test_refusals():
    x = pt.to_tensor(np.ones((2, 2), "float32"))
    i = pt.to_tensor(np.array([0, 1], "int64"))
    for pkg, t, j in ((pt, x, i), (paddle, paddle.to_tensor(x.numpy()),
                                   paddle.to_tensor(i.numpy()))):
        with pytest.raises(ValueError):
            pkg.geometric.send_u_recv(t, j, j, reduce_op="prod")
        with pytest.raises(ValueError):
            pkg.geometric.send_uv(t, t, j, j, message_op="pow")


def test_reference_geometric_cases_on_the_port():
    """tests/test_fft_signal_geometric.py TestGeometric's numpy checks."""
    x = pt.to_tensor(np.array([[0, 2, 3], [1, 4, 5], [2, 6, 7]],
                              dtype="float32"))
    src = pt.to_tensor(np.array([0, 1, 2, 0], dtype="int64"))
    dst = pt.to_tensor(np.array([1, 2, 1, 0], dtype="int64"))
    out = pt.geometric.send_u_recv(x, src, dst, reduce_op="sum")
    np.testing.assert_allclose(out.numpy(), [[0, 2, 3], [2, 8, 10],
                                             [1, 4, 5]])
    x = pt.to_tensor(np.ones((3, 2), dtype="float32"), stop_gradient=False)
    pt.geometric.send_u_recv(x, pt.to_tensor(np.array([0, 1, 2])),
                             pt.to_tensor(np.array([1, 1, 0]))).sum() \
        .backward()
    np.testing.assert_allclose(x.grad.numpy(), np.ones((3, 2)))


def test_reindex_graph_equals_reference():
    x = np.array([0, 5, 9], dtype="int64")
    nbr = np.array([8, 9, 0, 4, 7, 6, 7], dtype="int64")
    cnt = np.array([2, 3, 2], dtype="int32")
    got = pt.geometric.reindex_graph(*map(pt.to_tensor, (x, nbr, cnt)))
    want = paddle.geometric.reindex_graph(*map(paddle.to_tensor,
                                               (x, nbr, cnt)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), _np(b))
    assert all(str(a.dtype) == "int64" for a in got)
    assert pt.incubate.graph_reindex is pt.geometric.reindex_graph


def test_reindex_heter_graph_equals_reference():
    x = np.array([0, 5, 9], dtype="int64")
    nbrs = [np.array([8, 9, 0, 4, 7], "int64"), np.array([0, 5, 3], "int64")]
    cnts = [np.array([2, 2, 1], "int32"), np.array([1, 1, 1], "int32")]
    got = pt.geometric.reindex_heter_graph(
        pt.to_tensor(x), [pt.to_tensor(n) for n in nbrs],
        [pt.to_tensor(c) for c in cnts])
    want = paddle.geometric.reindex_heter_graph(
        paddle.to_tensor(x), [paddle.to_tensor(n) for n in nbrs],
        [paddle.to_tensor(c) for c in cnts])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), _np(b))


#: CSC: node v's neighbours are row[colptr[v]:colptr[v + 1]]
ROW = np.array([1, 2, 3, 4, 0, 0, 2, 3, 4, 5, 1, 0], "int64")
COLPTR = np.array([0, 4, 5, 10, 11, 12, 12], "int64")
EIDS = np.arange(100, 112, dtype="int64")


def _neighbours(v):
    return set(ROW[COLPTR[v]:COLPTR[v + 1]].tolist())


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("size", [-1, 1, 2, 3])
def test_samplers_draw_real_neighbours(weighted, size):
    """Every neighbour real, at most `size` a node (all of them at -1 or
    for a node with fewer), none twice, the edge ids those of the drawn
    edges; the same seed gives the same draw."""
    nodes = np.array([0, 2, 3, 5, 1], "int64")

    def draw():
        args = [pt.to_tensor(ROW), pt.to_tensor(COLPTR)]
        if weighted:
            args.append(pt.to_tensor(np.linspace(0.5, 2.0, 12)
                                     .astype("float32")))
        fn = pt.geometric.weighted_sample_neighbors if weighted \
            else pt.geometric.sample_neighbors
        return fn(*args, pt.to_tensor(nodes), sample_size=size,
                  eids=pt.to_tensor(EIDS), return_eids=True)

    pt.seed(11)
    nbr, cnt, eid = (t.numpy() for t in draw())
    pt.seed(11)
    again = [t.numpy() for t in draw()]
    np.testing.assert_array_equal(again[0], nbr)
    np.testing.assert_array_equal(again[2], eid)
    start = 0
    for v, c in zip(nodes, cnt):
        deg = len(_neighbours(v))
        assert c == (deg if size < 0 else min(size, deg))
        picked = nbr[start:start + c]
        assert set(picked.tolist()) <= _neighbours(v)
        assert len(set(picked.tolist())) == c
        for n, e in zip(picked, eid[start:start + c]):
            assert ROW[e - 100] == n and COLPTR[v] <= e - 100 < COLPTR[v + 1]
        start += c
    assert start == len(nbr) and str(draw()[0].dtype) == "int64"


def test_weighted_sampler_skips_zero_weights_and_refuses_none():
    """The reference's case: only the nonzero-weight edge is drawn; all
    weights zero raises, as there."""
    row = np.array([1, 2, 0], dtype="int64")
    colptr = np.array([0, 3, 3, 3], dtype="int64")
    for pkg in (pt, paddle):
        nbr, _ = pkg.geometric.weighted_sample_neighbors(
            pkg.to_tensor(row), pkg.to_tensor(colptr),
            pkg.to_tensor(np.array([0.0, 0.0, 1.0], "float32")),
            pkg.to_tensor(np.array([0], "int64")), sample_size=1)
        assert _np(nbr).tolist() == [0]
        with pytest.raises(ValueError, match="non-positive"):
            pkg.geometric.weighted_sample_neighbors(
                pkg.to_tensor(row), pkg.to_tensor(colptr),
                pkg.to_tensor(np.zeros(3, "float32")),
                pkg.to_tensor(np.array([0], "int64")), sample_size=1)


def test_khop_sampler_invariants():
    """graph_khop_sampler: each hop's edges real, hop k expanding the new
    nodes of hop k - 1; every node seen once in the sorted node list;
    return_eids refuses, as the reference's."""
    pt.seed(3)
    src, dst, nodes, counts = pt.incubate.graph_khop_sampler(
        pt.to_tensor(ROW), pt.to_tensor(COLPTR),
        pt.to_tensor(np.array([0], "int64")), [2, 2])
    src, dst, nodes = src.numpy(), dst.numpy(), nodes.numpy()
    for s, d in zip(src, dst):
        assert s in _neighbours(d)
    assert counts[0].numpy().tolist() == [2]
    assert list(nodes) == sorted(set(nodes.tolist()))
    assert set(src.tolist()) | {0} <= set(nodes.tolist())
    with pytest.raises(NotImplementedError):
        pt.incubate.graph_khop_sampler(
            pt.to_tensor(ROW), pt.to_tensor(COLPTR),
            pt.to_tensor(np.array([0], "int64")), [2], return_eids=True)
    assert pt.incubate.graph_sample_neighbors is \
        pt.geometric.sample_neighbors
    assert pt.incubate.graph_send_recv is pt.geometric.send_u_recv


# ----------------------------------------------------------------- viterbi
@pytest.mark.parametrize("bos_eos", [True, False])
@pytest.mark.parametrize("lens", [[5, 5, 5], [5, 2, 1]])
def test_viterbi_matches_reference(bos_eos, lens):
    rs = np.random.RandomState(6)
    emit = rs.randn(3, 5, 4).astype("float32")
    trans = rs.randn(4, 4).astype("float32")
    lens = np.array(lens, "int64")
    got = pt.text.viterbi_decode(pt.to_tensor(emit), pt.to_tensor(trans),
                                 pt.to_tensor(lens), bos_eos)
    want = paddle.text.viterbi_decode(paddle.to_tensor(emit),
                                      paddle.to_tensor(trans),
                                      paddle.to_tensor(lens), bos_eos)
    _close(got[0], want[0])
    np.testing.assert_array_equal(_np(got[1]), _np(want[1]))
    assert str(got[1].dtype) == "int64"


def test_viterbi_ties_pick_the_lowest_tag():
    emit = np.zeros((1, 4, 3), "float32")
    trans = np.zeros((3, 3), "float32")
    got = pt.text.viterbi_decode(pt.to_tensor(emit), pt.to_tensor(trans),
                                 pt.to_tensor(np.array([4])), False)
    want = paddle.text.viterbi_decode(
        paddle.to_tensor(emit), paddle.to_tensor(trans),
        paddle.to_tensor(np.array([4])), False)
    np.testing.assert_array_equal(_np(got[1]), _np(want[1]))


def _brute(emit, trans, t, start=None, stop=None):
    n = emit.shape[1]
    best, path = -1e30, None
    for p in itertools.product(range(n), repeat=t):
        s = emit[0, p[0]] + (start[p[0]] if start is not None else 0)
        for i in range(1, t):
            s += trans[p[i - 1], p[i]] + emit[i, p[i]]
        if stop is not None:
            s += stop[p[-1]]
        if s > best:
            best, path = s, list(p)
    return best, path


def test_reference_viterbi_cases_on_the_port():
    """tests/test_text_datasets.py's brute-force, BOS/EOS and layer
    cases, on the port."""
    rs = np.random.RandomState(0)
    emit = rs.randn(2, 4, 3).astype("float32")
    trans = rs.randn(3, 3).astype("float32")
    scores, paths = pt.text.viterbi_decode(
        pt.to_tensor(emit), pt.to_tensor(trans),
        pt.to_tensor(np.array([4, 4], "int64")), include_bos_eos_tag=False)
    for b in range(2):
        want_s, want_p = _brute(emit[b], trans, 4)
        np.testing.assert_allclose(float(scores.numpy()[b]), want_s,
                                   rtol=1e-4)
        assert paths.numpy()[b].tolist() == want_p
    rs = np.random.RandomState(1)
    emit = rs.randn(1, 3, 5).astype("float32")
    emit[:, :, 3:] = -1e4
    trans = rs.randn(5, 5).astype("float32")
    scores, paths = pt.text.viterbi_decode(
        pt.to_tensor(emit), pt.to_tensor(trans),
        pt.to_tensor(np.array([3], "int64")), include_bos_eos_tag=True)
    want_s, want_p = _brute(emit[0], trans, 3, start=trans[4], stop=trans[3])
    np.testing.assert_allclose(float(scores.numpy()[0]), want_s, rtol=1e-4)
    assert paths.numpy()[0].tolist() == want_p
    rs = np.random.RandomState(2)
    emit = rs.randn(2, 5, 4).astype("float32")
    trans = rs.randn(4, 4).astype("float32")
    dec = pt.text.ViterbiDecoder(pt.to_tensor(trans),
                                 include_bos_eos_tag=False)
    assert isinstance(dec, pt.nn.Layer)
    _, paths = dec(pt.to_tensor(emit), pt.to_tensor(np.array([5, 3])))
    assert paths.shape == [2, 5]
    _, p2 = pt.text.viterbi_decode(
        pt.to_tensor(emit[1:2, :3]), pt.to_tensor(trans),
        pt.to_tensor(np.array([3])), include_bos_eos_tag=False)
    assert paths.numpy()[1, :3].tolist() == p2.numpy()[0].tolist()


def test_viterbi_score_gradients_match_the_reference_tape():
    """The reference differentiates the scores in the potentials and the
    transitions; the port's gradients equal its tape's."""
    rs = np.random.RandomState(8)
    emit = rs.randn(2, 5, 4).astype("float32")
    trans = rs.randn(4, 4).astype("float32")
    grads = []
    for pkg in (pt, paddle):
        e = pkg.to_tensor(emit, stop_gradient=False)
        t = pkg.to_tensor(trans, stop_gradient=False)
        s, _ = pkg.text.viterbi_decode(e, t, pkg.to_tensor(
            np.array([5, 3], "int64")), False)
        s.sum().backward()
        grads.append((e.grad, t.grad))
    for a, b in zip(*grads):
        _close(a, b)
