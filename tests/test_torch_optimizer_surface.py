"""The port's optimizer surface against paddle_tpu's, on the CPU.

The same seeded parameters and gradients (numpy) go through
`paddle_tpu` and `paddle_tpu_torch`:

  * every learning-rate scheduler's value over 30 steps, equal (the same
    Python formulas), with a state_dict round trip midway; ReduceOnPlateau
    fed the same metrics; an AdamW driven by a scheduler, bit-identical;
  * each clip class and function: f32 within 1e-6 relative (the norm's
    sum runs in another order), bf16 within one bf16 ulp (2^-7 relative:
    a scale one f32 ulp apart can round g * scale the other way);
  * Adam / AdamW per parameter, with and without amsgrad, coupled and
    decoupled L2 (a float and `L2Decay`), L1, parameter groups, bf16
    moments and f32 master weights: bit-identical;
  * the fused path (`use_multi_tensor=True`) against the reference's fused
    path within the reference's own fused-vs-per-parameter bounds
    (tests/test_optimizer.py: rtol 1e-6 / atol 1e-7 in f32, 1e-2 / 1e-3
    for bf16 with master weights), with and without global-norm clipping,
    and against the port's per-parameter path, bit-identical;
  * every other optimizer over 4 steps in f32 within rtol 1e-5 / atol
    1e-6 (the same ops; sums and powers from other libraries), LBFGS
    within 1e-4 after its closure-driven iterations.

On the CPU the port's Adam, AdamW and Momentum run the kernel's plain
version (`ops.fused_optimizer.fused_adam_reference`,
`fused_momentum_reference`); tests/test_torch_cuda_kernels.py holds the
kernel to it on the card, bit for bit.
"""
import _torch_threads  # noqa: F401,I001  (torch threads per worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer.lr as plr
from paddle_tpu.core.tensor import Parameter, Tensor

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.ops import _cuda_common, fused_optimizer
from paddle_tpu_torch.optimizer import fused as tfused
from paddle_tpu_torch.optimizer import lr as tlr

SHAPES = [(8, 16), (16,), (5, 3, 4), (7,)]
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x._data.astype(jnp.float32))


# ----------------------------------------------------------- schedulers

SCHEDULERS = {
    "noam": lambda m: m.NoamDecay(d_model=64, warmup_steps=10,
                                  learning_rate=1.0),
    "piecewise": lambda m: m.PiecewiseDecay([5, 12, 20],
                                            [0.1, 0.05, 0.01, 0.001]),
    "natural_exp": lambda m: m.NaturalExpDecay(0.5, gamma=0.1),
    "inverse_time": lambda m: m.InverseTimeDecay(0.5, gamma=0.2),
    "polynomial": lambda m: m.PolynomialDecay(0.5, decay_steps=12,
                                              end_lr=0.01, power=2.0),
    "polynomial_cycle": lambda m: m.PolynomialDecay(
        0.5, decay_steps=7, end_lr=0.01, cycle=True),
    "linear_warmup": lambda m: m.LinearWarmup(0.5, warmup_steps=8,
                                              start_lr=0.0, end_lr=0.5),
    "linear_warmup_cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.5, T_max=12), warmup_steps=5,
        start_lr=0.01, end_lr=0.5),
    "exponential": lambda m: m.ExponentialDecay(0.5, gamma=0.9),
    "multistep": lambda m: m.MultiStepDecay(0.5, milestones=[4, 9, 20],
                                            gamma=0.5),
    "step": lambda m: m.StepDecay(0.5, step_size=7, gamma=0.3),
    "lambda": lambda m: m.LambdaDecay(0.5, lambda e: 0.95 ** e),
    "multiplicative": lambda m: m.MultiplicativeDecay(0.5, lambda e: 0.9),
    "cosine": lambda m: m.CosineAnnealingDecay(0.5, T_max=10, eta_min=0.01),
    "cosine_restarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.5, T_0=5, T_mult=2, eta_min=0.01),
    "one_cycle": lambda m: m.OneCycleLR(1.0, total_steps=30),
    "one_cycle_3phase_linear": lambda m: m.OneCycleLR(
        1.0, total_steps=30, three_phase=True, anneal_strategy="linear"),
    "cyclic_triangular2": lambda m: m.CyclicLR(
        0.1, 1.0, step_size_up=4, step_size_down=6, mode="triangular2"),
    "cyclic_exp_range": lambda m: m.CyclicLR(
        0.1, 1.0, step_size_up=5, mode="exp_range", exp_gamma=0.97),
    "cyclic_scale_fn": lambda m: m.CyclicLR(
        0.1, 1.0, step_size_up=3, scale_fn=lambda x: 1 / (1 + x),
        scale_mode="iterations"),
    "linear_lr": lambda m: m.LinearLR(0.5, total_steps=12,
                                      start_factor=0.25),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_values_and_state_dict(name):
    ref, port = SCHEDULERS[name](plr), SCHEDULERS[name](tlr)
    want, got = [ref()], [port()]
    for i in range(30):
        if i == 12:    # a fresh port scheduler picks up from the state
            sd = port.state_dict()
            port = SCHEDULERS[name](tlr)
            port.set_state_dict(sd)
        ref.step()
        port.step()
        want.append(ref())
        got.append(port())
    assert got == want


@pytest.mark.parametrize("kw", [
    dict(mode="min", factor=0.5, patience=2, cooldown=1),
    dict(mode="max", factor=0.3, patience=1, threshold=0.05,
         threshold_mode="abs", min_lr=0.02)], ids=["min-rel", "max-abs"])
def test_reduce_on_plateau_follows_the_metrics(kw):
    metrics = np.random.RandomState(5).rand(30).round(3)
    ref, port = plr.ReduceOnPlateau(0.5, **kw), tlr.ReduceOnPlateau(0.5,
                                                                     **kw)
    for i, v in enumerate(metrics):
        ref.step(float(v))
        port.step(torch.tensor(float(v)) if i % 2 else float(v))
        assert port() == ref() and port.num_bad_epochs == ref.num_bad_epochs
    fresh = tlr.ReduceOnPlateau(0.5, **kw)
    fresh.set_state_dict(port.state_dict())
    assert fresh() == port() and fresh.best == port.best


# ----------------------------------------------------------------- data

def _data(steps):
    rs = np.random.RandomState(0)
    inits = [rs.randn(*s).astype("float32") * 0.5 for s in SHAPES]
    grads = [[rs.randn(*s).astype("float32") for s in SHAPES]
             for _ in range(steps)]
    return inits, grads


def _pair(ref_cls, port_cls, steps=4, dtype="float32", groups=None,
          sched=None, **kw):
    """(reference params, port params, port optimizer) after `steps`
    steps of the same gradients. `groups`: lists of parameter indices with
    their extra keys; `sched`: a scheduler factory (stepped after each
    step)."""
    jdt, tdt = DT[dtype]
    inits, grads = _data(steps)
    ref = [Parameter(jnp.asarray(a).astype(jdt)) for a in inits]
    port = [torch.nn.Parameter(torch.tensor(a).to(tdt)) for a in inits]
    rk, pk = dict(kw), dict(kw)
    if sched is not None:
        rk["learning_rate"], pk["learning_rate"] = sched(plr), sched(tlr)
    if groups is None:
        rp, pp = ref, port
    else:
        rp = [dict(extra, params=[ref[i] for i in idx])
              for idx, extra in groups]
        pp = [dict(extra, params=[port[i] for i in idx])
              for idx, extra in groups]
    ropt, popt = ref_cls(parameters=rp, **rk), port_cls(parameters=pp, **pk)
    for gs in grads:
        for p, g in zip(ref, gs):
            p.grad = Tensor(jnp.asarray(g).astype(jdt))
        ropt.step()
        ropt.clear_grad()
        for p, g in zip(port, gs):
            p.grad = torch.from_numpy(g).to(tdt)
        popt.step()
        popt.clear_grad()
        if sched is not None:
            rk["learning_rate"].step()
            pk["learning_rate"].step()
    return ref, port, popt


def _assert_same(ref, port):
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(_np(p), _np(r))


# ------------------------------------------------------- Adam and AdamW

ADAM_CASES = {
    "adam-amsgrad": (paddle.optimizer.Adam, topt.Adam,
                     dict(amsgrad=True, weight_decay=0.05)),
    "adam-l2decay": (paddle.optimizer.Adam, topt.Adam,
                     dict(weight_decay=("L2Decay", 0.05))),
    "adam-l1decay": (paddle.optimizer.Adam, topt.Adam,
                     dict(weight_decay=("L1Decay", 0.05))),
    "adamw-amsgrad": (paddle.optimizer.AdamW, topt.AdamW,
                      dict(amsgrad=True)),
    "adamw-l2decay": (paddle.optimizer.AdamW, topt.AdamW,
                      dict(weight_decay=("L2Decay", 0.1))),
    "adamw-l1decay": (paddle.optimizer.AdamW, topt.AdamW,
                      dict(weight_decay=("L1Decay", 0.02), amsgrad=True)),
    "radam": (paddle.optimizer.RAdam, topt.RAdam, dict(weight_decay=0.01)),
    "adam-lazy": (paddle.optimizer.Adam, topt.Adam, dict(lazy_mode=True)),
}


def _regs(kw):
    """kw with ("L1Decay", c) made into each side's regularizer."""
    ref, port = dict(kw), dict(kw)
    wd = kw.get("weight_decay")
    if isinstance(wd, tuple):
        ref["weight_decay"] = getattr(paddle.regularizer, wd[0])(wd[1])
        port["weight_decay"] = getattr(treg, wd[0])(wd[1])
    return ref, port


@pytest.mark.parametrize("dtype,mp", [("float32", False),
                                      ("bfloat16", False),
                                      ("bfloat16", True)],
                         ids=["f32", "bf16-moments", "bf16-master"])
@pytest.mark.parametrize("case", sorted(ADAM_CASES))
def test_adam_family_bit_identical(case, dtype, mp):
    rcls, pcls, kw = ADAM_CASES[case]
    rk, pk = _regs(kw)
    rk.update(learning_rate=1e-2, multi_precision=mp)
    ref, port, _ = _pair(rcls, lambda **a: pcls(**dict(a, **pk)),
                         dtype=dtype, **rk)
    _assert_same(ref, port)


def test_adamw_parameter_groups_and_scheduler_bit_identical():
    groups = [([0, 1], {"learning_rate": 0.5, "weight_decay": 0.2}),
              ([2], {"weight_decay": paddle.regularizer.L2Decay(0.1)}),
              ([3], {})]
    ref, port, popt = _pair(
        paddle.optimizer.AdamW,
        lambda **a: topt.AdamW(**dict(a, parameters=[
            dict(g, weight_decay=treg.L2Decay(0.1))
            if isinstance(g.get("weight_decay"), paddle.regularizer.L2Decay)
            else g for g in a["parameters"]])),
        groups=groups, sched=lambda m: m.CosineAnnealingDecay(0.01, T_max=3),
        amsgrad=True)
    _assert_same(ref, port)
    assert popt._step_count == 4


def test_stop_gradient_parameters_are_skipped():
    ref, port, _ = _pair(paddle.optimizer.AdamW, topt.AdamW, steps=0)
    ref[1].stop_gradient = True
    port[1].requires_grad_(False)
    ropt = paddle.optimizer.AdamW(parameters=ref, learning_rate=0.1)
    popt = topt.AdamW(parameters=port, learning_rate=0.1)
    _, grads = _data(1)
    for p, q, g in zip(ref, port, grads[0]):
        p.grad = Tensor(jnp.asarray(g))
        q.grad = torch.from_numpy(g)
    before = _np(port[1]).copy()
    ropt.step()
    popt.step()
    _assert_same(ref, port)
    np.testing.assert_array_equal(_np(port[1]), before)
    assert port[1] not in popt.state


# --------------------------------------------------------- fused path

def _spy(monkeypatch, name):
    """Record the lengths of the lists each call of the port's `name`
    (fused_adam / fused_momentum) gets."""
    calls = []
    real = getattr(topt, name)

    def spy(params, *a, **k):
        calls.append(len(params))
        return real(params, *a, **k)

    monkeypatch.setattr(topt, name, spy)
    return calls


@pytest.mark.parametrize("clip", [None, 0.05], ids=["noclip", "clip"])
@pytest.mark.parametrize("dtype,mp,rtol,atol", [
    ("float32", False, 1e-6, 1e-7), ("bfloat16", False, 1e-2, 1e-3),
    ("bfloat16", True, 1e-2, 1e-3)], ids=["f32", "bf16", "bf16-master"])
def test_fused_path_matches_reference_fused_path(monkeypatch, clip, dtype,
                                                 mp, rtol, atol):
    calls = _spy(monkeypatch, "fused_adam")
    kw = dict(learning_rate=0.01, use_multi_tensor=True, multi_precision=mp)
    if clip is not None:
        ref, port, _ = _pair(
            paddle.optimizer.AdamW,
            lambda **a: topt.AdamW(**dict(
                a, grad_clip=tnn.ClipGradByGlobalNorm(clip))),
            dtype=dtype, grad_clip=paddle.nn.ClipGradByGlobalNorm(clip), **kw)
    else:
        ref, port, _ = _pair(paddle.optimizer.AdamW, topt.AdamW, dtype=dtype,
                             **kw)
    assert calls == [len(SHAPES)] * 4     # engaged: one call a step
    for r, p in zip(ref, port):
        np.testing.assert_allclose(_np(p), _np(r), rtol=rtol, atol=atol)


@pytest.mark.parametrize("clip", [False, True], ids=["noclip", "clip"])
@pytest.mark.parametrize("cls,kw", [
    (topt.AdamW, dict(amsgrad=True, lr_ratio=lambda p: 0.5)),
    (topt.Adam, dict(weight_decay=0.1)),
    (topt.Momentum, dict(use_nesterov=True, weight_decay=0.1)),
    (topt.Momentum, dict(momentum=0.8))],
    ids=["adamw", "adam", "momentum-nesterov", "momentum"])
def test_fused_path_equals_per_parameter_path(clip, cls, kw):
    """The port's two paths compute the same bits, dtype groups and all:
    two f32 parameters and two bf16 ones (bf16 moments) are two launches
    on the fused path, four on the per-parameter one."""
    inits, grads = _data(3)
    runs = []
    for multi in (False, True):
        ps = [torch.nn.Parameter(torch.tensor(a).to(
            torch.bfloat16 if i % 2 else torch.float32))
            for i, a in enumerate(inits)]
        opt = cls(parameters=ps, learning_rate=0.05, use_multi_tensor=multi,
                  grad_clip=tnn.ClipGradByGlobalNorm(1.0) if clip else None,
                  **kw)
        for gs in grads:
            for p, g in zip(ps, gs):
                p.grad = torch.from_numpy(g).to(p.dtype)
            opt.step()
            opt.clear_grad()
        runs.append([_np(p) for p in ps] + [
            _np(t) for p in ps for t in opt.state[p].values()])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("why", ["l1", "clip-by-norm", "mixed-masters"])
def test_fused_path_refusals_take_the_per_parameter_path(monkeypatch, why):
    calls = _spy(monkeypatch, "fused_adam")
    inits, grads = _data(2)
    ps = [torch.nn.Parameter(torch.tensor(a)) for a in inits]
    kw = dict(learning_rate=0.01, use_multi_tensor=True)
    if why == "l1":
        kw["weight_decay"] = treg.L1Decay(0.01)
    elif why == "clip-by-norm":
        kw["grad_clip"] = tnn.ClipGradByNorm(0.5)
    else:
        ps[0].data = ps[0].data.to(torch.bfloat16)
        kw["multi_precision"] = True
    opt = topt.AdamW(parameters=ps, **kw)
    for gs in grads:
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g).to(p.dtype)
        assert tfused.refusal(opt, opt._collect_params_grads()) is not None
        opt.step()
    assert calls == [1] * (2 * len(SHAPES))


def test_interrupted_fused_step_still_completes(monkeypatch):
    """The reference's `_guarded_update` contract: an interrupt after the
    step's first launch does not leave it half applied."""
    inits, grads = _data(1)
    runs = []
    for hook in (None, True):
        ps = [torch.nn.Parameter(torch.tensor(a).to(
            torch.bfloat16 if i % 2 else torch.float32))
            for i, a in enumerate(inits)]
        opt = topt.AdamW(parameters=ps, use_multi_tensor=True)
        for p, g in zip(ps, grads[0]):
            p.grad = torch.from_numpy(g).to(p.dtype)

        def interrupt():
            raise KeyboardInterrupt

        monkeypatch.setattr(tfused, "_interrupt_test_hook",
                            interrupt if hook else None)
        if hook:
            with pytest.raises(KeyboardInterrupt):
                opt.step()
        else:
            opt.step()
        runs.append([_np(p) for p in ps])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(b, a)


def test_state_dict_across_paths_and_structured_names():
    """Two fused steps, the state handed (by structured names) to a fresh
    per-parameter optimizer before its first step, two more: the same as
    four fused steps."""
    inits, grads = _data(4)

    def params():
        return [torch.nn.Parameter(torch.from_numpy(a).to(torch.bfloat16))
                for a in inits]

    def run(opt, ps, gs):
        for step in gs:
            for p, g in zip(ps, step):
                p.grad = torch.from_numpy(g).to(p.dtype)
            opt.step()
            opt.clear_grad()

    whole = params()
    opt = topt.AdamW(parameters=whole, use_multi_tensor=True, amsgrad=True,
                     multi_precision=True,
                     learning_rate=tlr.StepDecay(0.01, 1, 0.5))
    for step in grads:
        run(opt, whole, [step])
        opt._lr.step()

    first = params()
    opt1 = topt.AdamW(parameters=first, use_multi_tensor=True, amsgrad=True,
                      multi_precision=True,
                      learning_rate=tlr.StepDecay(0.01, 1, 0.5))
    for step in grads[:2]:
        run(opt1, first, [step])
        opt1._lr.step()
    names = {id(p): f"layer.{i}.weight" for i, p in enumerate(first)}
    sd = opt1.state_dict(structured_names=names)
    assert sd["step"] == 2 and "LR_Scheduler" in sd
    assert {k.split("@")[1] for k in sd if "@" in k} == {
        "moment1", "moment2", "moment2_max", "master"}

    second = [torch.nn.Parameter(p.detach().clone()) for p in first]
    opt2 = topt.AdamW(parameters=[(f"w{i}", p) for i, p in
                                  enumerate(second)], amsgrad=True,
                      multi_precision=True,
                      learning_rate=tlr.StepDecay(0.01, 1, 0.5))
    opt2.set_state_dict(sd, structured_names={
        id(p): f"layer.{i}.weight" for i, p in enumerate(second)})
    assert opt2._step_count == 2 and opt2.get_lr() == opt1.get_lr()
    for step in grads[2:]:
        run(opt2, second, [step])
        opt2._lr.step()
    for a, b in zip(whole, second):
        np.testing.assert_array_equal(_np(b), _np(a))
        for kind, t in opt.state[a].items():
            np.testing.assert_array_equal(
                _np(opt2.state[b][kind]), _np(t))


def test_lr_api_and_minimize():
    p, q = (torch.nn.Parameter(torch.ones(3)) for _ in range(2))
    opt = topt.SGD(parameters=[p, q], learning_rate=0.5)
    opt.set_lr(0.25)
    assert opt.get_lr() == 0.25
    loss = (p * 2 + q * 3).sum()
    opt.minimize(loss, parameters=[p])     # only p is updated
    assert torch.equal(p.detach(), torch.full((3,), 0.5))
    assert torch.equal(q.detach(), torch.ones(3))
    sched_opt = topt.SGD(parameters=[p], learning_rate=tlr.StepDecay(1.0, 1))
    with pytest.raises(RuntimeError):
        sched_opt.set_lr(0.1)
    with pytest.raises(ValueError):
        opt.step(lambda: 0.0)


# ------------------------------------------------------------- clipping

def _grads(dtype, scale=1.0):
    jdt, tdt = DT[dtype]
    rs = np.random.RandomState(3)
    gs = [rs.randn(*s).astype("float32") * scale for s in SHAPES]
    return ([(None, Tensor(jnp.asarray(g).astype(jdt))) for g in gs],
            [(None, torch.from_numpy(g).to(tdt)) for g in gs])


CLIPS = {
    "value": lambda m: m.ClipGradByValue(0.5),
    "value-asym": lambda m: m.ClipGradByValue(max=0.75, min=-0.25),
    "norm": lambda m: m.ClipGradByNorm(1.0),
    "norm-loose": lambda m: m.ClipGradByNorm(100.0),
    "global": lambda m: m.ClipGradByGlobalNorm(1.0),
    "global-loose": lambda m: m.ClipGradByGlobalNorm(100.0),
}


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-6),
                                        ("bfloat16", 2 ** -7)])
@pytest.mark.parametrize("name", sorted(CLIPS))
def test_clip_classes_match_reference(name, dtype, rtol):
    ref_pg, port_pg = _grads(dtype)
    ref_pg.insert(1, (None, None))
    port_pg.insert(1, (None, None))
    want = CLIPS[name](paddle.nn)(ref_pg)
    got = CLIPS[name](tnn)(port_pg)
    assert got[1][1] is None
    for (_, w), (_, g) in zip(want, got):
        if w is not None:
            assert g.dtype == DT[dtype][1]
            np.testing.assert_allclose(_np(g), _np(w), rtol=rtol, atol=0)


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_and_value_match_reference(norm_type):
    from paddle_tpu.nn.utils import clip_grad_norm_, clip_grad_value_

    ref_pg, port_pg = _grads("float32", 2.0)
    ref = [Parameter(jnp.zeros(g.shape)) for _, g in ref_pg]
    port = [torch.nn.Parameter(torch.zeros(g.shape)) for _, g in port_pg]
    for p, (_, g) in zip(ref, ref_pg):
        p.grad = g
    for p, (_, g) in zip(port, port_pg):
        p.grad = g
    want = clip_grad_norm_(ref, 1.5, norm_type)
    got = tnn.clip_grad_norm_(port, 1.5, norm_type)
    np.testing.assert_allclose(got.item(), float(want.numpy()), rtol=1e-6)
    for r, p in zip(ref, port):
        np.testing.assert_allclose(_np(p.grad), _np(r.grad), rtol=1e-6,
                                   atol=1e-7)
    ref_pg, port_pg = _grads("float32", 2.0)
    for p, (_, g) in zip(ref, ref_pg):
        p.grad = g
    for p, (_, g) in zip(port, port_pg):
        p.grad = g
    clip_grad_value_(ref, 0.1)
    tnn.clip_grad_value_(port, 0.1)
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(_np(p.grad), _np(r.grad))
    port[0].grad = torch.full_like(port[0], float("nan"))
    with pytest.raises(RuntimeError, match="non-finite"):
        tnn.clip_grad_norm_(port[:1], 1.0, error_if_nonfinite=True)


# ----------------------------------------------------- other optimizers

OTHERS = {
    "sgd": ("SGD", dict(weight_decay=0.1)),
    "sgd-l1": ("SGD", dict(weight_decay=("L1Decay", 0.05))),
    "momentum": ("Momentum", dict(momentum=0.9, weight_decay=0.1)),
    "momentum-nesterov-l1": ("Momentum", dict(
        use_nesterov=True, weight_decay=("L1Decay", 0.05))),
    "adagrad": ("Adagrad", dict(initial_accumulator_value=0.1,
                                weight_decay=0.01)),
    "decayed_adagrad": ("DecayedAdagrad", dict(decay=0.9)),
    "ftrl": ("Ftrl", dict(l1=0.01, l2=0.02)),
    "rmsprop": ("RMSProp", dict(momentum=0.5)),
    "rmsprop-centered": ("RMSProp", dict(centered=True, rho=0.9)),
    "adadelta": ("Adadelta", dict(rho=0.9, weight_decay=0.01)),
    "adamax": ("Adamax", dict(weight_decay=0.01)),
    "nadam": ("NAdam", dict()),
    "lamb": ("Lamb", dict(lamb_weight_decay=0.05)),
    "lamb-exclude": ("Lamb", dict(
        exclude_from_weight_decay_fn=lambda p: len(p.shape) == 1)),
    "asgd": ("ASGD", dict()),
    "asgd-avg3": ("ASGD", dict(batch_num=3, weight_decay=0.01)),
    "rprop": ("Rprop", dict(learning_rate_range=(1e-4, 0.05))),
}


@pytest.mark.parametrize("name", sorted(OTHERS))
def test_other_optimizers_match_reference(name):
    cls, kw = OTHERS[name]
    rk, pk = _regs(kw)
    ref, port, _ = _pair(getattr(paddle.optimizer, cls),
                         lambda **a: getattr(topt, cls)(**dict(a, **pk)),
                         learning_rate=0.01, **rk)
    for r, p in zip(ref, port):
        np.testing.assert_allclose(_np(p), _np(r), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype,mp", [("float32", False),
                                      ("bfloat16", True)],
                         ids=["f32", "bf16-master"])
def test_momentum_bit_identical(dtype, mp):
    ref, port, _ = _pair(paddle.optimizer.Momentum, topt.Momentum,
                         dtype=dtype, learning_rate=0.05, momentum=0.9,
                         use_nesterov=True, weight_decay=0.1,
                         multi_precision=mp)
    _assert_same(ref, port)


@pytest.mark.parametrize("line_search", [None, "strong_wolfe"])
def test_lbfgs_matches_reference(line_search):
    """A least-squares fit by each side's LBFGS (closure-driven)."""
    rs = np.random.RandomState(4)
    a = rs.randn(12, 5).astype("float32")
    b = rs.randn(12).astype("float32")
    old = paddle.get_flags(["FLAGS_eager_defer_vjp"])
    paddle.set_flags({"FLAGS_eager_defer_vjp": False})
    try:
        rw = Parameter(jnp.zeros(5))
        ropt = paddle.optimizer.LBFGS(parameters=[rw], max_iter=8,
                                      line_search_fn=line_search,
                                      learning_rate=0.1)
        ra, rb = paddle.to_tensor(a), paddle.to_tensor(b)
        ropt.step(lambda: ((paddle.matmul(ra, rw) - rb) ** 2).mean())
    finally:
        paddle.set_flags(old)
    tw = torch.nn.Parameter(torch.zeros(5))
    topt_ = topt.LBFGS(parameters=[tw], max_iter=8,
                       line_search_fn=line_search, learning_rate=0.1)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    topt_.step(lambda: ((ta @ tw - tb) ** 2).mean())
    np.testing.assert_allclose(_np(tw), _np(rw), rtol=1e-4, atol=1e-5)


# ------------------------------------------- the kernel's wrapper path

class _StandIn:
    """Stands in for the C entry: records each call's arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


def _wrapper_path(monkeypatch):
    stand_in = _StandIn()
    monkeypatch.setattr(fused_optimizer, "_plain", lambda *a: False)
    monkeypatch.setattr(fused_optimizer, "current_stream", lambda d: 7)
    monkeypatch.setattr(fused_optimizer, "_entry", lambda *a: stand_in)
    return stand_in


def test_wrapper_passes_the_list_in_batches(monkeypatch):
    """What the wrapper hands the kernel: MAX_TENSORS tensors a launch,
    empty tensors left out, each tensor's pointers, size, learning-rate
    factors and decay coefficient, the dtype pair, the constant scalars
    and the device pointers of the base learning rate and the bias
    corrections; one count per launch."""
    stand_in = _wrapper_path(monkeypatch)
    n = 2 * fused_optimizer.MAX_TENSORS
    sizes = [(i % 5) * 3 for i in range(n)]      # every fifth is empty
    ps = [torch.zeros(s, dtype=torch.bfloat16) for s in sizes]
    gs = [torch.ones(s, dtype=torch.bfloat16) for s in sizes]
    ms = [torch.zeros(s, dtype=torch.bfloat16) for s in sizes]
    vs = [torch.zeros(s, dtype=torch.bfloat16) for s in sizes]
    lrs = [1e-3 * (1 + i % 3) for i in range(n)]
    before = _cuda_common.launch_counts()["fused_adam"]
    fused_optimizer.fused_adam(ps, gs, ms, vs, None, None, lrs, [0.1] * n,
                               beta1=0.9, beta2=0.999, epsilon=1e-8, step=3,
                               decoupled=True)
    assert _cuda_common.launch_counts()["fused_adam"] == before + 2
    live = [i for i, s in enumerate(sizes) if s]
    assert [c[0] for c in stand_in.calls] == [
        fused_optimizer.MAX_TENSORS, len(live) - fused_optimizer.MAX_TENSORS]
    h = fused_optimizer.adam_scalars(0.9, 0.999, 1e-8, torch.float32)
    for k, call in enumerate(stand_in.calls):
        idx = live[k * fused_optimizer.MAX_TENSORS:]
        count = call[0]
        assert list(call[1]) == [ps[i].data_ptr() for i in idx[:count]]
        assert list(call[2]) == [gs[i].data_ptr() for i in idx[:count]]
        assert call[5] is None and call[6] is None    # no vmax, no master
        assert list(call[7]) == [sizes[i] for i in idx[:count]]
        # the learning rate's factors over the base (1: no `lr` given),
        # the f32 decay coefficients
        assert list(call[8]) == [np.float32(lrs[i]) for i in idx[:count]]
        assert list(call[9]) == [1.0] * count
        assert list(call[10]) == fused_optimizer.decay_coeffs(
            [0.1] * count, True, torch.float32)
        assert call[11:15] == (1, 1, 1, 0)           # bf16, bf16, decoupled
        assert call[15:20] == tuple(h)
        # the base learning rate and the bias corrections on the device
        assert call[20] == fused_optimizer._base_lr(None, ps[0].device) \
            .data_ptr()
        assert isinstance(call[21], int) and call[22] is None \
            and call[23] == 7


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    _wrapper_path(monkeypatch)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, step=1, decoupled=False)

    def adam(p, g, m, v, masters=None, scale=None):
        fused_optimizer.fused_adam([p], [g], [m], [v], None, masters, [0.1],
                                   [0.0], scale=scale, **kw)

    f32, bf = torch.float32, torch.bfloat16
    z = lambda dt, n=4: torch.zeros(n, dtype=dt)   # noqa: E731
    with pytest.raises(ValueError, match="contiguous"):
        adam(torch.zeros(4, 2).t(), z(f32, 8).view(2, 4), z(f32, 8),
             z(f32, 8))
    with pytest.raises(ValueError, match="dtype"):
        adam(z(f32), z(bf), z(f32), z(f32))
    with pytest.raises(ValueError, match="dtype"):
        adam(z(f32), z(f32), z(bf), z(bf))
    with pytest.raises(ValueError, match="master"):
        adam(z(f32), z(f32), z(f32), z(f32), masters=[z(f32)])
    with pytest.raises(ValueError, match="size"):
        adam(z(f32), z(f32, 5), z(f32), z(f32))
    with pytest.raises(ValueError, match="scale"):
        adam(z(f32), z(f32), z(f32), z(f32), scale=torch.ones(2))
    monkeypatch.undo()
    with pytest.raises(ValueError, match="one CUDA device"):
        fused_optimizer.fused_momentum(
            [z(f32)], [torch.zeros(4, device="meta")], [z(f32)], None,
            [0.1], [0.0], momentum=0.9)
