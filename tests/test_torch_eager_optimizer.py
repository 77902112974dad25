"""Port parity: the eager optimizer surface (``Optimizer.step``,
``clear_grad``, ``minimize``, ``state_dict``; gradient clipping,
``L2Decay`` at the optimizer and per parameter, per-parameter learning
rates, AdamW's ``apply_decay_param_fun`` and Lamb's exclude function)
against the JAX package's eager step, over three LeNet steps from the
same carried weights on the same seeded batch.

Parameters are renamed to their structured names in both packages, so
name-keyed state and the decay functions see the same names.  LeNet
has no batch norm, so the two runs stay within rounding: every loss
within 1e-5 relative, every parameter after the last step within 1e-5
of its largest magnitude, and every optimizer state tensor within 2e-5
(second moments square the gradient, doubling its relative rounding).
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.models import layer_from_numpy, layer_to_numpy
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.vision.models import LeNet
from test_torch_vision import jax_state, share

TOL = 1e-5
STATE_TOL = 2e-5
STEPS = 3


class Jax:
    opt, nn, L2Decay = paddle.optimizer, paddle.nn, paddle.regularizer.L2Decay


class Port:
    opt, nn, L2Decay = popt, pnn, popt.L2Decay


RULES = {
    "SGD": ("SGD", dict(learning_rate=0.05)),
    "Momentum": ("Momentum", dict(learning_rate=0.05, momentum=0.9,
                                  use_nesterov=True)),
    "Adam": ("Adam", dict(learning_rate=1e-3)),
    "AdamW": ("AdamW", dict(learning_rate=1e-3, weight_decay=0.05)),
    "Adagrad": ("Adagrad", dict(learning_rate=1e-3)),
    "RMSProp": ("RMSProp", dict(learning_rate=1e-3, momentum=0.5,
                                centered=True)),
    "Adadelta": ("Adadelta", dict(learning_rate=0.1)),
    "Adamax": ("Adamax", dict(learning_rate=1e-3)),
    "Lamb": ("Lamb", dict(learning_rate=1e-3, lamb_weight_decay=0.01)),
}

# case: (rule, the optimizer's options from a package, per-parameter
# attributes from a package, how a step runs)
CASES = {
    **{rule: (rule, lambda pkg: {}, lambda pkg: {}, "step")
       for rule in RULES},
    "clip-global-norm": ("Adam", lambda pkg: dict(
        grad_clip=pkg.nn.ClipGradByGlobalNorm(0.05)),
        lambda pkg: {"fc.2.bias": dict(need_clip=False)}, "step"),
    "clip-norm": ("SGD", lambda pkg: dict(
        grad_clip=pkg.nn.ClipGradByNorm(0.02)),
        lambda pkg: {"features.0.weight": dict(need_clip=False)}, "step"),
    "clip-value": ("Momentum", lambda pkg: dict(
        grad_clip=pkg.nn.ClipGradByValue(0.05)),
        lambda pkg: {"fc.0.weight": dict(need_clip=False)}, "step"),
    "l2-decay-optimizer": ("Momentum", lambda pkg: dict(
        weight_decay=pkg.L2Decay(0.05)), lambda pkg: {}, "step"),
    "l2-decay-per-parameter": ("Adam", lambda pkg: dict(weight_decay=0.01),
                               lambda pkg: {
        "features.3.weight": dict(regularizer=pkg.L2Decay(0.5)),
        "fc.0.weight": dict(regularizer=pkg.L2Decay(0.0))}, "step"),
    "parameter-learning-rate": ("Adam", lambda pkg: {}, lambda pkg: {
        "fc.1.weight": dict(optimize_attr={"learning_rate": 0.5}),
        "features.0.bias": dict(optimize_attr={"learning_rate": 3.0})},
        "step"),
    "adamw-apply-decay-param-fun": ("AdamW", lambda pkg: dict(
        weight_decay=0.1,
        apply_decay_param_fun=lambda n: not n.endswith("bias")),
        lambda pkg: {}, "step"),
    "lamb-exclude-from-weight-decay": ("Lamb", lambda pkg: dict(
        lamb_weight_decay=0.1,
        exclude_from_weight_decay_fn=lambda n: n.startswith("fc")),
        lambda pkg: {}, "step"),
    "minimize": ("Adam", lambda pkg: {}, lambda pkg: {}, "minimize"),
    "accumulate-two-backwards": ("Momentum", lambda pkg: {},
                                 lambda pkg: {}, "accumulate"),
    "frozen-parameter": ("Adam", lambda pkg: {}, lambda pkg: {
        "fc.1.bias": dict(trainable=False)}, "step"),
}


def _batch(b=8):
    rng = np.random.RandomState(0)
    return (rng.rand(b, 1, 28, 28).astype(np.float32),
            rng.randint(0, 10, (b, 1)).astype(np.int64))


def _nets():
    """A JAX LeNet (seed 0) and the port's carrying its weights, every
    parameter named by its structured name in both."""
    paddle.seed(0)
    jnet = paddle.vision.models.LeNet()
    pnet = layer_from_numpy(LeNet(device="cpu"), jax_state(jnet), "cpu")
    for net in (jnet, pnet):
        for n, p in net.named_parameters():
            p.name = n
    return jnet, pnet


def _set_attrs(net, attrs, jax):
    for n, p in net.named_parameters():
        for k, v in attrs.get(n, {}).items():
            if k == "trainable":
                if jax:
                    p.stop_gradient = not v
                else:
                    p.requires_grad_(v)
            else:
                setattr(p, k, v)


def _jax_loss(net, img, lbl):
    return paddle.mean(JF.softmax_with_cross_entropy(
        net(paddle.to_tensor(img)), paddle.to_tensor(lbl)))


def _port_loss(net, img, lbl):
    return PF.softmax_with_cross_entropy(
        net(torch.from_numpy(img)), torch.from_numpy(lbl)).mean()


def _train(net, opt, loss_fn, mode, steps=STEPS):
    img, lbl = _batch()
    losses = []
    for _ in range(steps):
        if mode == "accumulate":     # two half batches, one step
            loss = loss_fn(net, img[:4], lbl[:4])
            loss.backward()
            loss_fn(net, img[4:], lbl[4:]).backward()
            opt.step()
        elif mode == "minimize":
            loss = loss_fn(net, img, lbl)
            assert opt.minimize(loss) == (None, None)
        else:
            loss = loss_fn(net, img, lbl)
            loss.backward()
            opt.step()
        opt.clear_grad()
        losses.append(float(np.asarray(
            loss._data if hasattr(loss, "_data") else loss.detach())))
    return losses


def _run(case, with_jax=True):
    """Both packages' runs of `case` (the port's alone, the JAX ones
    None, without `with_jax`)."""
    rule, options, attrs, mode = CASES[case]
    name, kw = RULES[rule]
    jnet, pnet = _nets()
    _set_attrs(pnet, attrs(Port), jax=False)
    popt_ = getattr(popt, name)(parameters=pnet.parameters(),
                                **{**kw, **options(Port)})
    got = _train(pnet, popt_, _port_loss, mode)
    if not with_jax:
        return None, None, None, pnet, popt_, got
    _set_attrs(jnet, attrs(Jax), jax=True)
    jopt = getattr(paddle.optimizer, name)(
        parameters=jnet.parameters(), **{**kw, **options(Jax)})
    want = _train(jnet, jopt, _jax_loss, mode)
    return jnet, jopt, want, pnet, popt_, got


def _state(opt, jax):
    return {k: (np.asarray(v._data) if jax else v.numpy())
            for k, v in opt.state_dict().items()
            if k not in ("global_step", "LR_Scheduler")}


@pytest.mark.parametrize("case", list(CASES))
def test_eager_step_matches_jax(case):
    jnet, jopt, want, pnet, popt_, got = _run(case)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=0)
    assert got[-1] < got[0]
    jparams = dict(jnet.named_parameters())
    for n, p in pnet.named_parameters():
        err = share(p.detach().numpy(), np.asarray(jparams[n]._data))
        assert err <= TOL, f"{n}: {err:.3e}"
    jstate, pstate = _state(jopt, True), _state(popt_, False)
    assert set(pstate) == set(jstate)
    for k, v in jstate.items():
        err = share(pstate[k], v) if np.abs(v).max() > 0 else np.abs(
            pstate[k]).max()
        assert err <= STATE_TOL, f"{k}: {err:.3e}"
    assert popt_.state_dict()["global_step"] == STEPS


def test_the_options_change_the_step():
    """Each option of the parametrized cases moves the result away from
    the plain rule's, so the parity above is not vacuous."""
    plain = {}
    for case in CASES:
        rule = CASES[case][0]
        if case == rule or case in ("minimize",):
            continue
        if rule not in plain:
            plain[rule] = {n: p.detach().clone() for n, p in
                           _run(rule, with_jax=False)[3].named_parameters()}
        moved = _run(case, with_jax=False)[3]
        assert any(not torch.equal(p.detach(), plain[rule][n])
                   for n, p in moved.named_parameters()), case


def test_frozen_and_gradless_parameters_keep_value_and_state():
    """A parameter that does not require grad, or has no gradient, is
    left alone by the step: its value, and no state is made for it."""
    _, _, _, pnet, opt, _ = _run("frozen-parameter", with_jax=False)
    frozen = dict(pnet.named_parameters())["fc.1.bias"]
    assert frozen.grad is None and id(frozen) not in opt._states
    before = {n: p.detach().clone() for n, p in pnet.named_parameters()}
    opt.step()                                   # no gradients at all
    for n, p in pnet.named_parameters():
        assert torch.equal(p.detach(), before[n]), n


def test_clear_grad_sets_every_gradient_to_none():
    net = LeNet(device="cpu")
    opt = popt.SGD(0.1, parameters=net.parameters())
    _port_loss(net, *_batch()).backward()
    assert all(p.grad is not None for p in net.parameters())
    opt.clear_gradients()
    assert all(p.grad is None for p in net.parameters())


def test_state_dict_round_trip():
    """After three Adam steps the port's ``state_dict`` has JAX's keys
    (``global_step``, ``{name}_{key}`` and ``@pos{i}_{key}``) and values;
    a fresh optimizer loaded from it steps exactly as the original, by
    the name keys and, with the names changed, by the positional ones;
    a scheduler's state rides along."""
    jnet, jopt, _, pnet, opt, _ = _run("Adam")
    state, weights = opt.state_dict(), layer_to_numpy(pnet)
    assert set(state) == set(jopt.state_dict())
    assert state["global_step"] == STEPS
    assert "fc.2.bias_moment1" in state and "@pos9_beta2_pow" in state
    assert state["fc.2.bias_moment1"] is state["@pos9_moment1"]

    def fresh(names):
        net = layer_from_numpy(LeNet(device="cpu"), weights, "cpu")
        for n, p in net.named_parameters():
            p.name = names(n)
        new = popt.Adam(1e-3, parameters=net.parameters())
        new.set_state_dict(state)
        return net, new

    _train(pnet, opt, _port_loss, "step", steps=1)
    for names in (lambda n: n, lambda n: "renamed." + n):
        net, new = fresh(names)
        assert new.state_dict()["global_step"] == STEPS
        _train(net, new, _port_loss, "step", steps=1)
        for (n, a), b in zip(net.named_parameters(), pnet.parameters()):
            assert torch.equal(a.detach(), b.detach()), n

    sched = popt.lr.StepDecay(0.1, step_size=2)
    sopt = popt.SGD(sched, parameters=pnet.parameters())
    sched.step()
    loaded = popt.lr.StepDecay(0.1, step_size=2)
    popt.SGD(loaded, parameters=pnet.parameters()).set_state_dict(
        sopt.state_dict())
    assert loaded.last_epoch == sched.last_epoch == 1


def test_param_attr_names_and_options_reach_the_step():
    """``ParamAttr(name=..., learning_rate=..., regularizer=...,
    need_clip=..., trainable=...)`` on the port's layers gives the
    parameters the eager step reads, as the JAX package's does; an
    L1Decay raises wherever it is given."""
    attr = dict(name="w", learning_rate=0.5, need_clip=False)
    jl = paddle.nn.Linear(3, 2, weight_attr=paddle.ParamAttr(
        **attr, regularizer=paddle.regularizer.L2Decay(0.1)),
        bias_attr=paddle.ParamAttr(name="b", trainable=False))
    pl = pnn.Linear(3, 2, weight_attr=pnn.ParamAttr(
        **attr, regularizer=popt.L2Decay(0.1)), bias_attr=pnn.ParamAttr(
        name="b", trainable=False), generator=torch.Generator())
    for j, p in ((jl.weight, pl.weight), (jl.bias, pl.bias)):
        assert p.name == j.name and p.optimize_attr == j.optimize_attr
        assert p.need_clip == j.need_clip
        assert p.requires_grad == (not j.stop_gradient)
    assert pl.weight.regularizer._coeff == 0.1
    layer_from_numpy(pl, jax_state(jl), "cpu")
    x = np.random.RandomState(1).rand(4, 3).astype(np.float32)
    jopt = paddle.optimizer.SGD(0.1, parameters=jl.parameters())
    opt = popt.SGD(0.1, parameters=pl.parameters())
    paddle.sum(jl(paddle.to_tensor(x)) ** 2).backward()
    (pl(torch.from_numpy(x)) ** 2).sum().backward()
    jopt.step()
    opt.step()
    np.testing.assert_allclose(pl.weight.detach().numpy(),
                               np.asarray(jl.weight._data), rtol=1e-6)
    np.testing.assert_array_equal(pl.bias.detach().numpy(),
                                  np.asarray(jl.bias._data))
    assert set(opt.state_dict()) == set(jopt.state_dict())
    with pytest.raises(NotImplementedError, match="L1Decay"):
        pnn.ParamAttr(regularizer=popt.L1Decay(0.1))
    # sparse gradients are ported (tests/test_torch_sparse_grad.py)
    assert pnn.Embedding(4, 2, sparse=True, generator=torch.Generator(
        ))._sparse


def test_utils_clip_grad_norm_matches_jax():
    jnet, pnet = _nets()
    img, lbl = _batch()
    _jax_loss(jnet, img, lbl).backward()
    _port_loss(pnet, img, lbl).backward()
    paddle.nn.utils_clip_grad_norm_(jnet.parameters(), 0.01)
    pnn.utils_clip_grad_norm_(pnet.parameters(), 0.01)
    jparams = dict(jnet.named_parameters())
    for n, p in pnet.named_parameters():
        assert share(p.grad.numpy(), np.asarray(jparams[n].grad._data)) \
            <= TOL, n


def test_lenet_bench_loop_on_the_cpu():
    """``bench.py::bench_lenet``'s loop through the port (B 32 on the CPU,
    as the bench sizes it without a card): the loss stays finite and
    falls."""
    net = LeNet(generator=torch.Generator().manual_seed(0), device="cpu")
    opt = popt.Adam(learning_rate=1e-3, parameters=net.parameters())
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.rand(32, 1, 28, 28).astype(np.float32))
    lbl = torch.from_numpy(rng.randint(0, 10, (32, 1)).astype(np.int64))
    losses = []
    for _ in range(4):
        loss = PF.softmax_with_cross_entropy(net(img), lbl).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
