"""Port parity: the update rules of the compiled train step
(``paddle_tpu_torch.optimizer``) against the JAX package's
``fused_update``, the path ``CompiledTrainStep`` takes at ZeRO stage 0.

Each rule (and its variants: Nesterov, centered RMSProp with momentum,
Lamb without decay, coupled weight decay) takes three fused updates of
three parameters (2-D and 1-D with gradients, and one without, which
keeps its value and state) on the same random arrays.  fp32 elementwise
arithmetic in one order, norms summed in another: 1e-6 relative (1e-7
absolute) on parameters and every state tensor.  Adam and AdamW are held
the same way in ``test_torch_train_step.py::test_fused_update_matches_jax``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import paddle_tpu as paddle
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.nn import (ClipGradByGlobalNorm, ClipGradByNorm,
                                 ClipGradByValue, ParamAttr)
from paddle_tpu_torch.parallel import TrainStep

LR = 0.01
TOL = dict(rtol=1e-6, atol=1e-7)
CASES = {
    "SGD": ("SGD", dict()),
    "SGD-weight_decay": ("SGD", dict(weight_decay=0.1)),
    "Momentum": ("Momentum", dict(momentum=0.9)),
    "Momentum-nesterov-weight_decay": ("Momentum", dict(
        momentum=0.8, use_nesterov=True, weight_decay=0.05)),
    "Adagrad": ("Adagrad", dict(epsilon=1e-6,
                                initial_accumulator_value=0.1)),
    "RMSProp": ("RMSProp", dict(rho=0.9)),
    "RMSProp-centered-momentum": ("RMSProp", dict(
        rho=0.9, momentum=0.5, centered=True, weight_decay=0.01)),
    "Adadelta": ("Adadelta", dict(rho=0.9, epsilon=1e-6)),
    "Adamax": ("Adamax", dict(weight_decay=0.02)),
    "Lamb": ("Lamb", dict(lamb_weight_decay=0.01)),
    "Lamb-no-decay": ("Lamb", dict(lamb_weight_decay=0.0, beta1=0.8)),
}


def test_every_rule_of_the_compiled_step_is_ported():
    rules = {"SGD", "Momentum", "Adam", "AdamW", "Adagrad", "RMSProp",
             "Adadelta", "Adamax", "Lamb"}
    for name in rules:
        assert issubclass(getattr(popt, name), popt.Optimizer)
        assert issubclass(getattr(paddle.optimizer, name),
                          paddle.optimizer.Optimizer)
    assert {c for c, _ in CASES.values()} == rules - {"Adam", "AdamW"}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_update_matches_jax(case):
    name, kw = CASES[case]
    rng = np.random.default_rng(5)
    params = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(4).astype(np.float32),
              "frozen": rng.standard_normal(2).astype(np.float32)}
    grads = [{n: rng.standard_normal(p.shape).astype(np.float32)
              for n, p in params.items() if n != "frozen"}
             for _ in range(3)]
    jopt = getattr(paddle.optimizer, name)(learning_rate=LR, **kw)
    topt = getattr(popt, name)(learning_rate=LR, **kw)
    jp = {n: jnp.asarray(p) for n, p in params.items()}
    js = jopt.init_fused_states(jp)
    tp = {n: torch.from_numpy(p) for n, p in params.items()}
    ts = {n: topt.init_state(p) for n, p in tp.items()}
    frozen_state = ts["frozen"]
    for g in grads:
        jp, js = jopt.fused_update(jp, {n: jnp.asarray(x)
                                        for n, x in g.items()}, js,
                                   np.float32(LR))
        tp, ts = topt.fused_update(tp, {n: torch.from_numpy(x)
                                        for n, x in g.items()}, ts, LR)
    assert ts["frozen"] is frozen_state
    np.testing.assert_array_equal(tp["frozen"].numpy(), params["frozen"])
    for n in params:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   err_msg=n, **TOL)
        assert set(ts[n]) == set(js[n])
        for k, v in ts[n].items():
            assert v.dtype == torch.float32, (n, k)
            np.testing.assert_allclose(v.numpy(), np.asarray(js[n][k]),
                                       err_msg=f"{n}.{k}", **TOL)
    # the rule moved the parameters that had gradients
    assert not np.allclose(tp["w"].numpy(), params["w"])


def test_lamb_trust_ratio_is_per_parameter():
    """Scaling one parameter scales its own step (the trust ratio
    follows ||p||) and leaves the other's unchanged."""
    opt = popt.Lamb(learning_rate=LR, lamb_weight_decay=0.0)
    rng = np.random.default_rng(2)
    p = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
         for n, s in (("a", (4, 4)), ("b", (6,)))}
    g = {n: torch.from_numpy(rng.standard_normal(t.shape).astype(
        np.float32)) for n, t in p.items()}

    def steps(params):
        st = {n: opt.init_state(t) for n, t in params.items()}
        new, _ = opt.fused_update(params, g, st, LR)
        return {n: params[n] - new[n] for n in params}

    base = steps(p)
    scaled = steps({"a": 10 * p["a"], "b": p["b"]})
    torch.testing.assert_close(scaled["a"], 10 * base["a"], rtol=1e-4,
                               atol=0)
    torch.testing.assert_close(scaled["b"], base["b"], rtol=0, atol=0)


def _compiled_step(opt):
    return TrainStep(torch.nn.Linear(2, 2), lambda m, x, generator: m(x)
                     .sum(), opt, device="cpu")


@pytest.mark.parametrize("build", [
    lambda: _compiled_step(popt.SGD(grad_clip=ClipGradByGlobalNorm(1.0))),
    lambda: _compiled_step(popt.Momentum(weight_decay=popt.L2Decay(0.1))),
    lambda: popt.Adagrad(learning_rate=lambda: 0.1),
    lambda: _compiled_step(popt.Lamb(
        exclude_from_weight_decay_fn=lambda n: "bias" in n)),
    lambda: _compiled_step(popt.RMSProp(0.1, grad_clip=ClipGradByNorm(
        1.0)))],
    ids=["grad_clip", "regularizer", "lr_lambda", "lamb_exclude_fn",
         "rmsprop_grad_clip"])
def test_what_the_compiled_step_never_applies_raises(build):
    """The eager step applies gradient clipping, regularizer objects and
    Lamb's exclude function (``test_torch_eager_optimizer.py``); the
    compiled step, which the JAX package runs without them, refuses an
    optimizer that carries one.  A callable learning rate raises on
    every path."""
    with pytest.raises(NotImplementedError):
        build()


@pytest.mark.parametrize("option", [
    dict(grad_clip=ClipGradByValue(0.5)),
    dict(weight_decay=popt.L2Decay(0.01)),
    dict(apply_decay_param_fun=lambda n: True)],
    ids=["grad_clip", "regularizer", "apply_decay_param_fun"])
def test_static_minimize_refuses_what_it_never_applies(option):
    from paddle_tpu_torch import static

    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        loss = static.nn.mean(static.nn.fc(static.data("x", [2, 3]), 2))
        with pytest.raises(NotImplementedError, match="static minimize"):
            popt.AdamW(0.1, **option).minimize(loss)


@pytest.mark.parametrize("build", [
    lambda: popt.SGD(weight_decay=popt.L1Decay(0.1)),
    lambda: popt.Momentum(weight_decay=object()),
    lambda: ParamAttr(regularizer=popt.L1Decay(0.1)),
    lambda: popt.AdamW(lr_ratio=0.5)],
    ids=["l1_decay", "unknown_regularizer", "param_l1_decay", "lr_ratio"])
def test_what_no_path_applies_raises(build):
    with pytest.raises(NotImplementedError, match="not ported|must be"):
        build()
