"""Port parity: the LR schedulers (``paddle_tpu_torch.optimizer.lr``)
against the JAX package's ``paddle_tpu.optimizer.lr``, and how an
optimizer and the train step use one.

Each of the 14 schedulers is built alike in both packages and read 30
times (``sched()`` after construction, then after each of 29 ``step()``
calls); the rates agree to 1e-12 relative (the same Python float
arithmetic in one order, so in practice bitwise).
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import paddle_tpu.optimizer.lr as jlr
from paddle_tpu_torch.optimizer import SGD, AdamW
from paddle_tpu_torch.optimizer import lr as plr
from paddle_tpu_torch.parallel import TrainStep

READS = 30
# ReduceOnPlateau's metric per step: falls, stalls past patience twice,
# falls again
PLATEAU = [5.0, 4.0, 3.0] + [3.0] * 6 + [2.0, 1.9] + [1.9] * 8 + \
    [1.0] * 10


def _cases():
    return {
        "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=10,
                                           learning_rate=2.0),
        "PiecewiseDecay": lambda m: m.PiecewiseDecay(
            [5, 12, 20], [0.1, 0.05, 0.01, 0.001]),
        "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.5, gamma=0.1),
        "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.5, gamma=0.2),
        "PolynomialDecay": lambda m: m.PolynomialDecay(
            0.5, decay_steps=12, end_lr=0.01, power=2.0),
        "PolynomialDecay-cycle": lambda m: m.PolynomialDecay(
            0.5, decay_steps=7, end_lr=0.01, power=1.5, cycle=True),
        "LinearWarmup-over-PolynomialDecay": lambda m: m.LinearWarmup(
            m.PolynomialDecay(0.5, decay_steps=10, end_lr=0.05),
            warmup_steps=5, start_lr=0.0, end_lr=0.5),
        "LinearWarmup-over-float": lambda m: m.LinearWarmup(
            0.3, warmup_steps=8, start_lr=0.01, end_lr=0.3),
        "ExponentialDecay": lambda m: m.ExponentialDecay(0.5, gamma=0.9),
        "MultiStepDecay": lambda m: m.MultiStepDecay(
            0.5, milestones=[4, 9, 15], gamma=0.5),
        "StepDecay": lambda m: m.StepDecay(0.5, step_size=7, gamma=0.3),
        "StepDecay-last_epoch": lambda m: m.StepDecay(
            0.5, step_size=4, gamma=0.5, last_epoch=6),
        "LambdaDecay": lambda m: m.LambdaDecay(
            0.5, lr_lambda=lambda e: 0.95 ** e + 0.01 * (e % 3)),
        "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(
            0.5, patience=2, cooldown=1, factor=0.5, min_lr=0.01),
        "ReduceOnPlateau-max-abs": lambda m: m.ReduceOnPlateau(
            0.5, mode="max", threshold_mode="abs", threshold=0.5,
            patience=1),
        "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
            0.5, T_max=10, eta_min=0.01),
        "OneCycleLR": lambda m: m.OneCycleLR(0.5, total_steps=25),
        "CyclicLR-triangular": lambda m: m.CyclicLR(
            0.01, 0.5, step_size_up=4, step_size_down=6),
        "CyclicLR-triangular2": lambda m: m.CyclicLR(
            0.01, 0.5, step_size_up=5, mode="triangular2"),
        "CyclicLR-exp_range": lambda m: m.CyclicLR(
            0.01, 0.5, step_size_up=3, mode="exp_range", exp_gamma=0.9),
    }


def _reads(sched):
    out = [sched()]
    for i in range(READS - 1):
        if type(sched).__name__ == "ReduceOnPlateau":
            sched.step(PLATEAU[i])
        else:
            sched.step()
        out.append(sched())
    return out


def test_every_scheduler_class_is_ported_and_covered():
    classes = {n for n, c in vars(jlr).items() if isinstance(c, type)
               and issubclass(c, jlr.LRScheduler) and c is not jlr.LRScheduler}
    assert len(classes) == 14
    assert classes == {n for n, c in vars(plr).items()
                       if isinstance(c, type)
                       and issubclass(c, plr.LRScheduler)
                       and c is not plr.LRScheduler}
    assert classes == {k.split("-")[0] for k in _cases()}


@pytest.mark.parametrize("name", list(_cases()))
def test_first_rates_match_jax(name):
    build = _cases()[name]
    want, got = _reads(build(jlr)), _reads(build(plr))
    assert all(isinstance(x, float) for x in got), got
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    # the rates move: a constant run would hide a wrong epoch count
    assert len(set(got)) > 1


@pytest.mark.parametrize("name", ["StepDecay", "PolynomialDecay",
                                  "LinearWarmup-over-PolynomialDecay"])
def test_epoch_contract_and_state_dict_match_jax(name):
    """The constructor's own step() (last_epoch -1 -> 0), an explicit
    step(epoch), and a state_dict carried into a fresh scheduler."""
    build = _cases()[name]
    j, p = build(jlr), build(plr)
    assert j.last_epoch == p.last_epoch == 0
    for s in (j, p):
        s.step()
        s.step(epoch=9)
    assert p.state_dict() == j.state_dict()
    fresh = build(plr)
    fresh.set_state_dict(p.state_dict())
    assert fresh() == p() and fresh.last_epoch == 9


def test_optimizer_reads_the_scheduler():
    sched = plr.StepDecay(0.5, step_size=2, gamma=0.1)
    opt = AdamW(learning_rate=sched)
    assert opt.get_lr() == 0.5 and isinstance(opt.get_lr(), float)
    sched.step()
    sched.step()
    assert opt.get_lr() == pytest.approx(0.05, rel=1e-15)


class _Scale(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor([1.0, -2.0, 3.0]))


def test_train_step_reads_the_rate_before_the_update_then_steps():
    """SGD moves w by exactly lr * grad: each step uses the rate of the
    scheduler's epoch before that step, then advances it by one."""
    sched = plr.MultiStepDecay(0.5, milestones=[1, 2], gamma=0.1)
    model = _Scale()
    tr = TrainStep(model, lambda m, x, generator: (m.w * x).sum(),
                   SGD(learning_rate=sched), device="cpu")
    x = torch.tensor([1.0, 2.0, 4.0])
    want = [0.5, 0.05, 0.005]
    for k, rate in enumerate(want):
        before = model.w.detach().clone()
        tr.step(x)
        torch.testing.assert_close(before - model.w.detach(),
                                   torch.tensor(rate) * x, rtol=1e-6,
                                   atol=0)
        assert sched.last_epoch == k + 1
