"""Port parity: a CycleGAN training iteration (``chip_smoke.py``'s
`cyclegan_nets`, one definition built in each package from its own
layers: reflection pads, convolutions, transposed convolutions with an
output padding, affine-free instance norms, LSGAN, cycle and identity
losses, Adam 2e-4 with beta1 0.5) at a small size (ngf = ndf = 8, two
residual blocks, 32x32, batch 1), the port carrying the JAX networks'
weights.  Over two iterations every loss term matches the JAX
package's within 1e-5 relative, and every parameter after each
iteration within 1e-4 of its tensor's largest magnitude and within
2 x iterations x lr (the bound of ``test_torch_book_models.py``).  The
JAX iteration is traced into one jitted function (its generators' and
discriminators' value and gradient, then the JAX Adam ``update``).
`flops` counts the small generator as the JAX package does."""
import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import chip_smoke
import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from jax_static_start import numpy_initializers
from paddle_tpu.core.tensor import _wrap_data
from paddle_tpu_torch import hapi
from paddle_tpu_torch.models import layer_from_numpy, layer_to_numpy
from torch_op_parity import with_params

SMALL = dict(chip_smoke.CYCLEGAN, ngf=8, ndf=8, blocks=2, image=32)
ITERS = 2
LOSS_TOL, PARAM_TOL = 1e-5, 1e-4
NAMES = chip_smoke.CYCLEGAN_NETS


def _jax_nets(c=SMALL):
    gen_cls, disc_cls = chip_smoke.cyclegan_nets(jnn, jnn.Layer, {}, {})
    with numpy_initializers(5):
        return (gen_cls(c["ngf"], c["blocks"]), gen_cls(c["ngf"], c["blocks"]),
                disc_cls(c["ndf"]), disc_cls(c["ndf"]))


def _state(nets):
    return {f"{k}.{n}": np.asarray(t._data) for k, net in zip(NAMES, nets)
            for n, t in net.state_dict().items()}


def _jax_train(nets, images, c=SMALL):
    """ITERS iterations of the JAX networks, each one call of a jitted
    step: (losses of each iteration, {name: parameters after each})."""
    g_params = [p for net in nets[:2] for p in net.parameters()]
    d_params = [p for net in nets[2:] for p in net.parameters()]
    opts = [paddle.optimizer.Adam(learning_rate=c["lr"], beta1=c["beta1"],
                                  parameters=ps)
            for ps in (g_params, d_params)]

    def g_loss(gd, dd, ra, rb):
        def fn():
            loss, terms, fb, fa = chip_smoke.cyclegan_g_loss(
                paddle, JF, nets, _wrap_data(ra), _wrap_data(rb), c)
            return loss._data, ({k: v._data for k, v in terms.items()},
                                fb._data, fa._data)
        return with_params(g_params + d_params, list(gd) + list(dd), fn)

    def d_loss(dd, ra, rb, fb, fa):
        return with_params(d_params, dd, lambda: chip_smoke.cyclegan_d_loss(
            paddle, JF, nets, _wrap_data(ra), _wrap_data(rb),
            _wrap_data(fb), _wrap_data(fa))._data)

    def update(opt, datas, grads, states):
        new = [opt.update(d, g, s, c["lr"])
               for d, g, s in zip(datas, grads, states)]
        return [n[0] for n in new], [n[1] for n in new]

    @jax.jit
    def step(gd, dd, gs, ds, ra, rb):
        (lg, (terms, fb, fa)), gg = jax.value_and_grad(
            g_loss, has_aux=True)(gd, dd, ra, rb)
        ld, dg = jax.value_and_grad(d_loss)(dd, ra, rb, fb, fa)
        gd, gs = update(opts[0], gd, gg, gs)
        dd, ds = update(opts[1], dd, dg, ds)
        return dict(terms, G=lg, D=ld), gd, dd, gs, ds

    gd, dd = [p._data for p in g_params], [p._data for p in d_params]
    gs = [opts[0]._state_for(p) for p in g_params]
    ds = [opts[1]._state_for(p) for p in d_params]
    losses, after = [], []
    for _ in range(ITERS):
        out, gd, dd, gs, ds = step(gd, dd, gs, ds, *images)
        losses.append({k: float(v) for k, v in out.items()})
        for p, d in zip(g_params + d_params, list(gd) + list(dd)):
            p._data = d
        after.append(_state(nets))
    return losses, after


@pytest.fixture(scope="module")
def runs():
    jnets = _jax_nets()
    start = _state(jnets)
    rng = np.random.default_rng(0)
    images = chip_smoke.cyclegan_images(rng, SMALL)
    pnets = chip_smoke.port_cyclegan(SMALL, seed=1)
    for k, net in zip(NAMES, pnets):
        layer_from_numpy(net, {n[len(k) + 1:]: v for n, v in start.items()
                               if n.startswith(k + ".")}, device="cpu")
    jax_run = _jax_train(jnets, images)
    opts = chip_smoke.cyclegan_optimizers(pnets, SMALL)
    args = [torch.from_numpy(a) for a in images]
    p_losses, p_after = [], []
    for _ in range(ITERS):
        out = chip_smoke.cyclegan_iteration(pnets, opts, *args, c=SMALL)
        p_losses.append({k: float(v) for k, v in out.items()})
        p_after.append({f"{k}.{n}": v for k, net in zip(NAMES, pnets)
                        for n, v in layer_to_numpy(net).items()})
    return start, jax_run, (p_losses, p_after)


@pytest.mark.parametrize("it", range(ITERS))
def test_cyclegan_losses_match_jax(runs, it):
    _, (j_losses, _), (p_losses, _) = runs
    assert set(p_losses[it]) == set(j_losses[it]) == {
        "G_A", "G_B", "cycle_A", "cycle_B", "idt_A", "idt_B", "G", "D"}
    for k, want in j_losses[it].items():
        assert np.isfinite(p_losses[it][k])
        np.testing.assert_allclose(p_losses[it][k], want, rtol=LOSS_TOL,
                                   atol=0, err_msg=k)


@pytest.mark.parametrize("it", range(ITERS))
def test_cyclegan_parameters_match_jax_after_each_iteration(runs, it):
    start, (_, j_after), (_, p_after) = runs
    assert set(p_after[it]) == set(j_after[it]) == set(start)
    for n, want in j_after[it].items():
        diff = np.abs(p_after[it][n].astype(np.float64) - want)
        assert diff.max() <= 2 * (it + 1) * SMALL["lr"], n
        assert not np.array_equal(want, start[n]), n
        tol = PARAM_TOL * np.abs(want).max()
        assert diff.max() <= tol, (n, diff.max(), tol)


def test_cyclegan_generator_flops_match_jax():
    """`flops` of the small generator counts its convolutions, its
    transposed convolutions and its instance norms as JAX's does."""
    jgen = _jax_nets()[0]
    pgen = chip_smoke.port_cyclegan(SMALL)[0]
    size = [1, 3, SMALL["image"], SMALL["image"]]
    want = paddle.flops(jgen, size)
    assert hapi.flops(pgen, size) == want > 0
