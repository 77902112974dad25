"""Port parity: the dygraph conv-net layers and the vision models
(``paddle_tpu_torch.nn``, ``paddle_tpu_torch.vision.models``) against the
JAX package's eager layers, on the same seeded numpy inputs and the JAX
layer's ``state_dict()`` carried across (``models.layer_from_numpy``).

Layers: output, the input's gradient and every parameter's gradient
under one random cotangent, and a batch norm's running stats, each
within 1e-5 of the JAX tensor's largest magnitude.  Models: logits in
eval and train mode, the loss, every parameter's gradient and the
running stats after the train pass, within 1e-5 of each tensor's
largest magnitude (fp32, summation orders differ), or within the
reference's own spread (`hold_model`).  A model's JAX passes are
traced into jitted functions; its op-by-op outputs come from eager JAX
layers.
"""
import math

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.core.tensor import _wrap_data
from jax_static_start import numpy_initializers
from torch_op_parity import with_params
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.models import layer_from_numpy, layer_to_numpy
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.vision import models as pmodels

TOL = 1e-5


def share(got, want):
    """|got - want| at its largest over want's largest magnitude."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def jax_state(layer):
    return {n: np.asarray(t._data) for n, t in layer.state_dict().items()}


def carried(jlayer, port_layer):
    """`port_layer` on the CPU holding `jlayer`'s state."""
    return layer_from_numpy(port_layer, jax_state(jlayer), device="cpu")


def run_layer(jlayer, player, x, seed=0):
    """Output, input gradient and parameter gradients of both layers
    under one random cotangent."""
    out_j = jlayer(xj := paddle.to_tensor(x, stop_gradient=False))
    cot = np.random.default_rng(seed).standard_normal(
        out_j.shape).astype(np.float32)
    paddle.sum(out_j * paddle.to_tensor(cot)).backward()
    xp = torch.from_numpy(x).requires_grad_()
    out_p = player(xp)
    (out_p * torch.from_numpy(cot)).sum().backward()
    want = {"out": np.asarray(out_j._data), "x@grad": np.asarray(
        xj.grad._data)}
    want.update({f"{n}@grad": np.asarray(p.grad._data)
                 for n, p in jlayer.named_parameters()})
    got = {"out": out_p.detach().numpy(), "x@grad": xp.grad.numpy()}
    got.update({f"{n}@grad": p.grad.numpy()
                for n, p in player.named_parameters()})
    return got, want


def assert_close(got, want, tol=TOL):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for n in want:
        err = share(got[n], want[n])
        assert err <= tol, f"{n}: {err:.3e} of its largest magnitude"


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


CONVS = {
    "plain": dict(in_channels=3, out_channels=5, kernel_size=3),
    "stride-padding": dict(in_channels=3, out_channels=4, kernel_size=3,
                           stride=2, padding=1),
    "groups-no-bias": dict(in_channels=4, out_channels=6, kernel_size=3,
                           padding=1, groups=2, bias_attr=False),
    "depthwise": dict(in_channels=4, out_channels=4, kernel_size=3,
                      padding=[1, 2], groups=4),
    "asymmetric-padding-dilation": dict(in_channels=3, out_channels=2,
                                        kernel_size=[2, 3],
                                        padding=[0, 1, 2, 1], dilation=2),
}


@pytest.mark.parametrize("case", list(CONVS))
def test_conv2d_matches_jax(case):
    kw = CONVS[case]
    paddle.seed(3)
    jl = paddle.nn.Conv2D(**kw)
    pl = carried(jl, pnn.Conv2D(**kw, generator=torch.Generator(),
                                device="cpu"))
    assert (pl.bias is None) == (kw.get("bias_attr") is False)
    assert_close(*run_layer(jl, pl, _x((2, kw["in_channels"], 9, 8))))


POOLS = {
    "max-3-2-1": ("MaxPool2D", dict(kernel_size=3, stride=2, padding=1)),
    "max-2": ("MaxPool2D", dict(kernel_size=2, stride=2)),
    "avg-exclusive-padded": ("AvgPool2D", dict(kernel_size=3, stride=2,
                                               padding=1)),
    "avg-inclusive-padded": ("AvgPool2D", dict(kernel_size=3, stride=1,
                                               padding=1, exclusive=False)),
    "avg-2": ("AvgPool2D", dict(kernel_size=2)),
    "adaptive-divisible": ("AdaptiveAvgPool2D", dict(output_size=3)),
    "adaptive-non-divisible": ("AdaptiveAvgPool2D",
                               dict(output_size=(4, 3))),
    "adaptive-upsampling": ("AdaptiveAvgPool2D", dict(output_size=7)),
}


@pytest.mark.parametrize("case", list(POOLS))
def test_pools_match_jax(case):
    name, kw = POOLS[case]
    jl, pl = getattr(paddle.nn, name)(**kw), getattr(pnn, name)(**kw)
    x = _x((2, 3, 9, 7)) if case != "adaptive-upsampling" else _x(
        (2, 3, 2, 2))
    assert_close(*run_layer(jl, pl, x))


@pytest.mark.parametrize("call", [
    lambda x: PF.max_pool2d(x, 2, ceil_mode=True),
    lambda x: PF.max_pool2d(x, 2, return_mask=True),
    lambda x: PF.avg_pool2d(x, 2, divisor_override=3)],
    ids=["ceil_mode", "return_mask", "divisor_override"])
def test_unported_pool_and_conv_options_raise(call):
    """The pool options the JAX 2-D pools ignore or answer None for;
    string and uneven paddings and NHWC are held against JAX in
    ``test_torch_pool_layers.py`` and ``test_torch_conv_layers.py``."""
    with pytest.raises(NotImplementedError, match="not ported"):
        call(torch.zeros(1, 3, 6, 6))


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_batch_norm_2d_matches_jax(training):
    """Train mode: the batch's mean and biased variance normalise, and
    the running stats move by ``m * 0.9 + stat * 0.1`` (not PyTorch's
    unbiased variance); eval mode: the running stats normalise."""
    rng = np.random.default_rng(4)
    jl = paddle.nn.BatchNorm2D(5)
    jl.weight.set_value(rng.uniform(0.5, 1.5, 5).astype(np.float32))
    jl.bias.set_value(rng.standard_normal(5).astype(np.float32))
    jl._mean.set_value(rng.standard_normal(5).astype(np.float32))
    jl._variance.set_value(rng.uniform(0.5, 2, 5).astype(np.float32))
    pl = carried(jl, pnn.BatchNorm2D(5, device="cpu"))
    jl.train() if training else jl.eval()
    pl.train(training)
    x = 3 * _x((4, 5, 3, 2)) + 1
    before = jax_state(jl)
    got, want = run_layer(jl, pl, x)
    got.update({f"{n}@after": v for n, v in layer_to_numpy(pl).items()})
    want.update({f"{n}@after": v for n, v in jax_state(jl).items()})
    assert_close(got, want)
    moved = not np.allclose(want["_mean@after"], before["_mean"])
    assert moved == training


@pytest.mark.parametrize("name", ["ReLU6", "ReLU", "Flatten"])
def test_activations_and_flatten_match_jax(name):
    jl, pl = getattr(paddle.nn, name)(), getattr(pnn, name)()
    assert_close(*run_layer(jl, pl, 4 * _x((2, 3, 4, 5))))


def test_sequential_and_linear_keep_jax_names():
    paddle.seed(0)
    jl = paddle.nn.Sequential(paddle.nn.Linear(3, 4),
                              paddle.nn.Linear(4, 2, bias_attr=False))
    pl = pnn.Sequential(pnn.Linear(3, 4, generator=torch.Generator()),
                        pnn.Linear(4, 2, bias_attr=False,
                                   generator=torch.Generator()))
    assert list(pl.state_dict()) == list(jl.state_dict()) == [
        "0.weight", "0.bias", "1.weight"]
    pl = carried(jl, pl)
    assert_close(*run_layer(jl, pl, _x((5, 3))))
    assert [n for n, _ in pnn.LayerList([pnn.ReLU(), pl]).named_children()
            ] == ["0", "1"]


def test_layer_from_numpy_refuses_a_mismatch():
    net = pmodels.LeNet(device="cpu")
    named = layer_to_numpy(net)
    with pytest.raises(ValueError, match="missing"):
        layer_from_numpy(net, {k: v for k, v in named.items()
                               if k != "fc.0.bias"}, device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        layer_from_numpy(net, {**named, "fc.3.bias": named["fc.0.bias"]},
                         device="cpu")
    with pytest.raises(ValueError, match="shape"):
        layer_from_numpy(net, {**named, "fc.0.bias": named["fc.1.bias"]},
                         device="cpu")


# ------------------------------ models ---------------------------------

MODELS = {
    "lenet": (lambda m, **kw: m.LeNet(**kw), (4, 1, 28, 28), 10),
    "resnet18": (lambda m, **kw: m.resnet18(num_classes=10, **kw),
                 (2, 3, 64, 64), 10),
    "resnet50": (lambda m, **kw: m.resnet50(num_classes=10, **kw),
                 (2, 3, 64, 64), 10),
    "vgg11": (lambda m, **kw: m.vgg11(num_classes=10, **kw),
              (2, 3, 32, 32), 10),
    "mobilenet_v1": (lambda m, **kw: m.mobilenet_v1(
        scale=0.25, num_classes=10, **kw), (2, 3, 32, 32), 10),
    "mobilenet_v2": (lambda m, **kw: m.mobilenet_v2(
        scale=0.25, num_classes=10, **kw), (2, 3, 32, 32), 10),
}
# A train pass at B 2 is ill-conditioned in the reference itself: batch
# norm's E[x²] − mean² over a few values per channel cancels, and ReLUs
# near 0 take the other side, so the JAX pass on the batch in reversed
# row order moves the JAX pass's gradients (one norm over all of them).
# Against that spread: op by op (each layer on the JAX call's own
# input and output cotangent) every output within TOL or OP_FACTOR x the
# JAX layer's own spread on that call (worst 0.76 x, the ResNets' first
# batch norm at 1.6e-5); end to end within TOL or END_FACTOR x the
# reversed pass's.  Neither bound passes CAP, so a zeroed (1.0) or halved
# (0.5) gradient fails whatever the spread.  Gradients, port / spread:
# LeNet 2.36e-7 / 6.56e-8 and VGG-11 7.47e-7 / 4.54e-8 (within TOL),
# ResNet-18 1.05e-2 / 1.05e-2, ResNet-50 4.27e-2 / 7.01e-2 (CAP bounds
# it), MobileNet V1 1.63e-3 / 4.54e-3, V2 3.02e-2 / 1.16e-1 (CAP); the
# logits, loss and running stats past TOL at most 0.68 x their spread
OP_FACTOR = 2
END_FACTOR = 10
CAP = 0.1
# From numpy draws MobileNet V1's spread is 2.77e-1 (the port 2.08e-1),
# past CAP: it builds from the JAX package's own seeded initializers.
SEEDED = {"mobilenet_v1"}


def _dropout_off(model, layer_type):
    for m in (model.sublayers() if hasattr(model, "sublayers")
              else model.modules()):
        if isinstance(m, layer_type):
            m.p = 0.0


def _traced(jnet, fn):
    """``call(datas, *args)``: `fn(*args)` with `jnet`'s parameters' data
    swapped for `datas` (`with_params`), so that a pass is one jitted
    function instead of a compile per eager op."""
    params = [p for _, p in jnet.named_parameters()]
    return lambda datas, *args: with_params(params, datas,
                                            lambda: fn(*args))


def _datas(jnet):
    return [p._data for _, p in jnet.named_parameters()]


def _jax_eval(jnet, x):
    jnet.eval()
    try:
        fn = _traced(jnet, lambda v: jnet(_wrap_data(v))._data)
        return np.asarray(jax.jit(fn)(_datas(jnet), x))
    finally:
        jnet.train()


class _JaxTrain:
    """A JAX train pass (from zero gradients) traced into one jitted value
    and gradient, reused for the batch in reversed row order: logits,
    loss, every parameter's gradient, and each leaf layer call's name,
    input, output and output cotangent in call order (a cotangent is the
    gradient of a zero added to the call's output).  Inside the trace
    the batch norms leave their running stats be (`_jax_eager` moves
    them)."""

    def __init__(self, jnet, x, lbl):
        self.jnet = jnet
        self.leaves = [(n, layer) for n, layer in jnet.named_sublayers()
                       if not layer._sub_layers]
        self.names = [n for n, _ in jnet.named_parameters()]
        shapes = jax.eval_shape(self._loss, _datas(jnet), x, lbl, None)
        self.probes = [jnp.zeros(o.shape, o.dtype) for o in shapes[1][2]]
        self.step = jax.jit(jax.value_and_grad(self._loss, argnums=(0, 3),
                                               has_aux=True))

    def _loss(self, datas, x, lbl, probes):
        calls = []

        def hook(name):
            def record(layer, inputs, output):
                out = output._data
                if probes is not None:
                    out = out + probes[len(calls)]
                calls.append((name, layer, inputs[0]._data, out))
                return _wrap_data(out)
            return record

        def run(v, lv):
            handles = [layer.register_forward_post_hook(hook(name))
                       for name, layer in self.leaves]
            try:
                logits = self.jnet(_wrap_data(v))
                loss = paddle.mean(JF.softmax_with_cross_entropy(
                    logits, _wrap_data(lv)))
            finally:
                for h in handles:
                    h.remove()
            return loss._data, logits._data

        loss, logits = _traced(self.jnet, run)(datas, x, lbl)
        self.call_names = [c[0] for c in calls]
        return loss, (logits, [c[2] for c in calls], [c[3] for c in calls])

    def __call__(self, x, lbl):
        (loss, (logits, xs, outs)), (grads, cots) = self.step(
            _datas(self.jnet), x, lbl, self.probes)
        want = {"train": np.asarray(logits), "loss": np.asarray(loss)}
        want.update({f"{n}@grad": np.asarray(g)
                     for n, g in zip(self.names, grads)})
        calls = [dict(name=n, x=np.asarray(xv), out=np.asarray(o),
                      cot=np.asarray(c))
                 for n, xv, o, c in zip(self.call_names, xs, outs, cots)]
        return want, calls


def _jax_eager(jnet, calls, flip=False):
    """Each JAX leaf layer called eagerly on its call's input (the
    batch's rows reversed if `flip`), in call order from the model's
    state: the outputs, and the running stats after, as the JAX batch
    norms move them.  The state is then put back.  Eager, each primitive
    is one XLA computation; in one jitted program XLA fuses a batch
    norm's ``E[x²] − mean²`` with other roundings, which over a channel
    of two values moves the output past TOL."""
    order = _flip if flip else np.ascontiguousarray
    layers = dict(jnet.named_sublayers())
    saved = {n: t._data for n, t in jnet.state_dict().items()}
    try:
        with paddle.no_grad():
            outs = [np.asarray(layers[rec["name"]](paddle.to_tensor(
                order(rec["x"])))._data) for rec in calls]
        return outs, {n: v for n, v in jax_state(jnet).items()
                      if n.endswith(STATS)}
    finally:
        for n, t in jnet.state_dict().items():
            t._data = saved[n]


def _jax_replay(jnet, calls):
    """Each JAX leaf layer on its call's input and output cotangent with
    the batch's rows reversed (the reference's own spread op by op), in
    one jitted gradient: the parameters' gradients summed over the
    calls."""
    layers = dict(jnet.named_sublayers())

    def loss(datas, xs, cots):
        def run():
            return sum(jnp.sum(layers[rec["name"]](_wrap_data(xv))._data * c)
                       for rec, xv, c in zip(calls, xs, cots))
        return _traced(jnet, run)(datas)

    grads = jax.jit(jax.grad(loss))(_datas(jnet),
                                    [_flip(r["x"]) for r in calls],
                                    [_flip(r["cot"]) for r in calls])
    return {f"{n}@grad": np.asarray(g) for (n, _), g in zip(
        jnet.named_parameters(), grads)}


def _flip(a):
    return np.ascontiguousarray(a[::-1])


STATS = ("_mean", "_variance")


def replay(jnet, pnet, calls, jax_grads):
    """Each leaf layer call of the JAX train pass on `pnet` (the port
    model at the pass's starting state, as `jnet` is), from the JAX
    call's input and output cotangent: the output and the running stats
    after against the eager JAX layer's on that input (`_jax_eager`),
    the parameter gradients against the JAX pass's.  Beside each, the
    reference's own spread: the JAX layer on the same call from the same
    state with the batch's rows reversed (`_jax_eager`, `_jax_replay`).
    Returns {what: (share, spread)} and the JAX running stats after."""
    modules = dict(pnet.named_modules())
    outs, jax_after = _jax_eager(jnet, calls)
    spread_outs, spread_after = _jax_eager(jnet, calls, flip=True)
    grads_spread = _jax_replay(jnet, calls)
    err = {}
    for i, rec in enumerate(calls):
        layer = modules[rec["name"]]
        x = torch.from_numpy(rec["x"].copy()).requires_grad_()
        out = layer(x)
        err[f"{rec['name']}#{i}"] = (
            share(out.detach().numpy(), outs[i]),
            share(_flip(spread_outs[i]), outs[i]))
        out.backward(torch.from_numpy(rec["cot"].copy()))
    grads = {f"{n}@grad": p.grad.numpy() for n, p in
             pnet.named_parameters()}
    err["gradients"] = (rel_l2(grads, jax_grads), rel_l2(grads_spread,
                                                         jax_grads))
    stats = {n: v for n, v in layer_to_numpy(pnet).items()
             if n.endswith(STATS)}
    if stats:
        err["running stats"] = (rel_l2(stats, jax_after), rel_l2(
            {n: spread_after[n] for n in stats}, jax_after))
    return err, jax_after


def rel_l2(got, want):
    """||got - want|| / ||want|| over the tensors of `got` together."""
    diff = sum(float(np.square(got[n] - want[n], dtype=np.float64).sum())
               for n in got)
    ref = sum(float(np.square(want[n], dtype=np.float64).sum())
              for n in got)
    return math.sqrt(diff / max(ref, 1e-300))


def _past(err, factor):
    return {n: e for n, e in err.items()
            if e[0] > max(TOL, min(factor * e[1], CAP))}


def hold_model(name):
    """Eval logits within TOL; a train pass held op by op (`replay`)
    and end to end (logits, loss, all gradients as one norm and all
    running stats as one), each against the reference's own spread.
    VGG's dropouts are set to p = 0 in both packages (their masks come
    from different random streams).  The JAX model runs traced: its eval
    pass, its train pass (`_JaxTrain`, again for the spread on the
    reversed batch) and its op-by-op replays (`_jax_replay`) are one
    jitted function each; its op-by-op outputs and its running stats
    after each pass come from its layers called eagerly on the pass's
    recorded inputs (`_jax_eager`).  Returns both {what: (share,
    spread)}."""
    build, shape, classes = MODELS[name]
    if name in SEEDED:
        paddle.seed(0)
        jnet = build(paddle.vision.models)
    else:
        with numpy_initializers(0):
            jnet = build(paddle.vision.models)
    start = jax_state(jnet)
    pnet = carried(jnet, build(pmodels, device="cpu"))
    _dropout_off(jnet, paddle.nn.Dropout)
    _dropout_off(pnet, pnn.Dropout)
    assert [n for n, _ in pnet.named_parameters()] == [
        n for n, _ in jnet.named_parameters()]
    rng = np.random.RandomState(0)
    x = rng.rand(*shape).astype(np.float32)
    lbl = rng.randint(0, classes, (shape[0], 1)).astype(np.int64)

    pnet.eval()
    with torch.no_grad():
        assert_close({"eval": pnet(torch.from_numpy(x)).numpy()},
                     {"eval": _jax_eval(jnet, x)})

    jnet.train()
    pnet.train()
    train = _JaxTrain(jnet, x, lbl)
    want, calls = train(x, lbl)
    op_err, jax_after = replay(jnet, pnet, calls, want)
    assert not _past(op_err, OP_FACTOR), \
        f"op by op past the bound: {_past(op_err, OP_FACTOR)}"
    want.update({f"{n}@after": v for n, v in {**start, **jax_after}.items()})

    # the reference's own spread: the same pass on the reversed batch
    spread, spread_calls = train(_flip(x), _flip(lbl))
    spread["train"] = _flip(spread["train"])
    spread.update({f"{n}@after": v for n, v in
                   {**start, **_jax_eager(jnet, spread_calls)[1]}.items()})

    layer_from_numpy(pnet, start, device="cpu")
    for p in pnet.parameters():
        p.grad = None
    p_logits = pnet(torch.from_numpy(x))
    p_loss = PF.softmax_with_cross_entropy(p_logits,
                                           torch.from_numpy(lbl)).mean()
    p_loss.backward()
    got = {"train": p_logits.detach().numpy(),
           "loss": p_loss.detach().numpy()}
    got.update({f"{n}@grad": p.grad.numpy()
                for n, p in pnet.named_parameters()})
    got.update({f"{n}@after": v for n, v in layer_to_numpy(pnet).items()})
    assert set(got) == set(want) == set(spread)
    end_err = {n: (share(got[n], want[n]), share(spread[n], want[n]))
               for n in ("train", "loss")}
    for kind in ("@grad", "@after"):
        names = [n for n in want if n.endswith(kind)]
        end_err[kind] = (rel_l2({n: got[n] for n in names}, want),
                         rel_l2({n: spread[n] for n in names}, want))
    assert not _past(end_err, END_FACTOR), \
        f"end to end past the bound: {_past(end_err, END_FACTOR)}"
    return op_err, end_err


@pytest.mark.parametrize("name", ["lenet"])
def test_model_matches_jax(name):
    """VGG-11 is held the same way in ``test_torch_vision_vgg.py``."""
    hold_model(name)


def test_vgg_dropout_draws_from_the_model_generator():
    """In train mode VGG's classifier drops from generators seeded by the
    model's generator: the same seed repeats the logits, another seed or
    eval mode changes them."""
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 3, 32, 32)
                         .astype(np.float32))

    def logits(seed, train=True):
        net = pmodels.vgg11(num_classes=10, device="cpu",
                            generator=torch.Generator().manual_seed(seed))
        net.train(train)
        with torch.no_grad():
            return net(x), net(x)

    (a1, a2), (b1, _) = logits(1), logits(1)
    torch.testing.assert_close(a1, b1, rtol=0, atol=0)
    assert not torch.equal(a1, a2)       # the stream advances per call
    c1, _ = logits(2)
    net_eval, _ = logits(1, train=False)
    assert not torch.allclose(a1, c1) and not torch.allclose(a1, net_eval)


def test_models_default_to_the_card_and_never_fall_back():
    for build in (pmodels.LeNet, lambda: pmodels.resnet18(num_classes=10),
                  lambda: pmodels.mobilenet_v2(scale=0.25)):
        if torch.cuda.is_available():
            assert next(build().parameters()).device.type == "cuda"
            continue
        with pytest.raises(RuntimeError, match="needs CUDA"):
            build()
    with pytest.raises(NotImplementedError, match="pretrained"):
        pmodels.resnet50(pretrained=True, device="cpu")


def test_lenet_memorizes_a_small_set():
    """The port's LeNet with Adam memorizes 64 fixed samples to at least
    95% train accuracy, as ``tests/test_convergence.py`` asks of the JAX
    package's (Adam 2e-3, at most 120 steps)."""
    from paddle_tpu_torch.optimizer import Adam

    rng = np.random.RandomState(0)
    imgs = torch.from_numpy(rng.rand(64, 1, 28, 28).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 10, (64, 1)).astype(np.int64))
    net = pmodels.LeNet(generator=torch.Generator().manual_seed(0),
                        device="cpu")
    opt = Adam(learning_rate=2e-3, parameters=net.parameters())
    acc = 0.0
    for step in range(120):
        logits = net(imgs)
        loss = PF.softmax_with_cross_entropy(logits, labels).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        if step % 20 == 19:
            acc = float((logits.argmax(-1) == labels[:, 0]).float().mean())
            if acc >= 0.95:
                break
    assert acc >= 0.95, f"LeNet failed to memorize: acc={acc}"
