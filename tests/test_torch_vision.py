"""Port parity: the dygraph conv-net layers and the vision models
(``paddle_tpu_torch.nn``, ``paddle_tpu_torch.vision.models``) against the
JAX package's eager layers, on the same seeded numpy inputs and the JAX
layer's ``state_dict()`` carried across (``models.layer_from_numpy``).

Layers: output, the input's gradient and every parameter's gradient
under one random cotangent, and a batch norm's running stats, each
within 1e-5 of the JAX tensor's largest magnitude.  Models: logits in
eval and train mode, the loss, every parameter's gradient and the
running stats after the train pass, within 1e-5 of each tensor's
largest magnitude (fp32, summation orders differ).
"""
import math

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
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
    pl = carried(jl, pnn.Conv2D(**kw, generator=torch.Generator()))
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
    lambda x: PF.avg_pool2d(x, 2, divisor_override=3),
    lambda x: PF.max_pool2d(x, 3, padding="SAME"),
    lambda x: PF.avg_pool2d(x, 3, padding=[0, 1, 1, 1]),
    lambda x: PF.conv2d(x, torch.ones(1, 3, 1, 1), padding="VALID"),
    lambda x: PF.adaptive_avg_pool2d(x, 2, data_format="NHWC"),
    lambda x: pnn.Conv2D(3, 2, 1, data_format="NHWC")],
    ids=["ceil_mode", "return_mask", "divisor_override", "string_padding",
         "asymmetric_pool_padding", "string_conv_padding", "nhwc_pool",
         "nhwc_conv"])
def test_unported_pool_and_conv_options_raise(call):
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
    pl = carried(jl, pnn.BatchNorm2D(5))
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
# row order moves logits by up to 9.4e-4 and the gradients (one norm
# over all of them) by up to 5.7e-2 of the JAX pass (ResNet-50, 64 px).
# Against that spread: op by op (each layer on the JAX call's own
# input and output cotangent) every output within TOL or OP_FACTOR x the
# JAX layer's own spread on that call (worst 0.88 x, two batch norms of
# 2048 values a channel at 1.6e-5); end to end within TOL or END_FACTOR x
# the reversed pass's (worst 3.8 x, MobileNetV1's logits)
OP_FACTOR = 2
END_FACTOR = 10


def _dropout_off(model, layer_type):
    for m in (model.sublayers() if hasattr(model, "sublayers")
              else model.modules()):
        if isinstance(m, layer_type):
            m.p = 0.0


def _jax_train(jnet, x, lbl, hooks=False):
    """Logits, loss and every parameter's gradient of one JAX train pass
    (from zero gradients); with `hooks`, also each leaf layer call's
    input, output and output cotangent, in call order."""
    for p in jnet.parameters():
        p.clear_grad()
    calls, handles = [], []
    if hooks:
        def hook(name):
            def record(layer, inputs, output):
                rec = dict(name=name, x=np.asarray(inputs[0]._data),
                           out=np.asarray(output._data))
                calls.append(rec)
                if not output.stop_gradient:
                    output.register_hook(
                        lambda cot: rec.update(cot=np.asarray(cot._data)))
            return record

        handles = [layer.register_forward_post_hook(hook(name))
                   for name, layer in jnet.named_sublayers()
                   if not layer._sub_layers]
    logits = jnet(paddle.to_tensor(x))
    loss = paddle.mean(JF.softmax_with_cross_entropy(
        logits, paddle.to_tensor(lbl)))
    loss.backward()
    for h in handles:
        h.remove()
    out = {"train": np.asarray(logits._data), "loss": np.asarray(
        loss._data)}
    out.update({f"{n}@grad": np.asarray(p.grad._data)
                for n, p in jnet.named_parameters()})
    return out, calls


def _flip(a):
    return np.ascontiguousarray(a[::-1])


STATS = ("_mean", "_variance")


def replay(jnet, pnet, calls, jax_grads, jax_start, jax_after):
    """Each leaf layer call of the JAX train pass on `pnet` (the port
    model at the pass's starting state `jax_start`), from the JAX call's
    input and output cotangent: the output, the layer's parameter
    gradients and its running stats after, against the JAX run's.
    Beside each, the reference's own spread: the JAX layer on the same
    call from the same state with the batch's rows reversed (its running
    stats put back after).  Returns {what: (share, spread)}."""
    modules = dict(pnet.named_modules())
    jlayers = dict(jnet.named_sublayers())
    err, spread_after = {}, {}
    for p in jnet.parameters():
        p.clear_grad()
    for i, rec in enumerate(calls):
        name = rec["name"]
        layer, jl = modules[name], jlayers[name]
        x = torch.from_numpy(rec["x"].copy()).requires_grad_()
        out = layer(x)
        stats = [n for n in STATS if hasattr(layer, n)]
        for n in stats:
            getattr(jl, n).set_value(jax_start[f"{name}.{n}"])
        jout = jl(paddle.to_tensor(_flip(rec["x"]), stop_gradient=False))
        for n in stats:
            spread_after[f"{name}.{n}"] = np.asarray(getattr(jl, n)._data)
            getattr(jl, n).set_value(jax_after[f"{name}.{n}"])
        err[f"{rec['name']}#{i}"] = (
            share(out.detach().numpy(), rec["out"]),
            share(_flip(np.asarray(jout._data)), rec["out"]))
        if "cot" in rec:
            out.backward(torch.from_numpy(rec["cot"].copy()))
            jout.backward(paddle.to_tensor(_flip(rec["cot"])))
    grads = {f"{n}@grad": p.grad.numpy() for n, p in
             pnet.named_parameters()}
    grads_spread = {f"{n}@grad": np.asarray(p.grad._data)
                    for n, p in jnet.named_parameters()}
    err["gradients"] = (rel_l2(grads, jax_grads), rel_l2(grads_spread,
                                                         jax_grads))
    stats = {n: v for n, v in layer_to_numpy(pnet).items()
             if n.endswith(STATS)}
    if stats:
        err["running stats"] = (rel_l2(stats, jax_after), rel_l2(
            {n: spread_after[n] for n in stats}, jax_after))
    return err


def rel_l2(got, want):
    """||got - want|| / ||want|| over the tensors of `got` together."""
    diff = sum(float(np.square(got[n] - want[n], dtype=np.float64).sum())
               for n in got)
    ref = sum(float(np.square(want[n], dtype=np.float64).sum())
              for n in got)
    return math.sqrt(diff / max(ref, 1e-300))


def _past(err, factor):
    return {n: e for n, e in err.items() if e[0] > max(TOL, factor * e[1])}


def hold_model(name):
    """Eval logits within TOL; a train pass held op by op (`replay`)
    and end to end (logits, loss, all gradients as one norm and all
    running stats as one), each against the reference's own spread.
    VGG's dropouts are set to p = 0 in both packages (their masks come
    from different random streams).  Returns both {what: (share,
    spread)}."""
    build, shape, classes = MODELS[name]
    paddle.seed(0)
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

    jnet.eval()
    pnet.eval()
    with torch.no_grad():
        assert_close({"eval": pnet(torch.from_numpy(x)).numpy()},
                     {"eval": np.asarray(jnet(paddle.to_tensor(x))._data)})

    jnet.train()
    pnet.train()
    want, calls = _jax_train(jnet, x, lbl, hooks=True)
    want.update({f"{n}@after": v for n, v in jax_state(jnet).items()})
    op_err = replay(jnet, pnet, calls, want, start, jax_state(jnet))
    assert not _past(op_err, OP_FACTOR), \
        f"op by op past the bound: {_past(op_err, OP_FACTOR)}"

    # the reference's own spread: the same pass on the reversed batch
    for n, t in jnet.state_dict().items():
        t.set_value(start[n])
    spread, _ = _jax_train(jnet, _flip(x), _flip(lbl))
    spread["train"] = _flip(spread["train"])
    spread.update({f"{n}@after": v for n, v in jax_state(jnet).items()})

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
    assert set(got) == set(want)
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
