"""Port parity: the activation, softmax, normalize and dropout functions
(``ops.nn_ops``), the losses (``ops.loss``), ``nn.functional``'s own
(`label_smooth`, `diag_embed`, `sequence_mask`, the in-place aliases),
the activation and loss layers and the containers, against the JAX
package's, on the same seeded numpy inputs, both on the CPU.

Each function or layer is one case: float outputs within 1e-6 of the
JAX tensor's largest magnitude, integer ones equal, and the gradient of
every float input (and of `PReLU`'s weight) under one random cotangent
within 1e-5.  Dropout's masks cannot equal JAX's draws: its
deterministic settings are held to JAX, and its masks to their rate,
scaling, axes and generator.  Every JAX result is computed once, at
module scope (traced into one jitted forward and gradient)."""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import ops
from paddle_tpu_torch.models import layer_from_numpy
from paddle_tpu_torch.nn import functional as PF
from torch_op_parity import case, hold, jax_traced, rand_f, rand_i, run

X = rand_f((3, 5), -4.0, 4.0, seed=1)
X4 = rand_f((2, 3, 4, 2), seed=2)
PROB = rand_f((4, 3), 0.05, 0.95, seed=3)
TARGET = rand_f((4, 3), 0.0, 1.0, seed=4)
LOGITS = rand_f((4, 6), seed=5)
LABEL = np.array([[1], [5], [0], [3]], np.int64)
IGNORED = np.array([[1], [-100], [0], [3]], np.int64)
SOFT = np.abs(rand_f((4, 6), seed=6)) / np.abs(rand_f((4, 6), seed=6)).sum(
    -1, keepdims=True)


def F(fname, *args, **kw):
    return case(fname, *args, ns="F", **kw)


def L(cls, *args, ctor=(), **kw):
    return case(cls, *args, ns="nn", ctor=ctor, **kw)


ACTIVATIONS = {n: F(n, X) for n in (
    "relu", "relu6", "sigmoid", "log_sigmoid", "silu", "swish", "mish",
    "softplus", "softsign", "tanhshrink", "hardsigmoid", "hardswish",
    "hardtanh", "selu", "gelu", "tanh", "celu", "hardshrink", "softshrink",
    "thresholded_relu", "elu", "leaky_relu", "softmax", "log_softmax")}
ACTIVATIONS.update({
    "softplus_beta": F("softplus", X, beta=2, threshold=3),
    "gelu_tanh": F("gelu", X, approximate=True),
    "leaky_relu_slope": F("leaky_relu", X, 0.2),
    "elu_alpha": F("elu", X, 0.7),
    "celu_alpha": F("celu", X, 0.6),
    "selu_args": F("selu", X, 1.2, 1.5),
    "hardshrink_t": F("hardshrink", X, 1.1),
    "softshrink_t": F("softshrink", X, 1.1),
    "thresholded_relu_t": F("thresholded_relu", X, 0.7),
    "prelu_one": F("prelu", X, np.array([0.3], np.float32)),
    "prelu_channels": F("prelu", X4, np.array([0.1, 0.2, 0.3], np.float32)),
    "prelu_nhwc": F("prelu", X4, np.array([0.1, 0.4], np.float32),
                    data_format="NHWC"),
    "softmax_axis": F("softmax", X4, axis=1),
    "log_softmax_axis": F("log_softmax", X4, axis=0),
    "glu": F("glu", X4, axis=2),
    "maxout": F("maxout", rand_f((2, 4, 3)), 2),
    "normalize": F("normalize", X4),
    "normalize_p1": F("normalize", X4, p=1, axis=-1),
    "pairwise_distance": F("pairwise_distance", X, rand_f((3, 5), seed=9)),
    "pairwise_distance_p1": F("pairwise_distance", X, rand_f((3, 5), seed=9),
                              p=1.0, keepdim=True),
    "dropout_eval": F("dropout", X, 0.4, training=False),
    "dropout_eval_downscale": F("dropout", X, 0.4, training=False,
                                mode="downscale_in_infer"),
    "dropout_p0": F("dropout", X, 0.0),
    "dropout_p1": F("dropout", X, 1.0),
    "dropout2d_eval": F("dropout2d", X4, 0.5, training=False),
    "alpha_dropout_eval": F("alpha_dropout", X, 0.5, training=False),
    "label_smooth": F("label_smooth", TARGET),
    "label_smooth_prior": F("label_smooth", TARGET, rand_f((1, 3), 0, 1),
                            epsilon=0.2),
    "diag_embed": F("diag_embed", X[:2]),
    "diag_embed_above": F("diag_embed", X[:2], offset=2),
    "diag_embed_below": F("diag_embed", X[:2], offset=-1),
    "sequence_mask": F("sequence_mask", np.array([3, 0, 5]), maxlen=6),
    "sequence_mask_max": F("sequence_mask", np.array([[2, 4]]),
                           dtype="float32"),
    "one_hot": F("one_hot", rand_i((4,), 6), 6),
    "pad": F("pad", X4, [1, 0, 2, 1]),
})

LOSSES = {
    "swce": F("softmax_with_cross_entropy", LOGITS, LABEL),
    "swce_ignored": F("softmax_with_cross_entropy", LOGITS, IGNORED),
    "swce_flat_label": F("softmax_with_cross_entropy", LOGITS, LABEL[:, 0]),
    "swce_soft": F("softmax_with_cross_entropy", LOGITS, SOFT,
                   soft_label=True),
    "swce_axis": F("softmax_with_cross_entropy", rand_f((2, 5, 3)),
                   rand_i((2, 1, 3), 5), axis=1),
    "swce_ignore_index": F("softmax_with_cross_entropy", LOGITS, LABEL,
                           ignore_index=5),
    "swce_return_softmax": F("softmax_with_cross_entropy", LOGITS, LABEL,
                             return_softmax=True),
    "ce": F("cross_entropy", LOGITS, IGNORED),
    "ce_weight": F("cross_entropy", LOGITS, IGNORED,
                   weight=rand_f((6,), 0.5, 2.0)),
    "ce_sum": F("cross_entropy", LOGITS, LABEL, reduction="sum"),
    "ce_none": F("cross_entropy", LOGITS, LABEL, reduction="none"),
    "ce_soft": F("cross_entropy", LOGITS, SOFT, soft_label=True),
    "ce_no_softmax": F("cross_entropy", rand_f((4, 6), 0.05, 1.0), LABEL,
                       use_softmax=False),
    "nll": F("nll_loss", LOGITS, LABEL[:, 0]),
    "nll_weight_sum": F("nll_loss", LOGITS, LABEL[:, 0],
                        weight=rand_f((6,), 0.5, 2.0), reduction="sum"),
    "mse": F("mse_loss", PROB, TARGET),
    "mse_none": F("mse_loss", PROB, TARGET, reduction="none"),
    "l1": F("l1_loss", PROB, TARGET, reduction="sum"),
    "smooth_l1": F("smooth_l1_loss", X, rand_f((3, 5), seed=9), delta=0.5),
    "bce": F("binary_cross_entropy", PROB, TARGET),
    "bce_weight": F("binary_cross_entropy", PROB, TARGET,
                    weight=rand_f((3,), 0.5, 2.0), reduction="none"),
    "bce_logits": F("binary_cross_entropy_with_logits", X[:, :3], PROB[:3]),
    "bce_logits_weights": F("binary_cross_entropy_with_logits", X[:, :3],
                            PROB[:3], weight=rand_f((3,), 0.5, 2.0),
                            pos_weight=rand_f((3,), 0.5, 3.0),
                            reduction="sum"),
    "kl_div": F("kl_div", np.log(PROB), TARGET),
    "kl_div_batchmean": F("kl_div", np.log(PROB), TARGET,
                          reduction="batchmean"),
    "hinge": F("hinge_loss", X[:, :1], (rand_i((3, 1), 2)).astype(
        np.float32)),
    "margin_ranking": F("margin_ranking_loss", X[0], X[1],
                        np.sign(X[2]).astype(np.float32), margin=0.1),
    "cosine_similarity": F("cosine_similarity", X, rand_f((3, 5), seed=9)),
    "square_error_cost": F("square_error_cost", PROB, TARGET),
    "sigmoid_focal": F("sigmoid_focal_loss", X[:, :3], PROB[:3].round(),
                       normalizer=np.array([2.5], np.float32)),
}

LAYERS = {
    **{n: L(n, X) for n in (
        "ReLU", "ReLU6", "Sigmoid", "LogSigmoid", "Tanh", "Silu", "Swish",
        "Mish", "Softsign", "Tanhshrink", "Hardsigmoid", "Hardswish",
        "Softplus", "Selu", "GELU", "LeakyReLU", "ELU", "Hardshrink",
        "Softshrink", "Hardtanh", "ThresholdedReLU", "Softmax",
        "LogSoftmax", "SELU", "CELU")},
    "GELU_tanh": L("GELU", X, ctor=(True,)),
    "LeakyReLU_slope": L("LeakyReLU", X, ctor=(0.3,)),
    "ELU_alpha": L("ELU", X, ctor=(0.5,)),
    "Softmax_axis": L("Softmax", X4, ctor=(1,)),
    "Maxout": L("Maxout", rand_f((2, 4, 3)), ctor=(2, 1)),
    "GLU": L("GLU", X4[:, :2], ctor=(1,)),
    "PReLU": L("PReLU", X4, ctor=(3, 0.1)),
    "CrossEntropyLoss": L("CrossEntropyLoss", LOGITS, IGNORED),
    "MSELoss": L("MSELoss", PROB, TARGET, ctor=("sum",)),
    "L1Loss": L("L1Loss", PROB, TARGET),
    "SmoothL1Loss": L("SmoothL1Loss", X, rand_f((3, 5), seed=9),
                      ctor=("mean", 0.5)),
    "BCELoss": L("BCELoss", PROB, TARGET),
    "BCEWithLogitsLoss": L("BCEWithLogitsLoss", X[:, :3], PROB[:3]),
    "NLLLoss": L("NLLLoss", LOGITS, LABEL[:, 0]),
    "KLDivLoss": L("KLDivLoss", np.log(PROB), TARGET, ctor=("batchmean",)),
    "MarginRankingLoss": L("MarginRankingLoss", X[0], X[1],
                           np.sign(X[2]).astype(np.float32), ctor=(0.2,)),
    "PairwiseDistance": L("PairwiseDistance", X, rand_f((3, 5), seed=9),
                          ctor=(3.0,)),
}

FAMILIES = {"activation": ACTIVATIONS, "loss": LOSSES, "layer": LAYERS}
# a layer with a parameter (its gradient comes from the eager tape) and a
# mask whose length JAX reads on the host
EAGER = {("layer", "PReLU"), ("activation", "sequence_mask_max")}


@pytest.fixture(scope="module")
def jax_results():
    cases = [((fam, name), c) for fam, family in FAMILIES.items()
             for name, c in family.items()]
    out = jax_traced([(k, c) for k, c in cases if k not in EAGER])
    out.update({k: run(c, jax=True) for k, c in cases if k in EAGER})
    return out


@pytest.mark.parametrize("name", list(ACTIVATIONS))
def test_activation_functions_match_jax(name, jax_results):
    hold(ACTIVATIONS[name], *jax_results[("activation", name)])


@pytest.mark.parametrize("name", list(LOSSES))
def test_losses_match_jax(name, jax_results):
    hold(LOSSES[name], *jax_results[("loss", name)])


@pytest.mark.parametrize("name", list(LAYERS))
def test_layers_match_jax(name, jax_results):
    hold(LAYERS[name], *jax_results[("layer", name)])


def test_the_layer_library_has_the_jax_names():
    """All 28 activation layers and every loss layer under their JAX
    names, and the functional names of the ported modules."""
    from paddle_tpu.nn.layers import activation as jact
    from paddle_tpu.nn.layers import loss as jloss

    import paddle_tpu.nn.functional as JF

    acts = [n for n in dir(jact) if isinstance(getattr(jact, n), type)
            and n not in ("Layer", "Constant")]
    assert len(acts) == 28
    losses = [n for n in dir(jloss) if isinstance(getattr(jloss, n), type)
              and n != "Layer"]
    missing = [n for n in acts + losses if not hasattr(pnn, n)]
    assert not missing, missing
    from paddle_tpu.ops import loss as jl
    from paddle_tpu.ops import nn_ops as jo

    ported = [n for n in jo.__dict__ if not n.startswith("_") and (
        n.endswith(("relu", "sigmoid", "softmax", "swish", "shrink"))
        or n in ("mish", "softplus", "softsign", "hardtanh", "selu", "gelu",
                 "elu", "prelu", "glu", "maxout", "normalize", "dropout",
                 "dropout2d", "alpha_dropout", "silu", "relu6"))]
    ported += [n for n in jl.__dict__ if not n.startswith("_")
               and callable(jl.__dict__[n]) and jl.__dict__[n].__module__
               == jl.__name__]
    ported += ["gather_tree", "celu", "pairwise_distance", "label_smooth",
               "diag_embed", "sequence_mask", "relu_", "elu_", "softmax_",
               "tanh_", "tanh", "pad", "one_hot"]
    missing = [n for n in ported if not hasattr(PF, n) or not hasattr(JF, n)]
    assert not missing, missing


def test_moved_functions_keep_their_import_path():
    """The functions the port had in ``nn.functional`` now live in the op
    library and are re-exported there, the same objects."""
    assert PF.relu is ops.nn_ops.relu and PF.dropout is ops.nn_ops.dropout
    assert PF.gelu is ops.nn_ops.gelu and PF.relu6 is ops.nn_ops.relu6
    assert PF.tanh is ops.math.tanh and PF.matmul is ops.math.matmul
    assert PF.softmax_with_cross_entropy is \
        ops.loss.softmax_with_cross_entropy
    assert PF.cross_entropy is ops.loss.cross_entropy
    assert PF.mse_loss is ops.loss.mse_loss and PF.flatten is \
        ops.manipulation.flatten
    assert PF.IGNORE_INDEX == -100


@pytest.mark.parametrize("name", ["relu_", "elu_", "softmax_", "tanh_"])
def test_inplace_aliases_write_into_their_input(name):
    """The result lands in the input tensor, whose gradient then runs
    through the function; a leaf that requires grad refuses."""
    x = torch.from_numpy(X.copy()).requires_grad_()
    y = x * 1.0
    out = getattr(PF, name)(y)
    assert out is y
    want = getattr(PF, name[:-1])(x)
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    y.sum().backward()
    g = torch.autograd.grad(want.sum(), x)[0]
    torch.testing.assert_close(x.grad, g, rtol=0, atol=0)
    with pytest.raises(RuntimeError):
        getattr(PF, name)(torch.zeros(2, requires_grad=True))


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_dropout_masks():
    """upscale_in_train keeps about 1 - p of the values, each divided by
    1 - p, the rest 0; ``downscale_in_infer`` keeps them unscaled; an
    `axis` draws one keep per slice; one seed gives one mask; training
    without a generator raises."""
    x = torch.rand(200, 50, generator=_gen(1)) + 0.5
    y = PF.dropout(x, 0.3, generator=_gen())
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.02
    torch.testing.assert_close(y[kept], x[kept] / 0.7)
    assert torch.equal(y, PF.dropout(x, 0.3, generator=_gen()))
    down = PF.dropout(x, 0.3, mode="downscale_in_infer", generator=_gen())
    assert torch.equal(down != 0, kept) and torch.equal(down[kept], x[kept])
    rows = PF.dropout(x, 0.5, axis=0, generator=_gen())
    assert ((rows != 0).all(1) | (rows == 0).all(1)).all()
    chans = PF.dropout2d(torch.rand(4, 6, 3, 3) + 0.5, 0.5, generator=_gen())
    assert ((chans != 0).flatten(2).all(2)
            | (chans == 0).flatten(2).all(2)).all()
    with pytest.raises(ValueError, match="generator"):
        PF.dropout(x, 0.3)


def test_alpha_dropout_keeps_mean_and_variance():
    """On a standard normal input the output keeps mean 0 and variance 1
    (SELU's fixed point) within sampling error, and is deterministic in
    its generator."""
    x = torch.randn(100000, generator=_gen(2))
    y = PF.alpha_dropout(x, 0.2, generator=_gen())
    assert abs(y.mean().item()) < 0.02 and abs(y.var().item() - 1) < 0.03
    assert torch.equal(y, PF.alpha_dropout(x, 0.2, generator=_gen()))


def test_containers_keep_the_jax_state_names():
    """`LayerDict` keys its layers and `ParameterList` its parameters
    "0", "1", ... as the JAX containers do, so a JAX state carries
    across, and both index, iterate and append alike."""
    paddle.seed(0)
    jd = jnn.LayerDict({"enc": jnn.Linear(3, 4), "act": jnn.ReLU()})
    jd["dec"] = jnn.Linear(4, 2)
    g = _gen()
    pd = pnn.LayerDict({"enc": pnn.Linear(3, 4, generator=g),
                        "act": pnn.ReLU()})
    pd["dec"] = pnn.Linear(4, 2, generator=g)
    layer_from_numpy(pd, {n: np.asarray(t._data)
                          for n, t in jd.state_dict().items()}, device="cpu")
    assert list(pd.keys()) == list(jd.keys()) and "act" in pd
    x = rand_f((2, 3))
    want = jd["dec"](jd["act"](jd["enc"](paddle.to_tensor(x))))
    got = pd["dec"](pd["act"](pd["enc"](torch.from_numpy(x))))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want._data),
                               rtol=1e-6, atol=1e-6)
    jp = jnn.ParameterList([jnn.create_parameter([2, 2], "float32")])
    jp.append(jnn.create_parameter([3], "float32"))
    pp = pnn.ParameterList([pnn.create_parameter([2, 2], generator=g)])
    pp.append(pnn.create_parameter([3], generator=g))
    assert list(pp.state_dict()) == list(jp.state_dict()) == ["0", "1"]
    assert len(pp) == 2 and [tuple(p.shape) for p in pp] == [(2, 2), (3,)]
