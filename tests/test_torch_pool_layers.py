"""Port parity: the pools (``ops/nn_ops.py`` `max_pool1d`, `avg_pool1d`,
`max_pool2d`, `avg_pool2d`, `adaptive_avg_pool2d`,
`adaptive_max_pool2d`; ``ops/nn_extra.py`` the 3-D pools, their mask
and ceil mode, the 1-D and 3-D adaptive pools) and every pooling layer,
against the JAX package's on the same seeded inputs: outputs within
1e-6 of the JAX tensor's largest magnitude, the input's gradient under
one random cotangent within 1e-5, a mask equal (``torch_op_parity``).

The 2-D pools now take NHWC, string paddings and asymmetric or wide
paddings as the JAX `_pool` computes them.  The JAX 1-D pools run with a
string padding only (an int one fails in their padding parser), so an
int one is held against the 2-D pool they stand for.  ``ceil_mode``,
``return_mask`` and ``divisor_override`` still raise there (the JAX 2-D
pools ignore them or answer None)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import paddle_tpu as paddle
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.nn import functional as PF
from torch_op_parity import NAMESPACES, case, hold, jax_traced, rand_f


def F(fname, *args, **kw):
    return case(fname, *args, ns="F", **kw)


def L(cls, *args, ctor=(), **kw):
    return case(cls, *args, ns="nn", ctor=ctor, **kw)


X1 = rand_f((2, 3, 11), seed=1)
X2 = rand_f((2, 3, 9, 7), seed=2)
NHWC = np.ascontiguousarray(X2.transpose(0, 2, 3, 1))
X3 = rand_f((2, 2, 7, 6, 5), seed=3)
# all-negative values: a window over the padding alone must not read 0
NEG3 = rand_f((1, 2, 5, 5, 4), -3.0, -1.0, seed=4)


def _as_2d(pool):
    """The JAX 1-D pool as its function means it, where it cannot run
    (an int padding): the 2-D pool of [N, C, L, 1] with a (k, 1) window
    and the padding on L."""
    def call(x, k, s=None, p=0):
        lo, hi = (p, p) if isinstance(p, int) else p
        out = pool(paddle.unsqueeze(x, [3]), (k, 1),
                   (s, 1) if s is not None else None, [lo, hi, 0, 0])
        return paddle.squeeze(out, [3])
    return call


NAMESPACES["pool1d"] = (SimpleNamespace(
    max_pool1d=_as_2d(paddle.nn.functional.max_pool2d),
    avg_pool1d=_as_2d(paddle.nn.functional.avg_pool2d)), PF)

FUNCTIONS = {
    "max_pool1d": case("max_pool1d", X1, 3, ns="pool1d"),
    "max_pool1d_stride_pad": case("max_pool1d", X1, 4, 2, 2, ns="pool1d"),
    "max_pool1d_uneven": case("max_pool1d", X1, 4, 2, [2, 1], ns="pool1d"),
    "max_pool1d_same": F("max_pool1d", X1, 3, 2, "SAME"),
    "avg_pool1d": case("avg_pool1d", X1, 3, 2, 1, ns="pool1d"),
    "avg_pool1d_same": F("avg_pool1d", X1, 3, 2, "SAME"),
    "avg_pool1d_valid": F("avg_pool1d", X1, 2, padding="VALID"),
    "max_pool2d_nhwc": F("max_pool2d", NHWC, 3, 2, 1, data_format="NHWC"),
    "max_pool2d_same": F("max_pool2d", X2, 3, 2, "SAME"),
    "max_pool2d_uneven": F("max_pool2d", X2, 3, 2, [0, 2, 1, 1]),
    "max_pool2d_wide": F("max_pool2d", X2, 3, 1, 2),
    "avg_pool2d_nhwc": F("avg_pool2d", NHWC, 3, 1, 1, data_format="NHWC"),
    "avg_pool2d_same": F("avg_pool2d", X2, 3, 2, "SAME"),
    "avg_pool2d_valid": F("avg_pool2d", X2, (3, 2), padding="VALID"),
    "avg_pool2d_uneven": F("avg_pool2d", X2, 3, 2, [1, 0, 2, 1]),
    "avg_pool2d_uneven_inclusive": F("avg_pool2d", X2, 3, 2, [1, 0, 2, 1],
                                     exclusive=False),
    "avg_pool2d_wide": F("avg_pool2d", X2, 3, 2, (2, 1)),
    "adaptive_avg_pool2d_nhwc": F("adaptive_avg_pool2d", NHWC, (4, 3),
                                  data_format="NHWC"),
    "adaptive_avg_pool2d_divisible": F("adaptive_avg_pool2d", X2[:, :, :8, :6],
                                       (4, 3)),
    "adaptive_max_pool2d": F("adaptive_max_pool2d", X2, (4, 3)),
    "adaptive_max_pool2d_divisible": F("adaptive_max_pool2d", X2, (3, 7)),
    "adaptive_max_pool2d_up": F("adaptive_max_pool2d", X2[:, :, :2, :2], 3),
    "max_pool3d": F("max_pool3d", X3, 2),
    "max_pool3d_stride_pad": F("max_pool3d", X3, 3, 2, 1),
    "max_pool3d_ceil": F("max_pool3d", X3, 2, ceil_mode=True),
    "max_pool3d_mask": F("max_pool3d", X3, (2, 3, 2), (2, 2, 1),
                         return_mask=True),
    "avg_pool3d": F("avg_pool3d", X3, 2),
    "avg_pool3d_pad": F("avg_pool3d", X3, 3, 2, 1),
    "avg_pool3d_pad_inclusive": F("avg_pool3d", X3, 3, 2, 1,
                                  exclusive=False),
    "avg_pool3d_ceil": F("avg_pool3d", X3, 2, ceil_mode=True),
    "avg_pool3d_ceil_inclusive": F("avg_pool3d", X3, 2, ceil_mode=True,
                                   exclusive=False),
    "avg_pool3d_divisor": F("avg_pool3d", X3, 3, 2, 1, divisor_override=5),
    "adaptive_avg_pool1d": F("adaptive_avg_pool1d", X1, 4),
    "adaptive_max_pool1d": F("adaptive_max_pool1d", X1, 4),
    "adaptive_avg_pool3d": F("adaptive_avg_pool3d", X3, (3, 4, 2)),
    "adaptive_max_pool3d": F("adaptive_max_pool3d", X3, (3, 4, 2)),
    "adaptive_avg_pool3d_divisible": F("adaptive_avg_pool3d", X3[:, :, :6],
                                       (3, 2, 5)),
}

LAYERS = {
    "MaxPool1D": L("MaxPool1D", X1, ctor=(3, 2, "SAME")),
    "AvgPool1D": L("AvgPool1D", X1, ctor=(3, 2, "SAME")),
    "MaxPool2D": L("MaxPool2D", NHWC, ctor=(3, 2, "SAME"),
                   ckw={"data_format": "NHWC"}),
    "AvgPool2D": L("AvgPool2D", X2, ctor=(3, 2, [1, 0, 2, 1])),
    "AdaptiveAvgPool1D": L("AdaptiveAvgPool1D", X1, ctor=(4,)),
    "AdaptiveAvgPool2D": L("AdaptiveAvgPool2D", X2, ctor=((4, 3),)),
    "AdaptiveAvgPool3D": L("AdaptiveAvgPool3D", X3, ctor=((3, 4, 2),)),
    "AdaptiveMaxPool1D": L("AdaptiveMaxPool1D", X1, ctor=(4,)),
    "AdaptiveMaxPool2D": L("AdaptiveMaxPool2D", X2, ctor=((4, 3),)),
    "AdaptiveMaxPool3D": L("AdaptiveMaxPool3D", X3, ctor=((3, 4, 2),)),
    "MaxPool3D": L("MaxPool3D", X3, ctor=(3, 2, 1, True)),
    "MaxPool3D_mask": L("MaxPool3D", X3, ctor=(2, 2, 0, False, True)),
    "AvgPool3D": L("AvgPool3D", X3, ctor=(3, 2, 1, True)),
}
FAMILIES = {"function": FUNCTIONS, "layer": LAYERS}


@pytest.fixture(scope="module")
def jax_results():
    return jax_traced([((fam, name), c) for fam, family in FAMILIES.items()
                       for name, c in family.items()])


@pytest.mark.parametrize("name", list(FUNCTIONS))
def test_pools_match_jax(name, jax_results):
    hold(FUNCTIONS[name], *jax_results[("function", name)])


@pytest.mark.parametrize("name", list(LAYERS))
def test_pool_layers_match_jax(name, jax_results):
    hold(LAYERS[name], *jax_results[("layer", name)])


def _mask_reference(x, k, s, p, ceil_mode=False):
    """Each window's flattened D H W index of its first largest value,
    the padding never chosen, in numpy."""
    n, c, d, h, w = x.shape
    xp = np.pad(x, [(0, 0)] * 2 + [(p, p + k)] * 3, constant_values=-np.inf)
    out = [-(-(size + 2 * p - k) // s) + 1 if ceil_mode
           else (size + 2 * p - k) // s + 1 for size in (d, h, w)]
    mask = np.zeros((n, c) + tuple(out), np.int32)
    for idx in np.ndindex(*mask.shape):
        a, b, e = (i * s for i in idx[2:])
        win = xp[idx[0], idx[1], a:a + k, b:b + k, e:e + k]
        dz, dy, dx = np.unravel_index(np.argmax(win), win.shape)
        mask[idx] = ((a + dz - p) * h + b + dy - p) * w + e + dx - p
    return mask


@pytest.mark.parametrize("k, s, p, ceil_mode", [(3, 2, 1, False),
                                                (2, 2, 0, True)],
                         ids=["padding", "ceil_mode"])
def test_max_pool3d_mask_over_the_padding(k, s, p, ceil_mode):
    """With a padding (or past the end under `ceil_mode`) each window's
    mask names its largest input value, on mixed and on all-negative
    inputs, against numpy.  The JAX mask is not the reference here: its
    patches convolution turns the -inf padding times 0 into NaN, and its
    argmax then reads the NaN's place (-1 or another window entry;
    ROADMAP's known differences).  Without a padding the masks are held
    to JAX's (`test_pools_match_jax`)."""
    for x in (X3, NEG3):
        out, mask = PF.max_pool3d(torch.from_numpy(x), k, s, p,
                                  return_mask=True, ceil_mode=ceil_mode)
        want = _mask_reference(x, k, s, p, ceil_mode)
        np.testing.assert_array_equal(mask.numpy(), want)
        assert out.dtype == torch.float32 and mask.dtype == torch.int32
    assert (out < 0).all()


@pytest.mark.parametrize("call", [
    lambda x: PF.max_pool2d(x, 2, ceil_mode=True),
    lambda x: PF.max_pool2d(x, 2, return_mask=True),
    lambda x: PF.avg_pool2d(x, 2, divisor_override=3),
    lambda x: PF.max_pool1d(x[..., 0], 2, ceil_mode=True),
    lambda x: PF.adaptive_max_pool2d(x, 2, return_mask=True),
    lambda x: PF.adaptive_max_pool1d(x[..., 0], 2, return_mask=True),
    lambda x: PF.adaptive_max_pool3d(x[:, None], 2, return_mask=True),
    lambda x: pnn.MaxPool1D(2, return_mask=True)(x[..., 0])],
    ids=["ceil_mode", "return_mask", "divisor_override", "ceil_mode_1d",
         "adaptive_mask_2d", "adaptive_mask_1d", "adaptive_mask_3d",
         "layer_mask_1d"])
def test_the_refusals_that_follow_jax_quirks_stay(call):
    """What the JAX 1-D and 2-D pools ignore or answer None for raises."""
    with pytest.raises(NotImplementedError, match="not ported"):
        call(torch.zeros(1, 3, 6, 6))
