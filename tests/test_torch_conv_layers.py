"""Port parity: the convolutions (``ops/nn_ops.py`` `conv1d`, `conv2d`,
`conv2d_transpose`; ``ops/nn_extra.py`` `conv3d`, `conv3d_transpose`,
`conv1d_transpose`) and the layers Conv1D, Conv2D, Conv3D and their
transposes, against the JAX package's on the same seeded inputs, the
layers carrying the JAX layer's weights.

Each case holds the output within 1e-6 of the JAX tensor's largest
magnitude and the gradient of every float input and parameter, under
one random cotangent, within 1e-5 (``torch_op_parity``).  The cases
cover groups, dilation, asymmetric and string paddings, NHWC, an output
padding at or past the stride, `output_size`, and a SAME transpose
whose kernel is narrower than its stride.  Every JAX result comes from
one jitted forward and gradient at module scope."""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.nn import functional as PF
from torch_op_parity import case, hold, jax_traced, rand_f


def F(fname, *args, **kw):
    return case(fname, *args, ns="F", **kw)


def PLACED():
    return {"generator": torch.Generator(), "device": "cpu"}


def L(cls, *args, ctor=(), pctor=None, **kw):
    return case(cls, *args, ns="nn", ctor=ctor,
                pctor=PLACED() if pctor is None else pctor, **kw)


X1 = rand_f((2, 4, 9), seed=1)
W1 = rand_f((6, 4, 3), -1, 1, seed=2)
X2 = rand_f((2, 4, 7, 6), seed=3)
W2 = rand_f((6, 4, 3, 3), -1, 1, seed=4)
B6 = rand_f((6,), seed=5)
X3 = rand_f((1, 4, 5, 6, 4), seed=6)
W3 = rand_f((6, 4, 3, 2, 3), -1, 1, seed=7)
WT1 = rand_f((4, 3, 3), -1, 1, seed=8)       # [in, out / groups, k]
WT2 = rand_f((4, 3, 3, 2), -1, 1, seed=9)
WT3 = rand_f((4, 3, 2, 3, 2), -1, 1, seed=10)
B3 = rand_f((3,), seed=11)
B4 = rand_f((4,), seed=12)
NHWC = np.ascontiguousarray(X2.transpose(0, 2, 3, 1))

FUNCTIONS = {
    "conv1d": F("conv1d", X1, W1, B6),
    "conv1d_stride_dilation": F("conv1d", X1, W1, stride=2, padding=2,
                                dilation=2),
    "conv1d_groups": F("conv1d", X1, rand_f((6, 2, 3), seed=13), groups=2),
    "conv1d_same": F("conv1d", X1, W1, B6, stride=2, padding="SAME"),
    "conv1d_valid": F("conv1d", X1, W1, padding="valid"),
    "conv1d_uneven": F("conv1d", X1, W1, padding=[1, 2]),
    "conv2d_nhwc": F("conv2d", NHWC, W2, B6, padding=1, data_format="NHWC"),
    "conv2d_same": F("conv2d", X2, W2, B6, stride=2, padding="SAME"),
    "conv2d_same_dilated": F("conv2d", X2, W2, padding="SAME", dilation=2),
    "conv2d_valid": F("conv2d", X2, W2, stride=(2, 1), padding="VALID"),
    "conv2d_uneven": F("conv2d", X2, W2, padding=[0, 2, 1, 0]),
    "conv2d_groups_dilation": F("conv2d", X2, rand_f((6, 2, 2, 3), seed=14),
                                padding=(1, 2), dilation=(2, 1), groups=2),
    "conv2d_nhwc_same": F("conv2d", NHWC, W2, stride=2, padding="SAME",
                          data_format="NHWC"),
    "conv2d_transpose": F("conv2d_transpose", X2, WT2, B3),
    "conv2d_transpose_stride_pad": F("conv2d_transpose", X2, WT2, B3,
                                     stride=2, padding=1, output_padding=1),
    "conv2d_transpose_opad_at_stride": F("conv2d_transpose", X2, WT2,
                                         stride=2, output_padding=2),
    "conv2d_transpose_opad_past_stride": F("conv2d_transpose", X2, WT2,
                                           stride=(2, 1), padding=1,
                                           output_padding=(3, 2)),
    "conv2d_transpose_groups_dilation": F(
        "conv2d_transpose", X2, rand_f((4, 2, 3, 2), seed=15), B4,
        stride=2, dilation=(1, 2), groups=2),
    "conv2d_transpose_output_size": F("conv2d_transpose", X2, WT2,
                                      stride=2, padding=1,
                                      output_size=[15, 14]),
    "conv2d_transpose_same": F("conv2d_transpose", X2, WT2, stride=2,
                               padding="SAME"),
    "conv2d_transpose_same_narrow": F("conv2d_transpose", X2,
                                      rand_f((4, 3, 1, 1), seed=16),
                                      stride=3, padding="SAME"),
    "conv2d_transpose_valid": F("conv2d_transpose", X2, WT2, stride=2,
                                padding="VALID"),
    "conv2d_transpose_uneven": F("conv2d_transpose", X2, WT2, stride=2,
                                 padding=[1, 0, 0, 2]),
    "conv3d": F("conv3d", X3, W3, B6),
    "conv3d_stride_pad": F("conv3d", X3, W3, stride=(2, 1, 2),
                           padding=[1, 0, 1], dilation=(1, 2, 1)),
    "conv3d_same": F("conv3d", X3, W3, stride=2, padding="SAME"),
    "conv3d_groups": F("conv3d", X3, rand_f((6, 2, 2, 2, 2), seed=17),
                       groups=2),
    "conv3d_transpose": F("conv3d_transpose", X3, WT3, B3),
    "conv3d_transpose_stride": F("conv3d_transpose", X3, WT3, stride=2,
                                 padding=1, output_padding=1),
    "conv3d_transpose_opad_past_stride": F(
        "conv3d_transpose", X3, WT3, stride=(2, 1, 2),
        output_padding=(2, 1, 3)),
    "conv3d_transpose_output_size": F("conv3d_transpose", X3, WT3, stride=2,
                                      output_size=[11, 13, 10]),
    "conv3d_transpose_same": F("conv3d_transpose", X3, WT3, stride=2,
                               padding="SAME"),
    "conv3d_transpose_groups": F("conv3d_transpose", X3,
                                 rand_f((4, 2, 2, 2, 2), seed=18),
                                 groups=2, dilation=2),
    "conv1d_transpose": F("conv1d_transpose", X1, WT1, B3),
    "conv1d_transpose_stride": F("conv1d_transpose", X1, WT1, stride=3,
                                 padding=1, output_padding=2),
    "conv1d_transpose_output_size": F("conv1d_transpose", X1, WT1, stride=2,
                                      output_size=[22]),
    "conv1d_transpose_groups": F("conv1d_transpose", X1,
                                 rand_f((4, 2, 3), seed=19), groups=2,
                                 dilation=2),
}

LAYERS = {
    "Conv1D": L("Conv1D", X1, ctor=(4, 6, 3, 2, 1)),
    "Conv1D_groups_nobias": L("Conv1D", X1, ctor=(4, 6, 3),
                              ckw=dict(groups=2, bias_attr=False)),
    "Conv2D_nhwc": L("Conv2D", NHWC, ctor=(4, 6, 3, 1, "SAME"),
                     ckw={"data_format": "NHWC"}),
    "Conv3D": L("Conv3D", X3, ctor=(4, 6, (2, 3, 2), 1, 1)),
    "Conv1DTranspose": L("Conv1DTranspose", X1, ctor=(4, 6, 3, 2, 1, 1)),
    "Conv2DTranspose": L("Conv2DTranspose", X2, ctor=(4, 6, 3, 2, 1, 1)),
    "Conv2DTranspose_output_size": L("Conv2DTranspose", X2,
                                     ctor=(4, 6, 3, 2), output_size=[16, 14]),
    "Conv2DTranspose_groups": L("Conv2DTranspose", X2,
                                ctor=(4, 6, 2, 1, 0, 0, 1, 2)),
    "Conv3DTranspose": L("Conv3DTranspose", X3, ctor=(4, 2, 2, 2)),
}
FAMILIES = {"function": FUNCTIONS, "layer": LAYERS}


@pytest.fixture(scope="module")
def jax_results():
    return jax_traced([((fam, name), c) for fam, family in FAMILIES.items()
                       for name, c in family.items()])


@pytest.mark.parametrize("name", list(FUNCTIONS))
def test_convolutions_match_jax(name, jax_results):
    hold(FUNCTIONS[name], *jax_results[("function", name)])


@pytest.mark.parametrize("name", list(LAYERS))
def test_conv_layers_match_jax(name, jax_results):
    hold(LAYERS[name], *jax_results[("layer", name)])


def test_the_functional_and_layer_namespaces_have_every_jax_name():
    """Every public function of the JAX package's ``nn.functional`` and
    every layer class of its ``nn`` (but the `Layer` base: the port's
    layers are ``torch.nn.Module``) under the same name in the port."""
    import paddle_tpu.nn as jnn
    import paddle_tpu.nn.functional as JF

    functions = [n for n in dir(JF) if not n.startswith("_")
                 and callable(getattr(JF, n))]
    layers = [n for n in dir(jnn) if not n.startswith("_")
              and isinstance(getattr(jnn, n), type) and n != "Layer"]
    assert len(functions) > 90 and len(layers) > 90
    assert [n for n in functions if not hasattr(PF, n)] == []
    assert [n for n in layers if not hasattr(pnn, n)] == []
    assert pnn.spectral_norm is pnn.utils.spectral_norm
