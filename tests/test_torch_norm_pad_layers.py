"""Port parity: the norms (``ops/nn_ops.py`` `instance_norm`,
`group_norm`, `local_response_norm`; ``ops/nn_extra.py``
`spectral_norm_apply`; the layers InstanceNorm1D/2D/3D, GroupNorm,
LocalResponseNorm, SpectralNorm and SyncBatchNorm; ``nn.utils``'s
`weight_norm` and `spectral_norm`) and the padding and resampling
functions and layers (`interpolate`, `pixel_shuffle`, `unfold`, `fold`;
Identity, Pad1D/2D/3D, ZeroPad2D, Upsample, UpsamplingBilinear2D,
UpsamplingNearest2D, PixelShuffle, Unfold, Fold), against the JAX
package's on the same seeded inputs, layers carrying the JAX layer's
state: outputs within 1e-6 of the JAX tensor's largest magnitude, the
gradient of every float input and parameter under one random cotangent
within 1e-5 (``torch_op_parity``).

`interpolate` is held both ways of `align_corners`, up and down, by
`size` and by `scale_factor`: its nearest mode floors ``k in / out``
(not PyTorch's nearest), bicubic uses A = -0.75, and bilinear without
`align_corners` is ``jax.image.resize``'s, which antialiases when it
shrinks an axis."""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import paddle_tpu as paddle
import paddle_tpu.ops.nn_extra as jextra
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.models import layer_from_numpy
from paddle_tpu_torch.ops import nn_extra as pextra
from torch_op_parity import (NAMESPACES, case, hold, jax_traced, rand_f,
                             run)

NAMESPACES["extra"] = (jextra, pextra)


def F(fname, *args, **kw):
    return case(fname, *args, ns="F", **kw)


def PLACED():
    return {"generator": torch.Generator(), "device": "cpu"}


def L(cls, *args, ctor=(), pctor=None, **kw):
    return case(cls, *args, ns="nn", ctor=ctor,
                pctor={} if pctor is None else pctor, **kw)


X3 = rand_f((2, 4, 7), seed=1)
X4 = rand_f((2, 6, 5, 4), seed=2)
X5 = rand_f((2, 4, 3, 4, 3), seed=3)
C6 = rand_f((6,), 0.5, 1.5, seed=4)
B6 = rand_f((6,), seed=5)
IMG = rand_f((1, 3, 6, 8), seed=6)
NHWC = np.ascontiguousarray(IMG.transpose(0, 2, 3, 1))
COLS = rand_f((2, 12, 12), seed=7)   # [N, C kh kw, L] for fold
W4 = rand_f((5, 3, 2, 3), seed=8)


def interp(*args, **kw):
    return F("interpolate", *args, **kw)


FUNCTIONS = {
    "instance_norm": F("instance_norm", X4, C6, B6),
    "instance_norm_plain": F("instance_norm", X3),
    "instance_norm_3d": F("instance_norm", X5, C6[:4], epsilon=1e-3),
    "group_norm": F("group_norm", X4, 3, 1e-5, C6, B6),
    "group_norm_plain_3d": F("group_norm", X3, 2),
    "group_norm_5d": F("group_norm", X5, 4, weight=C6[:4]),
    "local_response_norm": F("local_response_norm", X4, 3),
    "local_response_norm_even": F("local_response_norm", X4, 4, 1e-2, 0.5,
                                  2.0),
    "spectral_norm_apply": case("spectral_norm_apply", W4, ns="extra"),
    "spectral_norm_apply_dim1": case("spectral_norm_apply", W4, 3, 1e-12,
                                     1, ns="extra"),
    "nearest_up_size": interp(IMG, size=(9, 13)),
    "nearest_up_scale": interp(IMG, scale_factor=2),
    "nearest_down": interp(IMG, size=(4, 3)),
    "nearest_scale_float": interp(IMG, scale_factor=(1.5, 0.75)),
    "nearest_align_up": interp(IMG, size=(11, 13), align_corners=True),
    "nearest_align_down": interp(IMG, size=(4, 5), align_corners=True),
    "nearest_nhwc": interp(NHWC, scale_factor=2, data_format="NHWC"),
    "bilinear_up": interp(IMG, size=(9, 13), mode="bilinear"),
    "bilinear_down": interp(IMG, size=(4, 3), mode="bilinear"),
    "bilinear_down_scale": interp(IMG, scale_factor=0.5, mode="bilinear"),
    "bilinear_mixed": interp(IMG, size=(3, 16), mode="bilinear"),
    "bilinear_nhwc": interp(NHWC, size=(4, 11), mode="bilinear",
                            data_format="NHWC"),
    "bilinear_align_up": interp(IMG, size=(9, 13), mode="bilinear",
                                align_corners=True),
    "bilinear_align_down": interp(IMG, scale_factor=0.5, mode="bilinear",
                                  align_corners=True),
    "bilinear_align_one": interp(IMG, size=(1, 5), mode="bilinear",
                                 align_corners=True),
    "bicubic_up": interp(IMG, size=(9, 13), mode="bicubic"),
    "bicubic_down": interp(IMG, size=(4, 3), mode="bicubic"),
    "bicubic_align": interp(IMG, scale_factor=1.5, mode="bicubic",
                            align_corners=True),
    "upsample": F("upsample", IMG, scale_factor=2, mode="bilinear"),
    "pixel_shuffle": F("pixel_shuffle", rand_f((2, 8, 3, 2), seed=9), 2),
    "unfold": F("unfold", IMG, 3),
    "unfold_stride_dilation": F("unfold", IMG, [2, 3], 2, 1, 2),
    "unfold_uneven": F("unfold", IMG, 2, paddings=[1, 0, 2, 1]),
    "unfold_same": F("unfold", IMG, 3, 2, "SAME"),
    "fold": F("fold", COLS[:, :, :6], [3, 4], 2),
    "fold_stride_pad": F("fold", COLS, [4, 6], 2, 2, 1),
}

LAYERS = {
    "InstanceNorm2D": L("InstanceNorm2D", X4, ctor=(6,), pctor=PLACED()),
    "InstanceNorm2D_plain": L("InstanceNorm2D", X4, ctor=(6,),
                              ckw=dict(weight_attr=False, bias_attr=False),
                              pctor=PLACED()),
    "InstanceNorm1D": L("InstanceNorm1D", X3, ctor=(4,), pctor=PLACED()),
    "InstanceNorm3D": L("InstanceNorm3D", X5, ctor=(4,), pctor=PLACED()),
    "GroupNorm": L("GroupNorm", X4, ctor=(2, 6), pctor=PLACED()),
    "LocalResponseNorm": L("LocalResponseNorm", X4, ctor=(5,)),
    "SpectralNorm": L("SpectralNorm", W4, ctor=((5, 3, 2, 3),),
                      pctor=PLACED()),
    "SpectralNorm_dim1_iters2": L("SpectralNorm", W4, ctor=((5, 3, 2, 3), 1,
                                                           2),
                                  pctor=PLACED()),
    "SyncBatchNorm": L("SyncBatchNorm", X4, ctor=(6,), pctor=PLACED()),
    "Identity": L("Identity", X4, ctor=(3,)),
    "Pad1D_reflect": L("Pad1D", X3, ctor=([2, 1], "reflect")),
    "Pad2D_constant": L("Pad2D", X4, ctor=([1, 0, 2, 1], "constant", 0.5)),
    "Pad2D_replicate": L("Pad2D", X4, ctor=(2, "replicate")),
    "Pad2D_reflect_nhwc": L("Pad2D", NHWC, ctor=([1, 2, 2, 0], "reflect"),
                            ckw={"data_format": "NHWC"}),
    "Pad3D_circular": L("Pad3D", X5, ctor=(1, "circular")),
    "ZeroPad2D": L("ZeroPad2D", X4, ctor=([0, 1, 2, 0],)),
    "Upsample_nearest": L("Upsample", IMG, ctor=(None, 2)),
    "Upsample_bilinear": L("Upsample", IMG, ctor=((4, 3), None, "bilinear")),
    "UpsamplingBilinear2D": L("UpsamplingBilinear2D", IMG, ctor=((9, 7),)),
    "UpsamplingNearest2D": L("UpsamplingNearest2D", IMG, ctor=(None, 2)),
    "PixelShuffle": L("PixelShuffle", rand_f((1, 9, 2, 3), seed=10),
                      ctor=(3,)),
    "Unfold": L("Unfold", IMG, ctor=(3, 1, 1)),
    "Fold": L("Fold", COLS[:, :, :6], ctor=([3, 4], 2)),
    "weight_norm": L("Conv2D", IMG, ctor=(3, 5, (2, 3)), pctor=PLACED(),
                     setup=lambda layer, nn: nn.utils.weight_norm(layer)),
    "weight_norm_all": L("Linear", rand_f((4, 3), seed=11), ctor=(3, 5),
                         pctor={"generator": torch.Generator()},
                         setup=lambda layer, nn: nn.utils.weight_norm(
                             layer, dim=None)),
    "spectral_norm": L("Linear", rand_f((4, 3), seed=12), ctor=(3, 5),
                       pctor={"generator": torch.Generator()},
                       setup=lambda layer, nn: nn.utils.spectral_norm(
                           layer, n_power_iterations=2)),
    "spectral_norm_conv_transpose": L(
        "Conv2DTranspose", IMG, ctor=(3, 4, 3, 2), pctor=PLACED(),
        setup=lambda layer, nn: nn.spectral_norm(layer)),
}
FAMILIES = {"function": FUNCTIONS, "layer": LAYERS}


@pytest.fixture(scope="module")
def jax_results():
    return jax_traced([((fam, name), c) for fam, family in FAMILIES.items()
                       for name, c in family.items()])


@pytest.mark.parametrize("name", list(FUNCTIONS))
def test_norm_and_resampling_functions_match_jax(name, jax_results):
    hold(FUNCTIONS[name], *jax_results[("function", name)])


@pytest.mark.parametrize("name", list(LAYERS))
def test_norm_and_pad_layers_match_jax(name, jax_results):
    hold(LAYERS[name], *jax_results[("layer", name)])


def test_sync_batch_norm_converts_and_moves_its_running_stats():
    """`convert_sync_batchnorm` swaps every batch norm below a layer for
    a SyncBatchNorm sharing its parameters and stats; the eager layer
    trains as `BatchNorm` and moves the running stats as JAX's does."""
    paddle.seed(0)
    jnet = paddle.nn.Sequential(paddle.nn.Conv2D(6, 6, 1),
                                paddle.nn.BatchNorm2D(6))
    g = torch.Generator()
    pnet = pnn.Sequential(pnn.Conv2D(6, 6, 1, generator=g, device="cpu"),
                          pnn.BatchNorm2D(6, device="cpu"))
    layer_from_numpy(pnet, {n: np.asarray(t._data) for n, t in
                            jnet.state_dict().items()}, device="cpu")
    weight = pnet[1].weight
    jnet = paddle.nn.SyncBatchNorm.convert_sync_batchnorm(jnet)
    pnet = pnn.SyncBatchNorm.convert_sync_batchnorm(pnet)
    assert type(pnet[1]) is pnn.SyncBatchNorm and pnet[1].weight is weight
    assert type(jnet[1]).__name__ == "SyncBatchNorm"
    for _ in range(2):
        want = jnet(paddle.to_tensor(X4))
        got = pnet(torch.from_numpy(X4))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want._data),
                               rtol=0, atol=1e-5)
    # the layer's own stats (JAX's converted layer keeps its new zero
    # buffers in its state_dict and updates the carried ones it reads)
    for n in ("_mean", "_variance"):
        np.testing.assert_allclose(
            getattr(pnet[1], n).numpy(),
            np.asarray(getattr(jnet[1], n)._data), rtol=0, atol=1e-6,
            err_msg=n)
    assert not np.allclose(pnet[1]._mean.numpy(), 0)


def test_remove_weight_norm_folds_the_weight_back():
    """`remove_weight_norm` leaves one ``weight`` parameter holding ``g v
    / ||v||`` and the layer's output unchanged, as in JAX; a second
    `weight_norm` on one name raises."""
    c = LAYERS["weight_norm"]
    jl = paddle.nn.Conv2D(3, 5, (2, 3))
    paddle.nn.utils.weight_norm(jl)
    pl = pnn.Conv2D(3, 5, (2, 3), **PLACED())
    pnn.utils.weight_norm(pl)
    layer_from_numpy(pl, {n: np.asarray(t._data) for n, t in
                          jl.state_dict().items()}, device="cpu")
    with pytest.raises(RuntimeError, match="already"):
        pnn.utils.weight_norm(pl)
    before = pl(torch.from_numpy(IMG))
    paddle.nn.utils.remove_weight_norm(jl)
    pnn.utils.remove_weight_norm(pl)
    assert [n for n, _ in pl.named_parameters()] == [
        n for n, _ in jl.named_parameters()] == ["bias", "weight"]
    np.testing.assert_allclose(pl.weight.detach().numpy(),
                               np.asarray(jl.weight._data), rtol=0,
                               atol=1e-6)
    torch.testing.assert_close(pl(torch.from_numpy(IMG)), before)
    assert run(c, jax=False)[0][0].shape == before.shape


def test_new_layers_default_to_the_card_and_never_fall_back():
    """The convolutions, the norms and the other layers with parameters
    this slice adds build on the card when no device is given, and raise
    without one, as the vision models do."""
    g = torch.Generator()
    builds = [lambda: pnn.Conv1D(2, 2, 3, generator=g),
              lambda: pnn.Conv2D(2, 2, 3, generator=g),
              lambda: pnn.Conv3D(2, 2, 3, generator=g),
              lambda: pnn.Conv1DTranspose(2, 2, 3, generator=g),
              lambda: pnn.Conv2DTranspose(2, 2, 3, generator=g),
              lambda: pnn.Conv3DTranspose(2, 2, 3, generator=g),
              lambda: pnn.InstanceNorm2D(2), lambda: pnn.GroupNorm(1, 2),
              lambda: pnn.SpectralNorm((2, 3), generator=g),
              lambda: pnn.SyncBatchNorm(2), lambda: pnn.BatchNorm2D(2),
              lambda: pnn.BatchNorm(2),
              lambda: pnn.Bilinear(2, 3, 4, generator=g),
              lambda: pnn.HSigmoidLoss(3, 4, generator=g)]
    for build in builds:
        if torch.cuda.is_available():
            assert next(build().parameters()).device.type == "cuda"
            continue
        with pytest.raises(RuntimeError, match="needs CUDA"):
            build()
