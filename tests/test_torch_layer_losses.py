"""Port parity: the rest of ``nn/layers/common.py`` (Dropout2D,
Dropout3D, AlphaDropout, CosineSimilarity, Bilinear) with `F.bilinear`
and `F.dropout3d`, and the layer losses and sampling grids of
``ops/nn_extra.py`` (`ctc_loss`, `hsigmoid_loss`, `dice_loss`,
`log_loss`, `npair_loss`, `affine_grid`, `grid_sample`,
`temporal_shift`) with the CTCLoss and HSigmoidLoss layers, against
the JAX package's on the same seeded inputs: outputs within 1e-6 of the
JAX tensor's largest magnitude, the gradient of every float input and
parameter under one random cotangent within 1e-5 (``torch_op_parity``).

CTC takes logits (``log_softmax`` inside) and is held with label
lengths of 0 and of the full width, repeated labels, both layouts,
`norm_by_times` and every reduction.  Dropout masks cannot equal JAX's
draws: the deterministic settings are held to JAX, the masks to their
rate, shape and generator.  The last test holds each JAX quirk this
slice keeps."""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.nn import functional as PF
from torch_op_parity import case, hold, jax_traced, rand_f, rand_i


def F(fname, *args, **kw):
    return case(fname, *args, ns="F", **kw)


def L(cls, *args, ctor=(), pctor=None, **kw):
    return case(cls, *args, ns="nn", ctor=ctor,
                pctor={} if pctor is None else pctor, **kw)


def PLACED():
    return {"generator": torch.Generator(), "device": "cpu"}


LOGITS = rand_f((3, 6, 5), -3, 3, seed=1)           # [B, T, C]
LABELS = np.array([[1, 1, 2], [4, 0, 0], [3, 2, 0]], np.int64)
IN_LEN = np.array([6, 4, 5], np.int64)
LAB_LEN = np.array([3, 0, 2], np.int64)
FEAT = rand_f((4, 5), seed=2)
PROB = np.exp(rand_f((4, 3), seed=3))
PROB = (PROB / PROB.sum(-1, keepdims=True)).astype(np.float32)
X4 = rand_f((2, 3, 4, 5), seed=4)
GRID = rand_f((2, 3, 4, 2), -1.2, 1.2, seed=5)
THETA = rand_f((2, 2, 3), -1, 1, seed=6)


def ctc(*args, **kw):
    return F("ctc_loss", LOGITS, LABELS, IN_LEN, LAB_LEN, *args, **kw)


FUNCTIONS = {
    "ctc_mean": ctc(),
    "ctc_sum": ctc(reduction="sum"),
    "ctc_none": ctc(reduction="none"),
    "ctc_norm_by_times": ctc(reduction="none", norm_by_times=True),
    "ctc_norm_by_times_mean": ctc(norm_by_times=True),
    "ctc_time_major": F("ctc_loss", np.ascontiguousarray(
        LOGITS.transpose(1, 0, 2)), LABELS, IN_LEN, LAB_LEN,
        reduction="none"),
    "ctc_blank_last": F("ctc_loss", LOGITS, LABELS[:, :2] % 4, IN_LEN,
                        np.array([2, 2, 1], np.int64), blank=4,
                        reduction="sum"),
    "hsigmoid_loss": F("hsigmoid_loss", FEAT, rand_i((4, 1), 6, seed=7), 6,
                       rand_f((5, 5), seed=8)),
    "hsigmoid_loss_two": F("hsigmoid_loss", FEAT, rand_i((4,), 2, seed=9),
                           2, rand_f((1, 5), seed=10)),
    "dice_loss": F("dice_loss", PROB, rand_i((4, 1), 3, seed=11)),
    "log_loss": F("log_loss", PROB, rand_i((4, 3), 2, seed=12).astype(
        np.float32)),
    "npair_loss": F("npair_loss", rand_f((4, 3), seed=13),
                    rand_f((4, 3), seed=14), np.array([0, 1, 0, 2])),
    "affine_grid": F("affine_grid", THETA, [2, 3, 4, 5]),
    "affine_grid_centres": F("affine_grid", THETA, [2, 3, 4, 5],
                             align_corners=False),
    "grid_sample": F("grid_sample", X4, GRID),
    "grid_sample_centres": F("grid_sample", X4, GRID, align_corners=False),
    "grid_sample_border": F("grid_sample", X4, GRID, padding_mode="border"),
    "grid_sample_nearest": F("grid_sample", X4, GRID, mode="nearest"),
    "temporal_shift": F("temporal_shift", rand_f((4, 8, 2, 2), seed=15), 2),
    "temporal_shift_ratio": F("temporal_shift", rand_f((6, 4, 2, 3), seed=16),
                              3, 0.5),
    "bilinear": F("bilinear", FEAT[:, :3], FEAT, rand_f((2, 3, 5), seed=17),
                  rand_f((1, 2), seed=18)),
    "dropout3d_eval": F("dropout3d", rand_f((2, 3, 2, 2, 2), seed=19), 0.5,
                        training=False),
    "dropout3d_p0": F("dropout3d", rand_f((2, 3, 2, 2, 2), seed=19), 0.0),
}

LAYERS = {
    "CTCLoss": L("CTCLoss", LOGITS, LABELS, IN_LEN, LAB_LEN),
    "CTCLoss_blank_norm": L("CTCLoss", LOGITS, LABELS % 4, IN_LEN, LAB_LEN,
                            ctor=(4, "sum"), norm_by_times=True),
    "HSigmoidLoss": L("HSigmoidLoss", FEAT, rand_i((4, 1), 7, seed=20),
                      ctor=(5, 7), pctor=PLACED()),
    "Bilinear": L("Bilinear", FEAT[:, :3], FEAT, ctor=(3, 5, 4),
                  pctor=PLACED()),
    "CosineSimilarity": L("CosineSimilarity", X4, rand_f((2, 3, 4, 5),
                                                        seed=21)),
    "CosineSimilarity_axis": L("CosineSimilarity", X4, X4[::-1].copy(),
                               ctor=(2, 1e-6)),
    "Dropout2D_p0": L("Dropout2D", X4, ctor=(0.0,)),
    "Dropout3D_p0": L("Dropout3D", rand_f((2, 3, 2, 2, 2), seed=22),
                      ctor=(0.0,)),
    "AlphaDropout_p0": L("AlphaDropout", X4, ctor=(0.0,)),
}
FAMILIES = {"function": FUNCTIONS, "layer": LAYERS}


@pytest.fixture(scope="module")
def jax_results():
    return jax_traced([((fam, name), c) for fam, family in FAMILIES.items()
                       for name, c in family.items()])


@pytest.mark.parametrize("name", list(FUNCTIONS))
def test_layer_losses_and_grids_match_jax(name, jax_results):
    hold(FUNCTIONS[name], *jax_results[("function", name)])


@pytest.mark.parametrize("name", list(LAYERS))
def test_common_and_loss_layers_match_jax(name, jax_results):
    hold(LAYERS[name], *jax_results[("layer", name)])


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_channel_dropout_layers_draw_whole_channels():
    """Dropout2D and Dropout3D in training keep about 1 - p of the
    channels, each divided by 1 - p, the rest 0, a whole channel at a
    time; one generator seed gives one mask; the layer's `seed` serves
    when no generator is passed; in eval mode they pass x through."""
    for layer, shape in ((pnn.Dropout2D(0.3), (40, 50, 3, 3)),
                         (pnn.Dropout3D(0.3), (40, 50, 2, 3, 2))):
        x = torch.rand(shape, generator=_gen(1)) + 0.5
        y = layer(x, generator=_gen())
        flat = y.flatten(2)
        kept = (flat != 0).all(2)
        assert ((flat != 0).all(2) | (flat == 0).all(2)).all()
        assert abs(kept.float().mean().item() - 0.7) < 0.03
        torch.testing.assert_close(y[kept], x[kept] / 0.7)
        assert torch.equal(y, layer(x, generator=_gen()))
        layer.eval()
        assert layer(x) is x
    seeded = pnn.Dropout3D(0.5, seed=3)
    x = torch.ones(8, 8, 2, 2, 2)
    assert torch.equal(seeded(x), pnn.Dropout3D(0.5, seed=3)(x))
    with pytest.raises(ValueError, match="generator"):
        PF.dropout3d(x, 0.5)


def test_alpha_dropout_layer_keeps_mean_and_variance():
    y = pnn.AlphaDropout(0.2)(torch.randn(100000, generator=_gen(2)),
                              generator=_gen())
    assert abs(y.mean().item()) < 0.02 and abs(y.var().item() - 1) < 0.03


def test_the_jax_quirks_are_kept():
    """What the JAX layers and functions ignore, the port ignores too:
    InstanceNorm2D's `momentum` and `data_format`, GroupNorm's and
    PixelShuffle's `data_format`, `conv2d_transpose`'s, AvgPool1D's
    `exclusive`; `hsigmoid_loss`'s `bias`, `path_table` and
    `path_code`.  SpectralNorm's `weight_u` and `weight_v` are
    parameters its forward never updates; an eager SyncBatchNorm is a
    BatchNorm; InstanceNorm1D and InstanceNorm3D are InstanceNorm2D."""
    x = torch.from_numpy(X4)
    cpu = {"device": "cpu"}
    torch.testing.assert_close(
        pnn.InstanceNorm2D(3, momentum=0.1, data_format="NHWC", **cpu)(x),
        pnn.InstanceNorm2D(3, **cpu)(x), rtol=0, atol=0)
    torch.testing.assert_close(
        pnn.GroupNorm(3, 3, data_format="NHWC", **cpu)(x),
        pnn.GroupNorm(3, 3, **cpu)(x), rtol=0, atol=0)
    assert pnn.InstanceNorm1D is pnn.InstanceNorm2D is pnn.InstanceNorm3D
    y = torch.from_numpy(rand_f((1, 8, 2, 3), seed=23))
    torch.testing.assert_close(pnn.PixelShuffle(2, "NHWC")(y),
                               pnn.PixelShuffle(2)(y), rtol=0, atol=0)
    w = torch.from_numpy(rand_f((3, 2, 3, 3), seed=24))
    torch.testing.assert_close(
        PF.conv2d_transpose(x, w, data_format="NHWC"),
        PF.conv2d_transpose(x, w), rtol=0, atol=0)
    s = torch.from_numpy(rand_f((2, 3, 7), seed=25))
    torch.testing.assert_close(pnn.AvgPool1D(3, 1, "SAME", exclusive=False)(s),
                               pnn.AvgPool1D(3, 1, "SAME")(s), rtol=0, atol=0)
    feat, lbl = torch.from_numpy(FEAT), torch.from_numpy(rand_i((4, 1), 6))
    weight = torch.from_numpy(rand_f((5, 5), seed=26))
    torch.testing.assert_close(
        PF.hsigmoid_loss(feat, lbl, 6, weight,
                         bias=torch.ones(5), path_table=torch.zeros(6, 3),
                         path_code=torch.ones(6, 3)),
        PF.hsigmoid_loss(feat, lbl, 6, weight), rtol=0, atol=0)
    sn = pnn.SpectralNorm((3, 2, 3, 3), power_iters=3,
                          generator=_gen(), **cpu)
    u, v = sn.weight_u.detach().clone(), sn.weight_v.detach().clone()
    sn(w)
    assert isinstance(sn.weight_u, torch.nn.Parameter)
    assert torch.equal(sn.weight_u, u) and torch.equal(sn.weight_v, v)
    sync, plain = pnn.SyncBatchNorm(3, **cpu), pnn.BatchNorm2D(3, **cpu)
    torch.testing.assert_close(sync(x), plain(x), rtol=0, atol=0)
    torch.testing.assert_close(sync._mean, plain._mean, rtol=0, atol=0)
