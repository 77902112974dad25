"""Port parity: dygraph AMP (``paddle_tpu_torch.amp``), op by op, and
the loss scaler.

Per op: each op the port casts at entry (``linear``, ``linear_nobias``,
``matmul_v2``, ``conv2d`` with its bias, ``sdp_attention``,
``flash_attention``) and the black-listed ones it leaves alone
(``layer_norm``, ``cross_entropy``), under O1, O2 and custom lists,
against the JAX op in eager AMP: output dtypes equal, values within
`OP_TOL` (one op in bf16: a few ulps); gradients come back in each
input's dtype; the state nests and restores; O2 after `decorate` casts
parameters and buffers as the JAX ``Layer.to`` does.  Whole models are
in ``test_torch_amp_models.py``.

GradScaler: its scale sequence over a scripted run of finite and
non-finite gradients equals the JAX scaler's exactly, a skipped step
leaves parameters, optimizer state and step count alone, and a JAX
``state_dict`` loads into the port's."""
import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as conftest sets)
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.ops import math as JM
from paddle_tpu.ops.attention import \
    scaled_dot_product_attention as jax_sdpa
from paddle_tpu_torch import amp as pamp
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.ops.attention import \
    scaled_dot_product_attention as port_sdpa

OP_TOL = dict(atol=2e-2, rtol=2e-2)


def _f32(a):
    return np.asarray(a).astype(np.float32)


def _rng_arrays(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jt(a, grad=False):
    t = paddle.to_tensor(a)
    t.stop_gradient = not grad
    return t


def _pt(a, grad=False):
    return torch.from_numpy(a).requires_grad_(grad)


def _jlinear(x, w, b):
    return JF.linear(x, w, b)


def _ops():
    """name -> (input shapes, JAX call, port call, a mask index or None)."""
    mask = np.zeros((2, 1, 1, 16), np.float32)
    mask[1, ..., -5:] = -1e4
    return {
        "linear": ([(4, 8), (8, 6), (6,)], _jlinear,
                   lambda x, w, b: PF.linear(x, w, b)),
        "linear_nobias": ([(4, 8), (8, 6)], lambda x, w: JF.linear(x, w),
                          lambda x, w: PF.linear(x, w)),
        "matmul_v2": ([(3, 4, 8), (6, 8)],
                      lambda x, y: JM.matmul(x, y, transpose_y=True),
                      lambda x, y: PF.matmul(x, y, transpose_y=True)),
        "conv2d": ([(2, 3, 8, 8), (4, 3, 3, 3), (4,)],
                   lambda x, w, b: JF.conv2d(x, w, b, padding=1),
                   lambda x, w, b: PF.conv2d(x, w, b, padding=1)),
        "sdp_attention": (
            [(2, 2, 16, 8)] * 3,
            lambda q, k, v: jax_sdpa(q, k, v, attn_mask=_jt(mask))[0],
            lambda q, k, v: port_sdpa(q, k, v,
                                      attn_mask=_pt(mask))[0]),
        "flash_attention": (
            [(2, 2, 16, 8)] * 3,
            lambda q, k, v: jax_sdpa(q, k, v, attn_mask=_jt(mask),
                                     is_causal=True, use_flash=True)[0],
            lambda q, k, v: port_sdpa(q, k, v, attn_mask=_pt(mask),
                                      is_causal=True, use_flash=True)[0]),
        "layer_norm": ([(4, 8), (8,), (8,)],
                       lambda x, w, b: JF.layer_norm(x, 8, w, b),
                       lambda x, w, b: PF.layer_norm(x, w, b)),
        "cross_entropy": ([(6, 10)],
                          lambda x: JF.cross_entropy(
                              x, _jt(np.arange(6).reshape(6, 1))),
                          lambda x: PF.cross_entropy(
                              x, _pt(np.arange(6).reshape(6, 1)))),
    }


# (op, amp settings, input dtypes): bf16 inputs where a black-listed op
# should keep them; "off" runs without auto_cast
CASES = [
    ("linear", "O1", None), ("linear", "O2", None), ("linear", "off", None),
    ("linear", "black", None), ("linear_nobias", "O1", None),
    ("matmul_v2", "O1", None), ("matmul_v2", "O2", None),
    ("conv2d", "O1", None), ("conv2d", "O2", None),
    ("conv2d", "white_bias", None), ("sdp_attention", "O1", None),
    ("flash_attention", "O1", None), ("layer_norm", "O1", None),
    ("layer_norm", "O2", "bf16"), ("cross_entropy", "O1", "bf16"),
    ("cross_entropy", "O1", None),
]


def _settings(level, op):
    if level == "off":
        return None
    if level == "black":
        return dict(custom_black_list=[op])
    if level == "white_bias":
        return dict(custom_white_list=["conv2d_bias"])
    return dict(level=level)


@pytest.mark.parametrize("op,level,dtype", CASES,
                         ids=[f"{o}-{lv}-{d or 'f32'}" for o, lv, d in CASES])
def test_op_dtype_and_values_match_jax(op, level, dtype):
    import contextlib

    shapes, jfn, pfn = _ops()[op]
    arrays = _rng_arrays(*shapes, seed=len(op))
    if dtype == "bf16":
        arrays[0] = arrays[0].astype(jnp.bfloat16)
    settings = _settings(level, op)
    jctx = (paddle.amp.auto_cast(**settings) if settings is not None
            else contextlib.nullcontext())
    pctx = (pamp.auto_cast(**settings) if settings is not None
            else contextlib.nullcontext())
    j_in = [_jt(a, grad=True) for a in arrays]
    p_in = [_pt(np.asarray(a, np.float32), grad=True) for a in arrays]
    if dtype == "bf16":
        p_in[0] = p_in[0].detach().to(torch.bfloat16).requires_grad_()
    with jctx:
        jout = jfn(*j_in)
    with pctx:
        pout = pfn(*p_in)
    assert str(pout.dtype).replace("torch.", "") == str(jout._data.dtype)
    np.testing.assert_allclose(pout.detach().float().numpy(),
                               _f32(jout._data), **OP_TOL)
    # gradients come back in each input's own dtype
    pout.float().sum().backward()
    for t in p_in:
        assert t.grad is not None and t.grad.dtype == t.dtype


def test_nesting_restores_state_and_lists():
    import importlib

    ac = importlib.import_module("paddle_tpu_torch.amp.auto_cast")
    assert not ac.amp_enabled()
    with pamp.auto_cast(custom_white_list=["conv2d_bias"]):
        assert ac.amp_should_cast("conv2d_bias")
        with pamp.auto_cast(enable=False):
            assert not ac.amp_enabled()
            assert not ac.amp_should_cast("linear")
        with pamp.auto_cast(level="O2", dtype="float16"):
            assert ac.amp_dtype() == torch.float16
            assert ac.amp_should_cast("elementwise_add")
            assert not ac.amp_should_cast("layer_norm")
        assert ac.amp_dtype() == torch.bfloat16
        assert ac.amp_should_cast("conv2d_bias")
        assert not ac.amp_should_cast("elementwise_add")
    assert not ac.amp_enabled()
    assert pamp.white_list == paddle.amp.white_list
    assert pamp.black_list == paddle.amp.black_list


def test_o2_decorate_casts_parameters_and_buffers_as_jax():
    """O2 after `decorate`: every parameter and floating buffer bf16 (as
    the JAX ``Layer.to``), and a LeNet's logits in the JAX model's dtype
    and within bf16 of them."""
    from paddle_tpu.amp.auto_cast import decorate as jax_decorate
    from paddle_tpu.vision.models import LeNet as JaxLeNet
    from paddle_tpu_torch.models import layer_from_numpy
    from paddle_tpu_torch.vision.models import LeNet

    paddle.seed(2)
    jnet = JaxLeNet()
    state = {n: np.asarray(t._data) for n, t in jnet.state_dict().items()}
    pnet = layer_from_numpy(LeNet(device="cpu"), state, device="cpu")
    bn = pnn.BatchNorm2D(4)
    pamp.decorate([pnet, bn], level="O2")
    jax_decorate(jnet, level="O2")
    assert {p.dtype for p in pnet.parameters()} == {torch.bfloat16}
    assert {b.dtype for b in bn.buffers()} == {torch.bfloat16}
    img = _rng_arrays((2, 1, 28, 28), seed=9)[0]
    with paddle.amp.auto_cast(level="O2"):
        jout = jnet(paddle.to_tensor(img))
    with pamp.auto_cast(level="O2"):
        pout = pnet(torch.from_numpy(img))
    assert str(pout.dtype).replace("torch.", "") == str(jout._data.dtype)
    np.testing.assert_allclose(pout.float().detach().numpy(),
                               _f32(jout._data), atol=5e-2, rtol=5e-2)
    assert pamp.decorate(pnet, optimizers="opt") == (pnet, "opt")


# ----------------------------- GradScaler --------------------------------

# 1 means a finite step, 0 a step whose gradient holds an inf or a nan
SCRIPT = [1, 1, 0, 1, 1, 1, 0, 0, 1, 1, 1, 1, 1, 0, 1]
SCALER = dict(init_loss_scaling=1024.0, incr_every_n_steps=3,
              decr_every_n_nan_or_inf=2, incr_ratio=2.0, decr_ratio=0.5)


def test_grad_scaler_sequence_matches_jax_exactly():
    jw = _jt(np.ones(3, np.float32), grad=True)
    jopt = paddle.optimizer.SGD(learning_rate=0.1, parameters=[jw])
    js = paddle.amp.GradScaler(**SCALER)
    pw = pnn.create_parameter([3], generator=torch.Generator())
    with torch.no_grad():
        pw.fill_(1.0)
    popt_ = popt.SGD(learning_rate=0.1, parameters=[pw])
    ps = pamp.GradScaler(**SCALER)
    seq_j, seq_p = [], []
    for i, ok in enumerate(SCRIPT):
        bad = np.float32(1.0) if ok else np.float32(np.inf if i % 2 else
                                                    np.nan)
        g = np.array([1.0, 2.0, 3.0], np.float32) * bad
        for w, scaler, opt, seq in ((jw, js, jopt, seq_j),
                                    (pw, ps, popt_, seq_p)):
            before = _f32(w._data) if w is jw else w.detach().numpy().copy()
            if w is jw:
                loss = JM.sum(JM.multiply(jw, _jt(g * scaler._scale)))
                loss.backward()
            else:
                w.grad = torch.from_numpy(g * scaler._scale)
            scaler.step(opt)
            after = _f32(w._data) if w is jw else w.detach().numpy()
            seq.append((scaler._scale, scaler._good_steps,
                        scaler._bad_steps, bool((after != before).any())))
            opt.clear_grad()
    assert seq_p == seq_j
    assert [moved for *_, moved in seq_p] == [bool(x) for x in SCRIPT]
    assert ps.state_dict() == js.state_dict()


def test_skipped_step_leaves_optimizer_state_and_loads_jax_state():
    pw = pnn.create_parameter([4], generator=torch.Generator())
    opt = popt.Adam(learning_rate=0.1, parameters=[pw])
    scaler = pamp.GradScaler(init_loss_scaling=8.0)
    pw.grad = torch.ones(4) * 8.0
    scaler.step(opt)
    state = {k: v.clone() if torch.is_tensor(v) else v
             for k, v in opt.state_dict().items()}
    before = pw.detach().clone()
    pw.grad = torch.tensor([1.0, float("inf"), 0.0, 1.0])
    scaler.step(opt)
    assert torch.equal(pw.detach(), before)
    after = opt.state_dict()
    assert after["global_step"] == state["global_step"] == 1
    for k, v in state.items():
        if torch.is_tensor(v):
            assert torch.equal(after[k], v), k
    js = paddle.amp.GradScaler(init_loss_scaling=64.0)
    js._good_steps, js._bad_steps = 5, 1
    ps = pamp.GradScaler()
    ps.load_state_dict(js.state_dict())
    assert ps.state_dict() == js.state_dict()
    with pytest.raises(NotImplementedError):
        pw.grad = torch.ones(4).to_sparse()
        scaler.unscale_(opt)


