"""Port parity: the train step (``paddle_tpu_torch.parallel.TrainStep``
with ``optimizer.AdamW``) against the JAX package's
``CompiledTrainStep`` on a one-device mesh (ZeRO stage 0 there).

Both start from one GPT's weights (vocab 512, hidden 64, 2 layers, 2
heads, L 64, dropout 0, flash attention: JAX's Pallas kernels in
interpret mode, the port's plain versions) and take 3 AdamW steps (lr
1e-3, weight decay 0.01) on one numpy batch.  Tolerances:
- fp32: each step's loss within 1e-5 relative; after 3 steps all but
  1 in 10^4 parameter entries within 1e-5 absolute (an Adam step is
  lr * mhat / sqrt(vhat), so gradient differences of ~1e-6 relative
  move a weight by ~1e-9, except where a gradient nears 0 and rounding
  can flip the step), and every entry within 2 x 3 x lr (below);
- bf16 amp: each loss within 1e-4 relative, all but 1 in 10^3 entries
  within 5e-4 absolute: bf16 rounds weights and activations (2^-8
  relative) in another order in each framework, and the gradients so
  differ by ~1e-2 relative, so more steps flip;
- both: every entry within 2 x 3 x lr, since an Adam step moves a weight
  by at most about lr whatever its gradient, and 3 steps whose signs
  differ on a near-zero gradient part by at most that.
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import paddle_tpu as paddle
import paddle_tpu.ops.pallas.flash_attention  # noqa: F401
from paddle_tpu.models.gpt import GPTConfig as JaxConfig
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.parallel.env import build_mesh
from paddle_tpu.parallel.hybrid import CompiledTrainStep
from paddle_tpu_torch.models import gpt as pgpt
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import Adam, AdamW, L2Decay
from paddle_tpu_torch.parallel import TrainStep

JAX_FLASH = sys.modules["paddle_tpu.ops.pallas.flash_attention"]
CFG = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=2,
           max_seq_len=64, dropout=0.0, use_flash=True)
B, L, STEPS, LR, WD = 2, 64, 3, 1e-3, 0.01
TOLS = {None: dict(loss=1e-5, param=1e-5, share=1e-4),
        "bf16": dict(loss=1e-4, param=5e-4, share=1e-3)}


def _batch():
    rng = np.random.default_rng(1)
    return (rng.integers(0, CFG["vocab_size"], (B, L)).astype(np.int32),
            rng.integers(0, CFG["vocab_size"], (B, L)).astype(np.int32))


def _noise_only(name, shape):
    """Entries whose exact gradient is 0: the key bias, columns
    [h, 1, :] of the head-major [H, 3, D] qkv bias."""
    mask = np.zeros(shape, bool)
    if name.endswith("attn.qkv.bias"):
        mask.reshape(CFG["num_heads"], 3, -1)[:, 1] = True
    return mask


def _loss_fn(m, ids, labels, generator):
    return m.loss(ids, labels, generator=generator)


def _jax_run(amp, monkeypatch):
    """3 JAX steps; returns the initial weights, the losses, the final
    weights and the dtypes of q reaching the flash forward."""
    seen = []
    real = JAX_FLASH._flash_fwd_call

    def spy(qs, *args):
        seen.append(qs.dtype)
        return real(qs, *args)

    monkeypatch.setattr(JAX_FLASH, "_flash_fwd_call", spy)
    paddle.seed(7)
    model = JaxGPT(JaxConfig(**CFG))
    named = {n: np.array(p._data) for n, p in model.named_parameters()}
    opt = paddle.optimizer.AdamW(learning_rate=LR, weight_decay=WD,
                                 parameters=model.parameters())
    tr = CompiledTrainStep(model, lambda m, i, l: m.loss(i, l), opt,
                           build_mesh({"data": 1}),
                           amp_dtype=jnp.bfloat16 if amp else None)
    ids, lbl = _batch()
    losses = [float(np.asarray(tr.step(ids, lbl)._data))
              for _ in range(STEPS)]
    final = {n: np.asarray(v) for n, v in tr.params.items()}
    return named, losses, final, seen


def _port_step(named, amp, seed=0, dropout=None):
    cfg = dict(CFG, **({} if dropout is None else dict(dropout=dropout)))
    model = pgpt.GPTForPretraining.from_numpy_params(
        named, pgpt.GPTConfig(**cfg), device="cpu")
    return TrainStep(model, _loss_fn, AdamW(learning_rate=LR,
                                            weight_decay=WD),
                     amp_dtype=torch.bfloat16 if amp else None, seed=seed,
                     device="cpu")


@pytest.mark.parametrize("amp", [None, "bf16"])
def test_three_adamw_steps_match_compiled_train_step(amp, monkeypatch):
    named, losses, final, seen = _jax_run(amp, monkeypatch)
    # the JAX step's flash kernel gets f32 q/k/v even under bf16 amp:
    # LayerNorm's f32 weight promotes every activation before attention
    assert seen and all(dt == jnp.float32 for dt in seen)
    tr = _port_step(named, amp)
    ids, lbl = (torch.from_numpy(x) for x in _batch())
    got = [float(tr.step(ids, lbl)) for _ in range(STEPS)]
    tol = TOLS[amp]
    np.testing.assert_allclose(got, losses, rtol=tol["loss"], atol=0)
    assert got[-1] < got[0]
    far, total = 0, 0
    for n, p in tr.model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        diff = np.abs(p.detach().numpy() - final[n])
        # the hard bound: no Adam step moves a weight much more than lr
        assert diff.max() <= 2 * STEPS * LR, n
        live = diff[~_noise_only(n, diff.shape)]
        far += int((live > tol["param"]).sum())
        total += live.size
    # near-zero gradients let rounding flip an Adam step
    assert far <= total * tol["share"], (far, total)


def test_bf16_amp_dtype_flow():
    """Under bf16 amp: the embedding sum and its dropout and block 0's
    first LayerNorm input are bf16; the LayerNorm's f32 weight promotes,
    so q/k/v reach attention in f32, the logits are f32, and the grads
    reach the f32 parameters in f32."""
    model = pgpt.GPTForPretraining(pgpt.GPTConfig(**CFG), device="cpu")
    tr = TrainStep(model, _loss_fn, AdamW(LR), amp_dtype=torch.bfloat16,
                   device="cpu")
    seen = {}

    def note(name, inputs=False):
        def hook(mod, args, out):
            seen[name] = (args[0] if inputs else out).dtype
        return hook

    gpt = model.gpt
    hooks = [gpt.wte.register_forward_hook(note("wte")),
             gpt.drop.register_forward_hook(note("embed_dropout")),
             gpt.blocks[0].ln1.register_forward_hook(note("ln1_in", True)),
             gpt.blocks[0].ln1.register_forward_hook(note("ln1_out")),
             gpt.blocks[0].attn.qkv.register_forward_hook(note("qkv")),
             gpt.blocks[1].mlp.register_forward_hook(note("mlp")),
             gpt.ln_f.register_forward_hook(note("ln_f"))]
    from paddle_tpu_torch.ops import attention

    real = attention.flash_attention

    def flash_spy(q, k, v, **kw):
        seen.setdefault("qkv_at_attention", set()).update(
            {q.dtype, k.dtype, v.dtype})
        return real(q, k, v, **kw)

    attention.flash_attention = flash_spy
    try:
        ids, lbl = (torch.from_numpy(x) for x in _batch())
        loss = tr.loss(ids, lbl)
        logits_dtype = model.lm_logits(torch.zeros(1, 1, 64)).dtype
        loss.backward()
    finally:
        attention.flash_attention = real
        for h in hooks:
            h.remove()
    bf16, f32 = torch.bfloat16, torch.float32
    assert seen == {"wte": bf16, "embed_dropout": bf16, "ln1_in": bf16,
                    "ln1_out": f32, "qkv": f32, "mlp": f32, "ln_f": f32,
                    "qkv_at_attention": {f32}}
    assert loss.dtype == f32 and logits_dtype == f32
    assert all(p.grad.dtype == f32 for p in model.parameters())


def test_dropout_draws_from_the_step_seed():
    """dropout 0.1: one seed gives the same losses twice, another seed
    other losses; dropout 0 would give equal losses for every seed."""
    named = pgpt.GPTForPretraining(pgpt.GPTConfig(**CFG),
                                   device="cpu").numpy_params()
    ids, lbl = (torch.from_numpy(x) for x in _batch())

    def losses(seed):
        tr = _port_step(named, None, seed=seed, dropout=0.1)
        return [float(tr.step(ids, lbl)) for _ in range(2)]

    a, b, c = losses(3), losses(3), losses(4)
    assert a == b
    assert a[0] != c[0] and a[1] != c[1]


@pytest.mark.parametrize("option", [
    dict(num_experts=2), dict(cp_mode="ulysses"), dict(scan_layers=True),
    dict(scan_layers=True, remat=True)],
    ids=["experts", "cp_mode", "scan_layers", "remat"])
def test_model_options_build_and_match_jax(option):
    """Each option of the JAX model builds and runs in the port: on one
    device the loss holds to the JAX model's with the same option within
    1e-5 and every gradient within 1e-4 (``cp_mode`` acts only under a
    ``seq`` axis; ``scan_layers`` and ``remat`` are the loop's
    arithmetic; 2 experts route each token).  Composite attention: the
    flash path is held above."""
    widths = dict(CFG, use_flash=False)
    cfg = JaxConfig(**widths)
    for k, v in option.items():
        setattr(cfg, k, v)
    paddle.seed(7)
    jm = JaxGPT(cfg)
    named = {n: np.array(p._data) for n, p in jm.named_parameters()}
    ids, lbl = _batch()
    loss = jm.loss(paddle.to_tensor(ids), paddle.to_tensor(lbl))
    loss.backward()
    pm = pgpt.GPTForPretraining.from_numpy_params(
        named, pgpt.GPTConfig(**widths, **option), device="cpu")
    got = pm.loss(torch.from_numpy(ids), torch.from_numpy(lbl))
    got.backward()
    np.testing.assert_allclose(float(got.detach()),
                               float(np.asarray(loss._data)), rtol=1e-5)
    for n, p in jm.named_parameters():
        np.testing.assert_allclose(
            dict(pm.named_parameters())[n].grad.numpy(),
            np.asarray(p.grad._data), rtol=1e-4, atol=1e-4, err_msg=n)


@pytest.mark.parametrize("option", [
    dict(learning_rate=lambda: 1e-3),
    dict(grad_clip=ClipGradByGlobalNorm(1.0)),
    dict(apply_decay_param_fun=lambda n: True), dict(lr_ratio=0.5)])
def test_unported_optimizer_options_raise(option):
    """The compiled step refuses what the JAX one ignores (the eager step
    applies the clip and the decay function); a callable learning rate
    and ``lr_ratio`` raise on every path."""
    model = pgpt.GPTForPretraining(pgpt.GPTConfig(**CFG), device="cpu")
    with pytest.raises(NotImplementedError):
        TrainStep(model, _loss_fn, AdamW(**option), device="cpu")


@pytest.mark.parametrize("attr", [
    dict(regularizer=L2Decay(0.1)), dict(optimize_attr={
        "learning_rate": 0.5})], ids=["regularizer", "learning_rate"])
def test_per_parameter_attributes_raise_in_the_compiled_step(attr):
    model = pgpt.GPTForPretraining(pgpt.GPTConfig(**CFG), device="cpu")
    p = next(model.parameters())
    for k, v in attr.items():
        setattr(p, k, v)
    with pytest.raises(NotImplementedError, match="per-parameter"):
        TrainStep(model, _loss_fn, AdamW(), device="cpu")


def test_step_refuses_parameters_off_its_device():
    model = pgpt.GPTForPretraining(pgpt.GPTConfig(**CFG), device="cpu")
    with pytest.raises(ValueError, match="is on cpu"):
        TrainStep(model, _loss_fn, AdamW(), device="meta")


@pytest.mark.parametrize("name", ["Adam", "AdamW"])
def test_fused_update_matches_jax(name):
    """Three fused updates of two parameters (one 2-D, one 1-D, decayed
    alike) against the JAX optimizer's ``fused_update``: Adam adds wd * p
    to the gradient, AdamW subtracts lr * wd * p_old after the step.
    fp32 elementwise arithmetic in one order: 1e-6 relative."""
    rng = np.random.default_rng(4)
    params = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(4).astype(np.float32)}
    grads = [{n: rng.standard_normal(p.shape).astype(np.float32)
              for n, p in params.items()} for _ in range(3)]
    jopt = getattr(paddle.optimizer, name)(learning_rate=LR,
                                           weight_decay=0.1)
    popt = {"Adam": Adam, "AdamW": AdamW}[name](learning_rate=LR,
                                                 weight_decay=0.1)
    jp = {n: jnp.asarray(p) for n, p in params.items()}
    js = jopt.init_fused_states(jp)
    tp = {n: torch.from_numpy(p) for n, p in params.items()}
    ts = {n: popt.init_state(p) for n, p in tp.items()}
    for g in grads:
        jp, js = jopt.fused_update(jp, {n: jnp.asarray(x)
                                        for n, x in g.items()}, js,
                                   np.float32(LR))
        tp, ts = popt.fused_update(tp, {n: torch.from_numpy(x)
                                        for n, x in g.items()}, ts, LR)
    for n in params:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   rtol=1e-6, atol=1e-7)
        for k in ("moment1", "moment2", "beta1_pow", "beta2_pow"):
            assert ts[n][k].dtype == torch.float32
            np.testing.assert_allclose(ts[n][k].numpy(),
                                       np.asarray(js[n][k]), rtol=1e-6)
