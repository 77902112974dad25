"""Port parity: pipeline-parallel training
(``paddle_tpu_torch.parallel.PipelinedTrainStep`` with `GPTPipeAdapter`)
against the JAX package's `PipelinedTrainStep` on its forced 8-device
CPU mesh.

The model is GPT at vocab 512, hidden 64, 4 layers, 2 heads, dropout 0
(the port through the plain versions of its flash kernels, JAX through
its composite attention), AdamW at lr 1e-3, the global batch 8 rows of
16 tokens, 2 steps; every port shard on the CPU.  Each JAX run happens
once per module (`_jax_run`'s cache).  Tolerances, as in
``test_torch_train_step.py``: fp32 losses within 1e-5 relative, all but
1 in 10^4 parameter entries within 1e-5 absolute, every entry within
2 x steps x lr.  Under bf16 amp the losses hold within 1e-4 and every
entry by the same bound, and all but 5 in 10^3 entries within 5e-4: the
JAX pipeline rounds the residual stream to bf16 after each block and at
each hand-off (its scan's carry), and so does the port, so each of the
4 blocks starts from a bf16 stream and a bf16 LayerNorm, where the
one-device step rounds once; a bf16 rounding taken the other way (XLA
keeps bf16 elementwise chains in float32; torch's CPU ``rsqrt`` of a
LayerNorm's 16 row statistics takes its scalar path at micro-batches of
one row) flips the sign of near-zero Adam steps.  Measured at this
seed: the port against JAX 2.9e-3 of the entries past 5e-4, JAX against
itself on the same batch split into other micro-batches ({"pipe": 4}, M
2) 1.0e-3.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JaxConfig
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.parallel.env import build_mesh as jax_mesh
from paddle_tpu.parallel.pipeline_compile import GPTPipeAdapter as JaxAdapter
from paddle_tpu.parallel.pipeline_compile import PipelinedTrainStep as JaxPipe
from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
from paddle_tpu_torch.optimizer import SGD, AdamW
from paddle_tpu_torch.parallel import (GPTPipeAdapter, PipelinedTrainStep,
                                       build_mesh)

CFG = dict(vocab_size=512, hidden_size=64, num_layers=4, num_heads=2,
           max_seq_len=64, dropout=0.0)
B, L, LR, WD, STEPS = 8, 16, 1e-3, 0.01, 2
TOLS = {None: dict(loss=1e-5, param=1e-5, share=1e-4),
        "bf16": dict(loss=1e-4, param=5e-4, share=5e-3)}


def _batch():
    rng = np.random.default_rng(1)
    return (rng.integers(0, CFG["vocab_size"], (B, L)).astype(np.int32),
            rng.integers(0, CFG["vocab_size"], (B, L)).astype(np.int32))


def _cpu_mesh(shape):
    return build_mesh(shape, devices=["cpu"] * int(np.prod(
        list(shape.values()))))


@functools.lru_cache(maxsize=None)
def _named():
    paddle.seed(7)
    model = JaxGPT(JaxConfig(**CFG))
    return {n: np.array(p._data) for n, p in model.named_parameters()}


@functools.lru_cache(maxsize=None)
def _jax_run(mesh_items, num_micro, zero_stage=1, amp=None):
    paddle.seed(7)
    model = JaxGPT(JaxConfig(**CFG))
    opt = paddle.optimizer.AdamW(learning_rate=LR, weight_decay=WD,
                                 parameters=model.parameters())
    tr = JaxPipe(JaxAdapter(model), opt, jax_mesh(dict(mesh_items)),
                 num_micro=num_micro, zero_stage=zero_stage,
                 amp_dtype=jnp.bfloat16 if amp else None)
    ids, lbl = _batch()
    losses = [float(np.asarray(tr.step(ids, lbl)._data))
              for _ in range(STEPS)]
    tr.sync_to_model()
    return losses, {n: np.array(p._data)
                    for n, p in model.named_parameters()}


def _port(mesh, num_micro, zero_stage=1, amp=None, opt=None, remat=True,
          dropout=0.0, seed=0):
    model = GPTForPretraining.from_numpy_params(
        _named(), GPTConfig(**dict(CFG, dropout=dropout, use_flash=True)),
        device="cpu")
    tr = PipelinedTrainStep(
        GPTPipeAdapter(model), opt or AdamW(LR, weight_decay=WD),
        _cpu_mesh(mesh), num_micro=num_micro, zero_stage=zero_stage,
        amp_dtype=torch.bfloat16 if amp else None, remat=remat, seed=seed)
    return model, tr


def _hold(got, want, tol):
    far, total = 0, 0
    for n, w in want.items():
        diff = np.abs(got[n] - w)
        assert diff.max() <= 2 * STEPS * LR, n
        mask = np.zeros(diff.shape, bool)
        if n.endswith("attn.qkv.bias"):     # the key bias: gradient 0
            mask.reshape(CFG["num_heads"], 3, -1)[:, 1] = True
        live = diff[~mask]
        far += int((live > tol["param"]).sum())
        total += live.size
    assert far <= total * tol["share"], (far, total)


@pytest.mark.parametrize("mesh,num_micro,zero_stage,amp", [
    ({"pipe": 4}, 2, 1, None),
    ({"pipe": 2, "data": 2}, 4, 0, None),
    ({"pipe": 2, "data": 2}, 4, 1, None),
    ({"pipe": 2, "data": 2}, 4, 1, "bf16")],
    ids=["pipe4", "pipe2-data2-zero0", "pipe2-data2-zero1",
         "pipe2-data2-zero1-bf16"])
def test_pipeline_matches_jax(mesh, num_micro, zero_stage, amp):
    want_l, want_p = _jax_run(tuple(mesh.items()), num_micro, zero_stage,
                              amp)
    model, tr = _port(mesh, num_micro, zero_stage, amp)
    assert tr.zero == (zero_stage >= 1 and "data" in mesh)
    ids, lbl = (torch.from_numpy(x) for x in _batch())
    got = [float(tr.step(ids, lbl)) for _ in range(STEPS)]
    tol = TOLS[amp]
    np.testing.assert_allclose(got, want_l, rtol=tol["loss"], atol=0)
    tr.sync_to_model()
    _hold(model.numpy_params(), want_p, tol)


def test_zero_shards_the_optimizer_state_over_data():
    """Under ZeRO each group's state is one range per data rank (and per
    stage for the blocks), padded to lcm(dp, 1024); without it, whole
    buffers padded to 1024."""
    _, tr = _port({"pipe": 2, "data": 2}, 4, 1)
    for lay, states in ((tr.other_layout, tr.state_other),
                        *((tr.block_layout, row) for row in tr.state_block)):
        assert lay.padded % 1024 == 0 and len(states) == 2
        assert all(st["moment1"].numel() == lay.padded // 2
                   for st in states)
    _, whole = _port({"pipe": 2, "data": 2}, 4, 0)
    assert len(whole.state_other) == 1
    assert whole.state_other[0]["moment1"].numel() == \
        whole.other_layout.padded


def test_state_dict_round_trip():
    """A fresh model loaded from the trained state reproduces its loss,
    and a pipeline built on it steps from that loss (the JAX package's
    ``test_pp_state_dict_roundtrip``)."""
    model, tr = _port({"pipe": 4}, 2, opt=SGD(0.1))
    ids, lbl = (torch.from_numpy(x).long() for x in _batch())
    tr.step(ids, lbl)
    sd = tr.state_dict()
    model2 = GPTForPretraining(GPTConfig(**dict(CFG, use_flash=True)),
                               seed=123, device="cpu")
    model2.load_state_dict(sd)
    with torch.no_grad():
        l2 = float(model2.loss(ids, lbl))
    tr2 = PipelinedTrainStep(GPTPipeAdapter(model2), SGD(0.1),
                             _cpu_mesh({"pipe": 4}), num_micro=2)
    np.testing.assert_allclose(float(tr2.step(ids, lbl)), l2, rtol=2e-6,
                               atol=0)


def test_remat_equals_plain_bitwise_at_dropout():
    """At dropout 0.1, remat on (each block recomputed in the backward
    from its forward's dropout masks) against off: the losses and the
    parameters after two steps are equal bitwise."""
    ids, lbl = (torch.from_numpy(x) for x in _batch())
    runs = []
    for remat in (False, True):
        model, tr = _port({"pipe": 2, "data": 2}, 4, remat=remat,
                          dropout=0.1, seed=3)
        runs.append(([float(tr.step(ids, lbl)) for _ in range(2)],
                     model.numpy_params()))
    assert runs[0][0] == runs[1][0]
    for n in runs[0][1]:
        np.testing.assert_array_equal(runs[0][1][n], runs[1][1][n])


@pytest.mark.parametrize("mesh,err,match", [
    ({"pipe": 2, "seq": 2}, NotImplementedError, "not ported"),
    ({"data": 2}, ValueError, "'pipe' axis"),
    ({"pipe": 3}, ValueError, "not divisible")])
def test_pipeline_refusals(mesh, err, match):
    model = GPTForPretraining(GPTConfig(**CFG), device="cpu")
    with pytest.raises(err, match=match):
        PipelinedTrainStep(GPTPipeAdapter(model), AdamW(LR),
                           _cpu_mesh(mesh), num_micro=2)
