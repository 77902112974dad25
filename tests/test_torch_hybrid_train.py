"""Port parity: tensor-, context- and expert-parallel GPT training
(``paddle_tpu_torch.parallel.CompiledTrainStep`` over the ``model``,
``seq`` and ``expert`` axes, `PipelinedTrainStep` over ``pipe`` x
``model``) against the JAX package's steps on its forced 8-device CPU
mesh, and GPT's and the BERT encoder's ``scan_layers``/``remat``.

Every port mesh puts its shards on the CPU (``devices=["cpu"] * n``).
The model is ``gpt_tiny`` (vocab 1024, hidden 64, 2 layers, 4 heads) at
dropout 0, composite attention, except the port's Ulysses case, which
takes the flash kernels' plain versions (JAX's Ulysses with its Pallas
flash does not trace: it hands the kernel a 2-D key mask where the
BlockSpec wants 3-D, so JAX runs its composite there), the global batch
4 rows of 32 tokens (as the JAX package's ``test_hybrid_5d.py``), two
steps.  Each JAX run happens
once per module (`_jax_run`'s cache).  Tolerances, as in
``test_torch_train_step.py``: each step's loss within 1e-5 relative;
after the steps all but 1 in 10^4 parameter entries within 1e-5
absolute, every entry within 2 x steps x lr for AdamW (an Adam step
moves a weight by at most about lr) and within 1e-4 for SGD.  The MoE
run also holds the routing: after the steps, every block's top-2 expert
choices over the batch equal JAX's, from each package's final
parameters.
"""
import functools

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
import paddle_tpu as paddle
import paddle_tpu.distributed.fleet.meta_parallel.moe_layer as jmoe
from paddle_tpu.models.bert import BertConfig as JaxBertConfig
from paddle_tpu.models.bert import BertForPretraining as JaxBert
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.parallel.env import build_mesh as jax_mesh
from paddle_tpu.parallel.hybrid import CompiledTrainStep as JaxStep
from paddle_tpu.parallel.pipeline_compile import GPTPipeAdapter as JaxAdapter
from paddle_tpu.parallel.pipeline_compile import PipelinedTrainStep as JaxPipe
from paddle_tpu_torch.distributed.fleet.meta_parallel import moe_layer
from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                     GPTConfig, GPTForPretraining, gpt_tiny)
from paddle_tpu_torch.optimizer import SGD, AdamW
from paddle_tpu_torch.parallel import (CompiledTrainStep, GPTPipeAdapter,
                                       PipelinedTrainStep, build_mesh)

B, L, STEPS, LR, WD = 4, 32, 2, 1e-3, 0.01
SGD_LR = 0.05
MESH_DMS = (("data", 2), ("model", 2), ("seq", 2))
MESH_DME = (("data", 2), ("model", 2), ("expert", 2))
MESH_DM = (("data", 2), ("model", 2))
MESH_PM = (("pipe", 2), ("model", 2))


def _batch(seed=10):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1024, (B, L)).astype(np.int32),
            rng.integers(0, 1024, (B, L)).astype(np.int32))


def _cpu_mesh(shape):
    return build_mesh(dict(shape), devices=["cpu"] * int(np.prod(
        [s for _, s in shape])))


def _loss_fn(m, ids, labels, generator):
    return m.loss(ids, labels, generator=generator)


def _jax_cfg(experts=0, cp_mode="ring", flash=False):
    cfg = jax_gpt_tiny()
    cfg.num_experts = experts
    cfg.cp_mode = cp_mode
    cfg.use_flash = flash
    return cfg


def _port_cfg(experts=0, cp_mode="ring", flash=False):
    return gpt_tiny(num_experts=experts, cp_mode=cp_mode, use_flash=flash)


@functools.lru_cache(maxsize=None)
def _named(experts=0):
    paddle.seed(11)
    model = JaxGPT(_jax_cfg(experts))
    return {n: np.array(p._data) for n, p in model.named_parameters()}


def _jax_model(experts=0, cp_mode="ring", flash=False):
    model = JaxGPT(_jax_cfg(experts, cp_mode, flash))
    named = _named(experts)
    for n, p in model.named_parameters():
        p._data = paddle.to_tensor(named[n])._data
    return model


@functools.lru_cache(maxsize=None)
def _jax_run(mesh, stage=1, experts=0, cp_mode="ring", flash=False,
             opt="adamw", num_micro=None):
    """`STEPS` JAX steps on `mesh` (pipelined when `num_micro`); the
    losses and the final parameters."""
    model = _jax_model(experts, cp_mode, flash)
    if opt == "sgd":
        jopt = paddle.optimizer.SGD(learning_rate=SGD_LR,
                                    parameters=model.parameters())
    else:
        jopt = paddle.optimizer.AdamW(learning_rate=LR, weight_decay=WD,
                                      parameters=model.parameters())
    if num_micro:
        tr = JaxPipe(JaxAdapter(model), jopt, jax_mesh(dict(mesh)),
                     num_micro=num_micro, zero_stage=stage)
    else:
        tr = JaxStep(model, lambda m, i, l: m.loss(i, l), jopt,
                     jax_mesh(dict(mesh)), zero_stage=stage)
    ids, lbl = _batch()
    losses = [float(np.asarray(tr.step(ids, lbl)._data))
              for _ in range(STEPS)]
    tr.sync_to_model()
    return losses, {n: np.array(p._data)
                    for n, p in model.named_parameters()}


def _port_model(experts=0, cp_mode="ring", flash=False):
    return GPTForPretraining.from_numpy_params(
        _named(experts), _port_cfg(experts, cp_mode, flash), device="cpu")


def _port_run(mesh, stage=1, experts=0, cp_mode="ring", flash=False,
              opt="adamw", num_micro=None, remat=False):
    model = _port_model(experts, cp_mode, flash)
    popt = SGD(SGD_LR) if opt == "sgd" else AdamW(LR, weight_decay=WD)
    if num_micro:
        tr = PipelinedTrainStep(GPTPipeAdapter(model), popt,
                                _cpu_mesh(mesh), num_micro=num_micro,
                                zero_stage=stage, remat=remat)
    else:
        tr = CompiledTrainStep(model, _loss_fn, popt, _cpu_mesh(mesh),
                               zero_stage=stage, remat=remat)
    ids, lbl = (torch.from_numpy(x) for x in _batch())
    losses = [float(tr.step(ids, lbl)) for _ in range(STEPS)]
    tr.sync_to_model()
    return losses, model.numpy_params(), tr


def _hold(got, want, bound, heads=4):
    """Every entry within `bound`; all but 1 in 10^4 within 1e-5, the key
    bias (head-major [H, 3, D] columns [h, 1, :], whose exact gradient is
    0 and which only rounding moves) aside."""
    far, total = 0, 0
    for n, w in want.items():
        diff = np.abs(got[n] - w)
        assert diff.max() <= bound, (n, diff.max())
        mask = np.zeros(diff.shape, bool)
        if n.endswith("attn.qkv.bias"):
            mask.reshape(heads, 3, -1)[:, 1] = True
        live = diff[~mask]
        far += int((live > 1e-5).sum())
        total += live.size
    assert far <= total * 1e-4, (far, total)


def _check(got, want, opt="adamw"):
    (gl, gp), (wl, wp) = got[:2], want
    np.testing.assert_allclose(gl, wl, rtol=1e-5, atol=0)
    _hold(gp, wp, 2 * STEPS * LR if opt == "adamw" else 1e-4)


# --------------------- CompiledTrainStep over the mesh ---------------------

@pytest.mark.parametrize("cp_mode,flash", [("ring", False),
                                           ("ulysses", True)],
                         ids=["ring", "ulysses-flash"])
def test_data_model_seq_zero3_matches_jax(cp_mode, flash):
    """{"data": 2, "model": 2, "seq": 2} at ZeRO 3: each rank holds half
    the heads and half the positions; the stored ranges are 1/dp of
    each model rank's padded local flat."""
    want = _jax_run(MESH_DMS, 3, cp_mode=cp_mode)
    got = _port_run(MESH_DMS, 3, cp_mode=cp_mode, flash=flash)
    _check(got, want)
    tr = got[2]
    assert len(tr.combos) == 2 and tr.group_size == 4
    lay = tr.layout
    assert all(s.numel() == lay.shard_len for shards in tr.pshards
               for s in shards)
    assert tr.layout.numel < sum(p.numel() for p in tr.params.values())
    sent = tr.collective_bytes_by_axis()
    assert sent["model"] > 0 and sent["seq"] > 0 and sent["data"] > 0


def test_data_model_zero0_matches_jax():
    want = _jax_run(MESH_DM, 0)
    got = _port_run(MESH_DM, 0)
    _check(got, want)
    # the replicated parameters stay equal across the model ranks
    tr = got[2]
    a, b = (next(iter(per.values())) for per in tr._leaves)
    assert torch.equal(a["gpt.ln_f.weight"], b["gpt.ln_f.weight"])


def _choices(fn, monkeypatch, module, attr):
    """Each call's top-2 expert choices while `fn` runs, through the
    routing function `attr` of `module`."""
    seen = []
    orig = getattr(module, attr)

    def record(logits, capacity):
        combine, dispatch, aux = orig(logits, capacity)
        seen.append(np.asarray(dispatch).any(-1))
        return combine, dispatch, aux

    monkeypatch.setattr(module, attr, record)
    fn()
    monkeypatch.setattr(module, attr, orig)
    return seen


def test_data_model_expert_moe_matches_jax(monkeypatch):
    """{"data": 2, "model": 2, "expert": 2} with 4 experts (each expert
    rank holds 2), SGD at the JAX package's default ZeRO 1; the expert
    choices from both final states are JAX's."""
    want = _jax_run(MESH_DME, 1, experts=4, opt="sgd")
    got = _port_run(MESH_DME, 1, experts=4, opt="sgd")
    _check(got, want, "sgd")
    tr = got[2]
    assert tr.shard_axes == ("model", "expert") and len(tr.combos) == 4
    ids, _ = _batch()
    jm = _jax_model(4)
    for n, p in jm.named_parameters():
        p._data = paddle.to_tensor(want[1][n])._data
    pm = GPTForPretraining.from_numpy_params(got[1], _port_cfg(4),
                                             device="cpu")
    with paddle.no_grad():
        jc = _choices(lambda: jm.loss(paddle.to_tensor(ids),
                                      paddle.to_tensor(ids)),
                      monkeypatch, jmoe, "_top2_dispatch")
    with torch.no_grad():
        pc = _choices(lambda: pm.loss(torch.from_numpy(ids),
                                      torch.from_numpy(ids)),
                      monkeypatch, moe_layer, "top2_dispatch")
    assert len(jc) == len(pc) == 2
    for a, b in zip(jc, pc):
        np.testing.assert_array_equal(b, a)


def test_pipe_model_matches_jax():
    """`PipelinedTrainStep` over {"pipe": 2, "model": 2}, 2 micro-batches,
    remat on (the default)."""
    want = _jax_run(MESH_PM, 1, num_micro=2)
    got = _port_run(MESH_PM, 1, num_micro=2, remat=True)
    _check(got, want)
    tr = got[2]
    assert len(tr.combos) == 2 and len(tr.state_block[0]) == 2


def test_seq_axis_needs_a_sharded_input():
    model = _port_model()
    tr = CompiledTrainStep(model, _loss_fn, AdamW(LR),
                           _cpu_mesh((("data", 2), ("seq", 2))))
    floats = torch.zeros(B, L)
    with pytest.raises(ValueError, match="no batch input is sharded"):
        tr.step(floats, floats)


# --------------------------- scan_layers and remat -------------------------

def _gpt_loss_and_grads(model, ids):
    loss = model.loss(ids, ids)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss.detach(), grads


@pytest.mark.parametrize("remat", [False, True])
def test_gpt_scan_layers_equals_the_loop(remat):
    """The port's scan is the loop bitwise (loss and every gradient), and
    JAX's scan within 1e-5."""
    ids = torch.from_numpy(_batch()[0])
    named = _named()
    runs = []
    for scan in (False, True):
        m = GPTForPretraining.from_numpy_params(
            named, gpt_tiny(scan_layers=scan, remat=remat), device="cpu")
        runs.append(_gpt_loss_and_grads(m, ids))
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)
    jcfg = _jax_cfg()
    jcfg.scan_layers, jcfg.remat = True, remat
    jm = JaxGPT(jcfg)
    for n, p in jm.named_parameters():
        p._data = paddle.to_tensor(named[n])._data
    jids = paddle.to_tensor(_batch()[0])
    with paddle.no_grad():
        want = float(np.asarray(jm.loss(jids, jids)._data))
    np.testing.assert_allclose(float(runs[1][0]), want, rtol=1e-5)


def test_bert_encoder_scan_layers_equals_the_loop():
    """BERT (tiny widths, 3 layers) with ``scan_layers``: loss and every
    gradient equal the loop bitwise, and the JAX scan within 1e-5."""
    widths = dict(vocab_size=1024, hidden_size=64, num_layers=3,
                  num_heads=4, ffn_hidden=128, max_seq_len=128, dropout=0.0)
    paddle.seed(3)
    jm = JaxBert(JaxBertConfig(**widths, scan_layers=True))
    named = {n: np.array(p._data) for n, p in jm.named_parameters()}
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 1024, (2, 16)).astype(np.int32)
    mlm = rng.integers(0, 1024, (2, 16)).astype(np.int32)
    nsp = np.array([0, 1], np.int32)
    runs = []
    for scan in (False, True):
        pm = BertForPretraining.from_numpy_params(
            named, BertConfig(**widths, scan_layers=scan), device="cpu")
        loss = pm.loss(*(torch.from_numpy(a) for a in (ids, mlm, nsp)))
        runs.append((loss.detach(), torch.autograd.grad(
            loss, list(pm.parameters()))))
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)
    with paddle.no_grad():
        want = float(np.asarray(jm.loss(*(paddle.to_tensor(a)
                                           for a in (ids, mlm, nsp)))._data))
    np.testing.assert_allclose(float(runs[1][0]), want, rtol=1e-5)


@pytest.mark.parametrize("shape,vocab,experts", [
    ((("data", 2), ("model", 2)), 1023, 0),
    ((("data", 2), ("expert", 2)), 1024, 3)],
    ids=["vocab-1023", "experts-3"])
def test_undivided_weights_stay_whole(shape, vocab, experts):
    """A vocabulary (or expert stack) the axis does not divide stays
    whole on every rank (its spec falls back to whole) and its layer
    computes as outside a group: two SGD steps equal the same step over
    ``{"data": 2}`` alone within 1e-5 (each data shard routes its own
    tokens, so the MoE is held to data shards, not one device)."""
    def cfg():
        return GPTConfig(vocab_size=vocab, hidden_size=64, num_layers=2,
                         num_heads=4, max_seq_len=128, dropout=0.0,
                         num_experts=experts)

    named = GPTForPretraining(cfg(), seed=2, device="cpu").numpy_params()
    ids, lbl = (torch.from_numpy(x % vocab) for x in _batch())
    runs = []
    for mesh in ((("data", 2),), shape):
        model = GPTForPretraining.from_numpy_params(named, cfg(),
                                                    device="cpu")
        tr = CompiledTrainStep(model, _loss_fn, SGD(SGD_LR),
                               _cpu_mesh(mesh))
        if mesh == shape:
            # the rest still shards: the heads over model; nothing over
            # expert
            assert tr.shard_axes == ("model",) * (experts == 0)
        runs.append(([float(tr.step(ids, lbl)) for _ in range(STEPS)],
                     (tr.sync_to_model(), model.numpy_params())[1]))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-5, atol=0)
    _hold(runs[1][1], runs[0][1], 1e-4)
