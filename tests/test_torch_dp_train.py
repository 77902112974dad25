"""Port parity: the mesh, the collectives and data-parallel training
(``paddle_tpu_torch.parallel``: `build_mesh`, ``collective``,
``topology``, `DataParallel` and `CompiledTrainStep` at ZeRO stages
0-3, and beside ``data`` each of the ``model``, ``seq`` and ``expert``
axes) against the JAX package on its forced 8-device CPU mesh.

Every port mesh here puts its shards on the CPU (``devices=["cpu"] *
n``).  The model is GPT at vocab 512, hidden 64, 2 layers, 2 heads,
dropout 0, composite attention, and the global batch is 8 rows of 16
tokens (the JAX step splits it over ``data``).  Each JAX run happens
once per module (`_jax_run`'s cache) and feeds every case that compares
against it.  Tolerances, as in ``test_torch_train_step.py``:
- fp32: each step's loss within 1e-5 relative; after the steps all but
  1 in 10^4 parameter entries within 1e-5 absolute, every entry within
  2 x steps x lr (an Adam step moves a weight by at most about lr, so
  steps whose signs differ on a near-zero gradient part by at most
  that);
- bf16 amp: each loss within 1e-4 relative, all but 1 in 10^3 entries
  within 5e-4.
SGD at every stage is held to the port's own one-device `TrainStep` on
the global batch (the mean over shards is the only difference), by the
fp32 rule.  The collectives are held to JAX's on the same seeded input
at 1e-6 relative (float32 sums of at most 8 terms in rank order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
import paddle_tpu as paddle
import paddle_tpu.parallel.collective as jcol
import paddle_tpu.parallel.env as jenv
from paddle_tpu.models.bert import BertForPretraining as JaxBert
from paddle_tpu.models.bert import bert_tiny as jax_bert_tiny
from paddle_tpu.models.gpt import GPTConfig as JaxConfig
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.parallel.hybrid import CompiledTrainStep as JaxStep
from paddle_tpu.parallel.topology import CommunicateTopology as JaxTopo
from paddle_tpu.parallel.topology import HybridCommunicateGroup as JaxHCG
from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                     GPTConfig, GPTForPretraining)
from paddle_tpu_torch.optimizer import SGD, AdamW, Lamb
from paddle_tpu_torch.optimizer import lr as plr
from paddle_tpu_torch.parallel import (CommunicateTopology,
                                       CompiledTrainStep, DataParallel,
                                       HybridCommunicateGroup, Mesh, TPMesh,
                                       TrainStep, build_mesh, tp_mesh)
from paddle_tpu_torch.parallel import collective as pcol
from paddle_tpu_torch.parallel import env as penv

CFG = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=2,
           max_seq_len=64, dropout=0.0)
B, L, LR, WD = 8, 16, 1e-3, 0.01
TOLS = {None: dict(loss=1e-5, param=1e-5, share=1e-4),
        "bf16": dict(loss=1e-4, param=5e-4, share=1e-3)}


def _batch(b=B, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, CFG["vocab_size"], (b, L)).astype(np.int32),
            rng.integers(0, CFG["vocab_size"], (b, L)).astype(np.int32))


def _cpu_mesh(shape):
    return build_mesh(shape, devices=["cpu"] * int(np.prod(
        list(shape.values()))))


def _loss_fn(m, ids, labels, generator):
    return m.loss(ids, labels, generator=generator)


def _jax_opt(name, params):
    if name == "lamb":
        return paddle.optimizer.Lamb(learning_rate=LR, parameters=params)
    if name == "sgd":
        return paddle.optimizer.SGD(learning_rate=0.1, parameters=params)
    return paddle.optimizer.AdamW(learning_rate=LR, weight_decay=WD,
                                  parameters=params)


def _port_opt(name):
    if name == "lamb":
        return Lamb(learning_rate=LR)
    if name == "sgd":
        return SGD(learning_rate=0.1)
    return AdamW(learning_rate=LR, weight_decay=WD)


@functools.lru_cache(maxsize=None)
def _named():
    paddle.seed(7)
    model = JaxGPT(JaxConfig(**CFG))
    return {n: np.array(p._data) for n, p in model.named_parameters()}


@functools.lru_cache(maxsize=None)
def _jax_run(dp, stage, opt="adamw", amp=None, steps=2):
    """`steps` JAX steps of the global batch on ``{"data": dp}``; the
    losses and the final parameters."""
    paddle.seed(7)
    model = JaxGPT(JaxConfig(**CFG))
    tr = JaxStep(model, lambda m, i, l: m.loss(i, l),
                 _jax_opt(opt, model.parameters()),
                 jenv.build_mesh({"data": dp}), zero_stage=stage,
                 amp_dtype=jnp.bfloat16 if amp else None)
    ids, lbl = _batch()
    losses = [float(np.asarray(tr.step(ids, lbl)._data))
              for _ in range(steps)]
    tr.sync_to_model()
    return losses, {n: np.array(p._data)
                    for n, p in model.named_parameters()}


def _port_run(mesh, stage, opt="adamw", amp=None, steps=2, **kw):
    model = GPTForPretraining.from_numpy_params(
        _named(), GPTConfig(**CFG), device="cpu")
    if mesh is None:
        tr = TrainStep(model, _loss_fn, _port_opt(opt), device="cpu",
                       amp_dtype=torch.bfloat16 if amp else None)
    else:
        tr = CompiledTrainStep(model, _loss_fn, _port_opt(opt),
                               _cpu_mesh(mesh), zero_stage=stage,
                               amp_dtype=torch.bfloat16 if amp else None,
                               **kw)
    ids, lbl = (torch.from_numpy(x) for x in _batch())
    losses = [float(tr.step(ids, lbl)) for _ in range(steps)]
    tr.sync_to_model()
    return losses, model.numpy_params(), tr


def _noise_only(name, shape):
    """The key bias ([h, 1, :] of the head-major qkv bias): its exact
    gradient is 0 and only rounding moves it."""
    mask = np.zeros(shape, bool)
    if name.endswith("attn.qkv.bias"):
        mask.reshape(CFG["num_heads"], 3, -1)[:, 1] = True
    return mask


def _hold(got, want, tol, bound):
    far, total = 0, 0
    for n, w in want.items():
        diff = np.abs(got[n] - w)
        assert diff.max() <= bound, n
        live = diff[~_noise_only(n, diff.shape)]
        far += int((live > tol["param"]).sum())
        total += live.size
    assert far <= total * tol["share"], (far, total)


# ------------------------------- the mesh ---------------------------------

@pytest.fixture
def global_meshes():
    """Both packages' global meshes and default groups restored after the
    test."""
    saved = (jenv._global_mesh, jenv._initialized, jcol._default_group,
             penv._global_mesh, penv._initialized, pcol._default_group)
    yield
    (jenv._global_mesh, jenv._initialized, jcol._default_group,
     penv._global_mesh, penv._initialized, pcol._default_group) = saved


@pytest.mark.parametrize("shape", [{"data": 8}, {"data": 2, "pipe": 4},
                                   {"pipe": 2, "data": 2, "model": 2}])
def test_build_mesh_matches_jax_layout(shape):
    """Axis order, sizes and every shard's device: the port's grid over
    cards 0..n-1 holds JAX's device ids, coordinate for coordinate."""
    jm = jenv.build_mesh(shape)
    pm = build_mesh(shape, devices=[torch.device("cuda", i)
                                    for i in range(8)][:jm.devices.size])
    assert pm.axis_names == tuple(jm.axis_names)
    assert pm.shape == dict(jm.shape)
    ids = np.vectorize(lambda d: d.index)(pm.device_grid)
    np.testing.assert_array_equal(ids, np.vectorize(lambda d: d.id)(
        jm.devices))
    for i in range(pm.size):
        c = pm.coords(i)
        assert pm.index(**c) == i
        assert pm.devices[i].index == jm.devices[tuple(c.values())].id
    axis = pm.axis_names[-1]
    fixed = {a: 1 for a in pm.axis_names[:-1]}
    assert [d.index for d in pm.axis_devices(axis, **fixed)] == [
        d.id for d in jm.devices[tuple(1 for _ in fixed)].ravel()]


def test_tp_mesh_is_a_one_axis_mesh():
    m = tp_mesh(4, devices=["cpu"] * 4)
    assert isinstance(m, TPMesh) and isinstance(m, Mesh)
    assert m.shape == {"model": 4} and m.devices == (torch.device("cpu"),) * 4
    assert m.axis_devices("model") == m.devices and m.tp_axis() == "model"
    assert len(m.replicate(torch.zeros(2))) == 4


@pytest.mark.parametrize("build,err", [
    (lambda: build_mesh({"data": 2}, dcn_shape_dict={"data": 2}),
     NotImplementedError),
    (lambda: build_mesh({"data": 2, "pipe": 2}, devices=["cpu"] * 3),
     ValueError),
    (lambda: build_mesh({"data": 10 ** 3}), ValueError),
    (lambda: Mesh(["cpu"] * 4, ("data", "pipe")), ValueError)],
    ids=["dcn", "count", "cards", "grid"])
def test_mesh_refusals(build, err):
    with pytest.raises(err):
        build()


def test_global_mesh_rank_and_world_size(global_meshes):
    penv.set_global_mesh(None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices="):
            penv.global_mesh()
    env = penv.init_parallel_env((2, 4), ("data", "pipe"),
                                 devices=["cpu"] * 8)
    assert penv.is_initialized() and penv.global_mesh().shape == {
        "data": 2, "pipe": 4}
    assert env.rank == penv.get_rank() == 0
    assert env.world_size == penv.get_world_size() == 8
    assert penv.get_world_size(pcol.Group(0, 3)) == 3


def test_topology_matches_jax(global_meshes):
    names, dims = ["data", "pipe", "sharding", "model"], [2, 2, 1, 2]
    jt, pt = JaxTopo(names, dims), CommunicateTopology(names, dims)
    for a in names:
        assert pt.get_comm_list(a) == jt.get_comm_list(a)
        assert pt.get_dim(a) == jt.get_dim(a)
    for r in range(8):
        assert tuple(pt.get_coord(r)) == tuple(jt.get_coord(r))
        assert pt.get_rank_from_stage(r, pipe=1) == \
            jt.get_rank_from_stage(r, pipe=1)
    jh, ph = JaxHCG(jt), HybridCommunicateGroup(pt)
    for k in ("get_parallel_mode", "get_data_parallel_world_size",
              "get_model_parallel_world_size", "get_stage_id",
              "get_p2p_groups", "get_data_parallel_group_src_rank"):
        assert getattr(ph, k)() == getattr(jh, k)(), k
    assert ph.get_pipe_parallel_group().ranks == \
        jh.get_pipe_parallel_group().ranks
    mesh = ph.get_mesh(devices=["cpu"] * 8)
    assert mesh.shape == dict(jh.get_mesh().shape)


# ---------------------------- the collectives -----------------------------

def _collectives(col, to, from_, x):
    """Each collective's output on `x` through one package."""
    out = {}
    for op in ("SUM", "MAX", "MIN", "PROD", "AVG"):
        t = to(np.abs(x) + 0.5 if op == "PROD" else x)
        col.all_reduce(t, getattr(col.ReduceOp, op))
        out[f"all_reduce_{op}"] = from_(t)
    t = to(x)
    col.broadcast(t, 1)
    out["broadcast"] = from_(t)
    got = []
    out["all_gather"] = from_(col.all_gather(got, to(x)))
    out["all_gather_list"] = np.stack([from_(g) for g in got])
    if x.shape[0] % 16 == 0:
        t = to(x)
        col.reduce_scatter(t)
        out["reduce_scatter"] = from_(t)
        t = to(x[:4])
        col.reduce_scatter(t, [to(x[:8]), to(x[8:])])
        out["reduce_scatter_list"] = from_(t)
    if x.ndim > 1 and x.shape[0] % 4 == 0:
        out["alltoall"] = from_(col.alltoall(to(x)))
    t = to(np.zeros_like(x[0]))
    col.scatter(t, [to(x[i % x.shape[0]]) for i in range(4)])
    out["scatter"] = from_(t)
    return out


@pytest.mark.parametrize("shape", [(16, 8), (3, 8)],
                         ids=["split", "replicated"])
def test_collectives_match_jax(shape, global_meshes):
    """The default group is the first axis of a {"data": 4, "model": 2}
    mesh: a dim 0 of 16 splits over its 4 ranks, a dim 0 of 3 is
    replicated on each."""
    jenv.set_global_mesh(jenv.build_mesh({"data": 4, "model": 2}))
    jcol._default_group = None
    penv.set_global_mesh(_cpu_mesh({"data": 4, "model": 2}))
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    want = _collectives(jcol, paddle.to_tensor, lambda t: np.asarray(
        t._data), x)
    got = _collectives(pcol, lambda a: torch.from_numpy(a.copy()),
                       lambda t: t.numpy(), x)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_point_to_point_mailbox(global_meshes):
    penv.set_global_mesh(_cpu_mesh({"data": 2}))
    a, b = torch.arange(4.0), torch.zeros(4)
    task = pcol.isend(a, dst=0)
    a.add_(1)                       # the post is a copy
    pcol.irecv(b, src=1).wait()
    assert task.is_completed() and torch.equal(b, torch.arange(4.0))
    c = torch.ones(2)
    pcol.batch_isend_irecv([pcol.P2POp(pcol.isend, torch.full((2,), 5.0), 0),
                            pcol.P2POp(pcol.irecv, c, 1)])
    assert torch.equal(c, torch.full((2,), 5.0))
    pcol.barrier()
    g = pcol.new_group([0, 1])
    assert pcol.get_group(g.id) is g and pcol.get_group(0).nranks == 2


# --------------------------- CompiledTrainStep ----------------------------

@pytest.mark.parametrize("dp,stage", [(4, 0), (4, 1), (4, 2), (4, 3),
                                      (8, 3)])
def test_adamw_matches_jax(dp, stage):
    """Stages 1 and 2 coincide in JAX, so stage 2 holds to its stage-1
    run."""
    want_l, want_p = _jax_run(dp, min(stage, 1) if stage < 3 else 3)
    got_l, got_p, _ = _port_run({"data": dp}, stage)
    np.testing.assert_allclose(got_l, want_l, rtol=TOLS[None]["loss"],
                               atol=0)
    _hold(got_p, want_p, TOLS[None], 2 * 2 * LR)


def test_lamb_trust_ratio_is_per_range_at_stage_1():
    """Under ZeRO the trust ratio spans each rank's flat range: the port
    holds to JAX's stage-1 Lamb, and its stage 0 (per parameter) takes
    another step."""
    want_l, want_p = _jax_run(4, 1, "lamb")
    got_l, got_p, _ = _port_run({"data": 4}, 1, "lamb")
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5, atol=0)
    _hold(got_p, want_p, TOLS[None], 2 * 2 * LR)
    _, per_param, _ = _port_run({"data": 4}, 0, "lamb")
    assert max(np.abs(per_param[n] - got_p[n]).max() for n in got_p) > 1e-4


def test_bf16_amp_stage_1_matches_jax():
    want_l, want_p = _jax_run(4, 1, amp="bf16")
    got_l, got_p, _ = _port_run({"data": 4}, 1, amp="bf16")
    np.testing.assert_allclose(got_l, want_l, rtol=TOLS["bf16"]["loss"],
                               atol=0)
    _hold(got_p, want_p, TOLS["bf16"], 2 * 2 * LR)


@functools.lru_cache(maxsize=None)
def _one_device_sgd():
    return _port_run(None, 0, "sgd")[:2]


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_sgd_every_stage_matches_the_one_device_step(stage):
    want_l, want_p = _one_device_sgd()
    got_l, got_p, _ = _port_run({"data": 4}, stage, "sgd")
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5, atol=0)
    _hold(got_p, want_p, TOLS[None], 1e-4)


def test_stage_3_stores_one_range_per_shard_and_round_trips():
    """Each shard keeps 1/dp of the padded flat parameters and of the
    optimizer state; `state_dict` rebuilds the full parameters, and a
    step built from them continues the run."""
    _, _, tr = _port_run({"data": 4}, 3)
    lay = tr.layout
    assert lay.padded % 1024 == 0 and lay.padded - lay.numel < 1024
    full = lay.numel * 4
    for own in tr.persistent_bytes():
        assert own["params"] == lay.shard_len * 4
        assert own["params"] * tr.dp == lay.padded * 4
        assert own["grads"] == 0
    stage0 = _port_run({"data": 4}, 0, steps=1)[2].persistent_bytes()[0]
    assert stage0["params"] == full and stage0["grads"] == full
    for own in tr.persistent_bytes():
        # the moments of a range, and the two beta powers
        assert own["optimizer"] == 2 * lay.shard_len * 4 + 2 * 4
        assert stage0["optimizer"] == 2 * full + 2 * 4 * len(tr.params)
    sd = tr.state_dict()
    ids, lbl = (torch.from_numpy(x) for x in _batch())
    nxt = float(tr.step(ids, lbl))
    model = GPTForPretraining(GPTConfig(**CFG), seed=3, device="cpu")
    model.load_state_dict(sd)
    tr2 = CompiledTrainStep(model, _loss_fn, AdamW(LR, weight_decay=WD),
                            _cpu_mesh({"data": 4}), zero_stage=3)
    assert float(tr2.loss(ids, lbl).detach()) == pytest.approx(nxt,
                                                                rel=1e-6)


def test_shared_storage_equals_separate_copies_bitwise():
    """dp 4 on one device shares one parameter tensor per device: each
    shard's gradients still stay its own.  Four separate models, one per
    shard, each differentiated on its slice and meaned in shard order,
    give the same SGD step bitwise."""
    ids, lbl = (torch.from_numpy(x) for x in _batch())
    _, got, tr = _port_run({"data": 4}, 0, "sgd", steps=1)
    leaves = tr._leaves[0][torch.device("cpu")]
    assert all(leaves[n] is p for n, p in tr.params.items())
    grads = []
    for i, (ci, cl) in enumerate(zip(ids.chunk(4), lbl.chunk(4))):
        m = GPTForPretraining.from_numpy_params(_named(), GPTConfig(**CFG),
                                                device="cpu")
        m.loss(ci, cl).backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
    for n, w in _named().items():
        g = grads[0][n]
        for k in range(1, 4):
            g = g + grads[k][n]
        want = torch.from_numpy(w) - 0.1 * (g / 4)
        assert torch.equal(torch.from_numpy(got[n]), want), n


def test_scheduler_steps_after_the_update():
    """SGD moves w by exactly lr * mean grad: each step at the rate of
    the scheduler's epoch before it; the batch of 4 rows splits over
    dp 2 at stage 1."""
    class Scale(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.tensor([1.0, -2.0, 3.0]))

    sched = plr.MultiStepDecay(0.5, milestones=[1, 2], gamma=0.1)
    model = Scale()
    tr = CompiledTrainStep(model, lambda m, x, generator: (m.w * x).sum(1)
                           .mean(), SGD(learning_rate=sched),
                           _cpu_mesh({"data": 2}), zero_stage=1)
    x = torch.tensor([[1.0, 2.0, 4.0], [3.0, 0.0, 1.0]] * 2)
    for k, rate in enumerate([0.5, 0.05, 0.005]):
        before = tr.full_params()["w"].clone()
        tr.step(x)
        # one float32 rounding of |w| < 4 apart
        torch.testing.assert_close(before - tr.full_params()["w"],
                                   rate * x.mean(0), rtol=0, atol=1e-6)
        assert sched.last_epoch == k + 1


@functools.lru_cache(maxsize=None)
def _jax_axis_run(mesh, stage, experts):
    """Two JAX AdamW steps of the global batch on `mesh` (a tuple of
    items), GPT with `experts` experts."""
    paddle.seed(7)
    cfg = JaxConfig(**CFG)
    cfg.num_experts = experts
    model = JaxGPT(cfg)
    named = {n: np.array(p._data) for n, p in model.named_parameters()}
    tr = JaxStep(model, lambda m, i, l: m.loss(i, l),
                 _jax_opt("adamw", model.parameters()),
                 jenv.build_mesh(dict(mesh)), zero_stage=stage)
    ids, lbl = _batch()
    losses = [float(np.asarray(tr.step(ids, lbl)._data)) for _ in range(2)]
    tr.sync_to_model()
    return named, losses, {n: np.array(p._data)
                           for n, p in model.named_parameters()}


@pytest.mark.parametrize("mesh,stage,experts", [
    ((("data", 2), ("model", 2)), 1, 0),
    ((("data", 2), ("seq", 2)), 2, 0),
    ((("data", 2), ("expert", 2)), 3, 2)],
    ids=["model", "seq", "expert"])
def test_model_seq_and_expert_axes_match_jax(mesh, stage, experts):
    """Each axis beside ``data`` trains and holds to the JAX step: the
    heads split over ``model``, the positions over ``seq`` (ring), 2
    experts over ``expert``; the full parameters rebuilt from the
    shards."""
    named, want_l, want_p = _jax_axis_run(mesh, stage, experts)
    model = GPTForPretraining.from_numpy_params(
        named, GPTConfig(**CFG, num_experts=experts), device="cpu")
    tr = CompiledTrainStep(model, _loss_fn, _port_opt("adamw"),
                           _cpu_mesh(dict(mesh)), zero_stage=stage)
    ids, lbl = (torch.from_numpy(x) for x in _batch())
    got_l = [float(tr.step(ids, lbl)) for _ in range(2)]
    tr.sync_to_model()
    np.testing.assert_allclose(got_l, want_l, rtol=TOLS[None]["loss"],
                               atol=0)
    _hold(model.numpy_params(), want_p, TOLS[None], 2 * 2 * LR)


def test_remat_equals_plain_bitwise_at_dropout():
    """remat=True recomputes each block in the backward from the dropout
    masks of its forward: at dropout 0.1 the losses and parameters equal
    the plain step's bitwise, over two steps (the generators resume where
    the forward left them)."""
    cfg = GPTConfig(**dict(CFG, dropout=0.1))
    ids, lbl = (torch.from_numpy(x) for x in _batch())
    runs = []
    for remat in (False, True):
        model = GPTForPretraining.from_numpy_params(_named(), cfg,
                                                    device="cpu")
        tr = CompiledTrainStep(model, _loss_fn, AdamW(LR),
                               _cpu_mesh({"data": 2}), zero_stage=1,
                               remat=remat, seed=5)
        runs.append(([float(tr.step(ids, lbl)) for _ in range(2)],
                     model.numpy_params()))
    assert runs[0][0] == runs[1][0]
    for n in runs[0][1]:
        np.testing.assert_array_equal(runs[0][1][n], runs[1][1][n])


def test_cost_analysis_counts_a_shard():
    _, _, tr = _port_run({"data": 4}, 1, steps=1)
    ids, lbl = (torch.from_numpy(x) for x in _batch())
    flops = tr.cost_analysis(ids, lbl)["flops"]
    # the tied head's matmul forward and its two backward products, at
    # one shard's 2 x 16 rows, are part of it
    assert flops > 3 * 2 * (B // 4) * L * 64 * 512
    assert tr.memory_analysis(ids, lbl) is None


# --------------------------- BERT and DataParallel ------------------------

def test_bert_dp2_stage_1_matches_jax():
    """The step is generic: BERT (bert_tiny's widths) under {"data": 2},
    AdamW, ZeRO 1, the batch of 4 split 2 + 2."""
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 1024, (4, 32)).astype(np.int32)
    mlm = rng.integers(0, 1024, (4, 32)).astype(np.int32)
    mlm[:, ::5] = -100
    nsp = np.array([0, 1, 1, 0], np.int32)
    types = (np.arange(32) >= 16).astype(np.int32)[None].repeat(4, 0)
    paddle.seed(7)
    jm = JaxBert(jax_bert_tiny())
    named = {n: np.array(p._data) for n, p in jm.named_parameters()}
    jtr = JaxStep(jm, lambda m, *b: m.loss(*b), paddle.optimizer.AdamW(
        learning_rate=LR, weight_decay=WD, parameters=jm.parameters()),
        jenv.build_mesh({"data": 2}), zero_stage=1)
    want = [float(np.asarray(jtr.step(ids, mlm, nsp, types)._data))
            for _ in range(2)]
    jtr.sync_to_model()
    pm = BertForPretraining.from_numpy_params(named, BertConfig(
        vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
        ffn_hidden=128, max_seq_len=128, dropout=0.0), device="cpu")
    tr = CompiledTrainStep(pm, lambda m, *b, generator: m.loss(
        *b, generator=generator), AdamW(LR, weight_decay=WD),
        _cpu_mesh({"data": 2}), zero_stage=1)
    batch = [torch.from_numpy(a) for a in (ids, mlm, nsp, types)]
    got = [float(tr.step(*batch)) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    tr.sync_to_model()
    final = {n: np.asarray(q._data) for n, q in jm.named_parameters()}
    far, total = 0, 0
    for n, p in pm.named_parameters():
        diff = np.abs(p.detach().numpy() - final[n])
        assert diff.max() <= 2 * 2 * LR, n
        live = diff[~np.full(diff.shape, n.endswith("k_proj.bias"))]
        far += int((live > 1e-5).sum())
        total += live.size
    assert far <= total * 1e-4, (far, total)


def test_data_parallel_passes_through(global_meshes):
    penv.set_global_mesh(_cpu_mesh({"data": 4}))
    model = GPTForPretraining(GPTConfig(**CFG), device="cpu")
    dp = DataParallel(model)
    ids, lbl = (torch.from_numpy(x) for x in _batch(2))
    assert dp.nranks == 4
    torch.testing.assert_close(dp(ids.long()), model(ids.long()), rtol=0,
                               atol=0)
    loss = model.loss(ids, lbl)
    assert dp.scale_loss(loss) is loss
    dp.apply_collective_grads()
    with dp.no_sync():
        assert not dp._grad_sync_enabled
    assert dp._grad_sync_enabled
    assert [n for n, _ in dp.named_parameters()] == [
        n for n, _ in model.named_parameters()]
    assert dp.state_dict().keys() == model.state_dict().keys()
    dp.set_state_dict(model.state_dict())
    assert dp.eval() is dp and not model.training
