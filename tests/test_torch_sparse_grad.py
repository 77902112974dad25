"""Port parity: sparse embedding gradients and the eager step's lazy
row update, against the JAX package's eager path (its tape's
``IndexedSlices`` and ``Optimizer._sparse_step``: under ``jit`` JAX makes
the gradient dense), both on the CPU.

``Embedding(sparse=True)`` gives a sparse COO weight gradient of one row
per lookup in lookup order (padding lookups as zero rows), equal to JAX's
indices and rows and, densified, to the dense path's gradient within
1e-6.  Two optimizer steps touch some rows only in the first, so the
lazy rule shows: SGD, Momentum, Adam, AdamW and Adagrad, with coupled and
decoupled decay, ``apply_decay_param_fun`` and a parameter's own
learning rate, hold every parameter entry within 1e-6 of JAX's, and the
rows no step touched stay bitwise as they were.  A gradient clip and
Lamb take the dense update as JAX does; ``GradScaler``, `grad`, the
selected-rows functions and the compiled and static paths behave as
JAX's.  The JAX golden tests of ``tests/test_sparse_grad.py`` have
counterparts here."""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.core.indexed_slices import IndexedSlices
import paddle_tpu_torch as ptorch
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.models import layer_from_numpy

TOL = 1e-6
V, D = 40, 6
IDS = (np.array([[1, 2], [3, 1]]), np.array([[2, 5], [5, 7]]))
W0 = np.random.default_rng(0).standard_normal((V, D)).astype(np.float32)


def _jax_emb(sparse=True, padding_idx=None, attr=None, w=W0):
    emb = jnn.Embedding(w.shape[0], w.shape[1], padding_idx=padding_idx,
                        sparse=sparse, weight_attr=attr)
    emb.weight._data = paddle.to_tensor(w)._data
    return emb


def _port_emb(sparse=True, padding_idx=None, attr=None, w=W0):
    emb = pnn.Embedding(w.shape[0], w.shape[1], padding_idx=padding_idx,
                        sparse=sparse, weight_attr=attr,
                        generator=torch.Generator())
    return layer_from_numpy(emb, {"weight": w}, device="cpu")


def _jax_loss(emb, ids):
    out = emb(paddle.to_tensor(ids))
    return paddle.mean(out * out)


def _port_loss(emb, ids):
    out = emb(torch.from_numpy(ids))
    return (out * out).mean()


def _w(emb):
    return np.asarray(emb.weight._data) if hasattr(emb.weight, "_data") \
        else emb.weight.detach().numpy()


def test_sparse_grad_is_one_row_per_lookup():
    """The COO gradient's ids and rows are JAX's IndexedSlices', in lookup
    order, before any merge; densified it is the dense path's gradient
    (and JAX's)."""
    jemb, pemb = _jax_emb(), _port_emb()
    _jax_loss(jemb, IDS[0]).backward()
    _port_loss(pemb, IDS[0]).backward()
    jg, g = jemb.weight.grad, pemb.weight.grad
    assert isinstance(jg, IndexedSlices) and g.is_sparse
    assert not g.is_coalesced() and tuple(g.shape) == (V, D)
    np.testing.assert_array_equal(g._indices()[0].numpy(),
                                  np.asarray(jg.indices))
    np.testing.assert_allclose(g._values().numpy(), np.asarray(jg.values),
                               rtol=TOL, atol=TOL)
    dense = _port_emb(sparse=False)
    _port_loss(dense, IDS[0]).backward()
    np.testing.assert_allclose(g.to_dense().numpy(), dense.weight.grad.numpy(),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(g.to_dense().numpy(), jg.numpy(), rtol=TOL,
                               atol=TOL)


def test_padding_lookups_stay_as_zero_rows():
    """A padding id's lookups stay in the gradient as rows of zeros
    (PyTorch's own sparse embedding drops them); the row gets nothing."""
    ids = np.array([[0, 3], [0, 5]])
    jemb, pemb = _jax_emb(padding_idx=0), _port_emb(padding_idx=0)
    _jax_loss(jemb, ids).backward()
    _port_loss(pemb, ids).backward()
    g, jg = pemb.weight.grad, jemb.weight.grad
    np.testing.assert_array_equal(g._indices()[0].numpy(), [0, 3, 0, 5])
    np.testing.assert_array_equal(np.asarray(jg.indices), [0, 3, 0, 5])
    assert not g._values()[[0, 2]].any()
    np.testing.assert_allclose(g._values().numpy(), np.asarray(jg.values),
                               rtol=TOL, atol=TOL)
    dense = g.to_dense().numpy()
    assert not dense[0].any() and np.abs(dense[[3, 5]]).sum() > 0


def test_duplicate_ids_merge_as_jax_coalesces():
    """Duplicates sum (sorted ids) in `coalesce`, `merge_selected_rows`
    and `get_tensor_from_selected_rows`, as JAX's."""
    from paddle_tpu.ops import framework_ops as JF
    from paddle_tpu_torch.core.indexed_slices import coalesce

    ids = np.array([7, 2, 7, 7])
    jemb, pemb = _jax_emb(), _port_emb()
    _jax_loss(jemb, ids).backward()
    _port_loss(pemb, ids).backward()
    uniq, rows = coalesce(pemb.weight.grad)
    juniq, jrows = jemb.weight.grad.coalesce()
    np.testing.assert_array_equal(uniq.numpy(), np.asarray(juniq))
    np.testing.assert_allclose(rows.numpy(), np.asarray(jrows), rtol=TOL,
                               atol=TOL)
    merged = ptorch.merge_selected_rows(pemb.weight.grad)
    jmerged = JF.merge_selected_rows(jemb.weight.grad)
    assert merged.is_coalesced()
    np.testing.assert_array_equal(merged.indices()[0].numpy(),
                                  np.asarray(jmerged.indices))
    np.testing.assert_allclose(
        ptorch.get_tensor_from_selected_rows(pemb.weight.grad).numpy(),
        np.asarray(JF.get_tensor_from_selected_rows(jemb.weight.grad)._data),
        rtol=TOL, atol=TOL)
    with pytest.raises(TypeError):
        ptorch.merge_selected_rows(torch.zeros(2))


def test_accumulation_concatenates_or_densifies():
    """Two sparse backward passes leave a sparse gradient of both passes'
    rows, as ``IndexedSlices.__add__`` concatenates them (torch's sparse
    add walks the two id lists in step and sums a pair of equal ids it
    meets: here 7 rows where JAX keeps 8, the same sum); a dense pass on
    top makes the gradient dense; the values equal JAX's."""
    jemb, pemb = _jax_emb(), _port_emb()
    for ids in IDS:
        _jax_loss(jemb, ids).backward()
        _port_loss(pemb, ids).backward()
    g = pemb.weight.grad
    assert g.is_sparse and not g.is_coalesced()
    assert g._values().shape == (7, D)
    assert np.asarray(jemb.weight.grad.indices).shape == (8,)
    assert isinstance(jemb.weight.grad, IndexedSlices)
    np.testing.assert_allclose(g.to_dense().numpy(), jemb.weight.grad.numpy(),
                               rtol=TOL, atol=TOL)
    paddle.sum(jemb.weight * jemb.weight).backward()
    (pemb.weight * pemb.weight).sum().backward()
    assert not pemb.weight.grad.is_sparse
    np.testing.assert_allclose(pemb.weight.grad.numpy(),
                               np.asarray(jemb.weight.grad._data), rtol=TOL,
                               atol=TOL)


RULES = {
    "SGD": ("SGD", {}, None),
    "Momentum": ("Momentum", {"momentum": 0.9}, None),
    "Momentum_L2": ("Momentum", {"momentum": 0.9, "weight_decay": 0.05},
                    None),
    "Adam": ("Adam", {}, None),
    "Adam_L2Decay": ("Adam", {"weight_decay": "L2Decay"}, None),
    "AdamW": ("AdamW", {"weight_decay": 0.01}, None),
    "AdamW_no_decay_fun": ("AdamW", {"weight_decay": 0.5,
                                     "apply_decay_param_fun": "no"}, None),
    "Adagrad": ("Adagrad", {}, None),
    "Adam_param_lr": ("Adam", {}, 0.5),
}


def _opt(pkg, cls, kw, params):
    kw = dict(kw)
    if kw.get("weight_decay") == "L2Decay":
        kw["weight_decay"] = (paddle.regularizer.L2Decay(0.1)
                              if pkg is paddle else popt.L2Decay(0.1))
    if kw.get("apply_decay_param_fun") == "no":
        kw["apply_decay_param_fun"] = lambda name: name != "emb_w"
    return getattr(pkg.optimizer if pkg is paddle else popt, cls)(
        learning_rate=0.1, parameters=params, **kw)


def _two_steps(pkg, rule, sparse=True):
    cls, kw, lr = RULES[rule]
    attr = (paddle.ParamAttr if pkg is paddle else pnn.ParamAttr)(
        name="emb_w", learning_rate=lr or 1.0)
    emb = (_jax_emb if pkg is paddle else _port_emb)(sparse=sparse,
                                                     attr=attr)
    opt = _opt(pkg, cls, kw, emb.parameters())
    loss = _jax_loss if pkg is paddle else _port_loss
    for ids in IDS:
        loss(emb, ids).backward()
        opt.step()
        opt.clear_grad()
    return _w(emb)


@pytest.mark.parametrize("rule", list(RULES))
def test_lazy_step_matches_jax_eager(rule):
    """Two steps; rows 1 and 3 only in the first, 5 and 7 only in the
    second.  Every entry within 1e-6 of JAX's eager sparse path, the
    rows no step touched bitwise the start."""
    got, want = _two_steps(ptorch, rule), _two_steps(paddle, rule)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    untouched = [i for i in range(V) if i not in (1, 2, 3, 5, 7)]
    np.testing.assert_array_equal(got[untouched], W0[untouched])
    assert not np.array_equal(got[[1, 2, 3, 5, 7]], W0[[1, 2, 3, 5, 7]])


@pytest.mark.parametrize("rule", ["SGD", "Momentum", "Adam", "AdamW"])
def test_sparse_step_matches_dense_on_touched_rows(rule):
    """One step: the sparse update equals the dense one on the touched
    rows, and the untouched rows do not move (JAX's golden test)."""
    def one(sparse):
        cls, kw, _ = RULES[rule]
        emb = _port_emb(sparse=sparse)
        opt = _opt(ptorch, cls, kw, emb.parameters())
        _port_loss(emb, IDS[0]).backward()
        opt.step()
        return _w(emb)

    ws, wd = one(True), one(False)
    touched = [1, 2, 3]
    np.testing.assert_allclose(ws[touched], wd[touched], rtol=2e-5,
                               atol=1e-6)
    untouched = [i for i in range(V) if i not in touched]
    np.testing.assert_array_equal(ws[untouched], W0[untouched])


def test_lazy_rule_differs_from_the_dense_one():
    """Adam's dense rule moves row 1 at step 2 (its moment is not zero);
    the lazy rule leaves it where step 1 put it."""
    lazy, dense = _two_steps(ptorch, "Adam"), _two_steps(ptorch, "Adam",
                                                         sparse=False)
    assert not np.array_equal(lazy[1], dense[1])
    np.testing.assert_allclose(lazy[[2, 5, 7]], dense[[2, 5, 7]], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("clip", ["ClipGradByGlobalNorm", "ClipGradByNorm",
                                  "ClipGradByValue"])
def test_grad_clip_densifies_sparse_gradients(clip):
    """With a clip the sparse gradient takes the dense update (JAX's
    trade-off): two Adam steps as JAX's, where row 1 moves again at step
    2."""
    def run(pkg):
        emb = (_jax_emb if pkg is paddle else _port_emb)()
        nn_ = jnn if pkg is paddle else pnn
        opt = (paddle.optimizer if pkg is paddle else popt).Adam(
            learning_rate=0.1, parameters=emb.parameters(),
            grad_clip=getattr(nn_, clip)(0.01))
        loss = _jax_loss if pkg is paddle else _port_loss
        for ids in IDS:
            loss(emb, ids).backward()
            opt.step()
            opt.clear_grad()
        return _w(emb)

    np.testing.assert_allclose(run(ptorch), run(paddle), rtol=TOL, atol=TOL)
    pairs = getattr(pnn, clip)(0.01)([(None, torch.ones(4, 2).to_sparse())])
    assert not pairs[0][1].is_sparse


def test_lamb_takes_the_dense_update():
    """Lamb's trust ratio needs the whole parameter: a sparse gradient
    takes its dense update, as JAX's ``_sparse_safe = False``."""
    def run(pkg):
        emb = (_jax_emb if pkg is paddle else _port_emb)()
        opt = (paddle.optimizer if pkg is paddle else popt).Lamb(
            learning_rate=0.1, parameters=emb.parameters())
        loss = _jax_loss if pkg is paddle else _port_loss
        loss(emb, IDS[0]).backward()
        opt.step()
        return _w(emb)

    got = run(ptorch)
    np.testing.assert_allclose(got, run(paddle), rtol=TOL, atol=TOL)
    assert not popt.Lamb.sparse_safe
    assert not np.array_equal(got[0], W0[0])     # the decay moved every row


def test_grad_scaler_unscales_sparse():
    """``GradScaler`` unscales a sparse gradient's rows and keeps it
    sparse; the step equals a run without a scaler (JAX's golden test);
    a non-finite row skips the step."""
    from paddle_tpu_torch import amp

    emb = _port_emb()
    opt = popt.SGD(learning_rate=0.1, parameters=emb.parameters())
    scaler = amp.GradScaler(init_loss_scaling=64.0)
    scaler.scale(_port_loss(emb, IDS[0][:1])).backward()
    assert emb.weight.grad.is_sparse
    scaler.step(opt)
    plain = _port_emb()
    popt_ = popt.SGD(learning_rate=0.1, parameters=plain.parameters())
    _port_loss(plain, IDS[0][:1]).backward()
    popt_.step()
    np.testing.assert_allclose(_w(emb), _w(plain), rtol=1e-6)
    assert not np.allclose(W0[[1, 2]], _w(emb)[[1, 2]])
    before = _w(emb).copy()
    opt.clear_grad()
    emb.weight.grad = torch.sparse_coo_tensor(
        torch.tensor([[4]]), torch.full((1, D), float("inf")), (V, D),
        check_invariants=False)
    scaler.step(opt)
    assert scaler._scale == 32.0
    np.testing.assert_array_equal(_w(emb), before)


def test_paddle_grad_densifies_sparse():
    """`grad` returns the dense gradient of a sparse embedding's weight,
    equal to JAX's."""
    from paddle_tpu.core import autograd as jautograd

    jemb, pemb = _jax_emb(), _port_emb()
    (jg,) = jautograd.grad([_jax_loss(jemb, IDS[0])], [jemb.weight])
    (g,) = ptorch.grad([_port_loss(pemb, IDS[0])], [pemb.weight])
    assert not g.is_sparse and g.shape == (V, D)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg._data), rtol=TOL,
                               atol=TOL)


def test_adamw_decay_param_fun_respected_for_sparse():
    """``apply_decay_param_fun`` gates the decay of a sparse step's
    rows."""
    def run(decay):
        emb = _port_emb(attr=pnn.ParamAttr(name="emb_w"))
        opt = popt.AdamW(learning_rate=0.1, weight_decay=0.5,
                         parameters=emb.parameters(),
                         apply_decay_param_fun=lambda n: decay)
        _port_loss(emb, IDS[0]).backward()
        opt.step()
        return _w(emb)

    assert not np.allclose(run(True)[[1, 2]], run(False)[[1, 2]])


def test_sparse_training_converges():
    emb = _port_emb(w=np.random.default_rng(1).standard_normal(
        (1000, 16)).astype(np.float32))
    opt = popt.Adam(learning_rate=0.05, parameters=emb.parameters())
    ids = np.arange(32).reshape(4, 8)
    l0 = _port_loss(emb, ids).item()
    for _ in range(10):
        _port_loss(emb, ids).backward()
        opt.step()
        opt.clear_grad()
    assert _port_loss(emb, ids).item() < 0.5 * l0


def test_large_vocab_grad_stays_sparse():
    """A 400,000 x 128 table (205 MB; the card test holds JAX's 2,000,000
    x 128): the gradient holds the 8 x 16 looked-up rows, never the
    vocabulary's, and the step moves them."""
    emb = pnn.Embedding(400_000, 128, sparse=True,
                        generator=torch.Generator().manual_seed(0))
    opt = popt.SGD(learning_rate=0.1, parameters=emb.parameters())
    ids = np.random.RandomState(0).randint(0, 400_000, (8, 16))
    _port_loss(emb, ids).backward()
    assert emb.weight.grad.is_sparse
    assert emb.weight.grad._values().shape == (128, 128)
    before = emb.weight[ids[0, 0]].detach().clone()
    opt.step()
    assert not torch.allclose(before, emb.weight[ids[0, 0]])


def test_compiled_and_static_paths_keep_gradients_dense():
    """JAX's gradient is dense under tracing: the port's compiled step
    densifies a sparse embedding's (one step equals a dense model's
    step), and the static ``lookup_table_v2`` gives a dense W@GRAD."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.parallel import TrainStep

    class Bag(torch.nn.Module):
        def __init__(self, sparse):
            super().__init__()
            self.emb = _port_emb(sparse=sparse)

        def forward(self, ids):
            return self.emb(ids)

    outs = []
    for sparse in (True, False):
        model = Bag(sparse)
        step = TrainStep(model, lambda m, ids, generator: (m(ids) ** 2).mean(),
                         popt.Adam(0.1), device="cpu")
        step.step(torch.from_numpy(IDS[0]))
        step.sync_to_model()
        outs.append(_w(model.emb))
    np.testing.assert_array_equal(outs[0], outs[1])
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        ids = static.data("ids", [2, 2], "int64")
        out = static.nn.embedding(ids, [V, D])
        grads = static.append_backward(static.nn.mean(out))
    exe = static.Executor("cpu")
    scope = static.Scope()
    exe.run(startup, scope=scope)
    g, = exe.run(main, feed={"ids": IDS[0]}, fetch_list=[grads[0][1]],
                 scope=scope)
    assert np.asarray(g).shape == (V, D)
