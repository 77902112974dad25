"""Port parity: the high-level surface (``paddle_tpu_torch.hapi``,
``metric``, ``callbacks``, ``framework.save``/``load``).

`Model.fit` / `evaluate` / `predict` on TinyNet and on LeNet over a
``TensorDataset``, against the JAX ``Model`` from the same weights and
numpy seed (so the same shuffled order): every step's fp32 loss within
`LOSS_RTOL` relative, the metrics equal, the callbacks' events in the
same order, EarlyStopping, LRScheduler, ReduceLROnPlateau and the JSONL
logger doing the same.  `summary` (the table and the totals) and
`flops` (LeNet, TinyNet, a custom counter; `static_flops` on a small
static ResNet) equal the JAX package's.  A JAX ``Model.save``
checkpoint loads into the port's `Model.load`, evaluates alike and
trains on from the same optimizer state; a port checkpoint loads into
the JAX model.  The metrics one by one equal JAX's, and the loss layers
(`CrossEntropyLoss` over each option, `MSELoss`) JAX's at 1e-6."""
import json

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as conftest sets)
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import chip_smoke
import paddle_tpu as paddle
import paddle_tpu.callbacks as jcb
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.static as jstatic
from paddle_tpu.io import TensorDataset as JaxTensorDataset
from paddle_tpu.vision.models import LeNet as JaxLeNet
from paddle_tpu_torch import callbacks as pcb
from paddle_tpu_torch import hapi, metric
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch import static as pstatic
from paddle_tpu_torch.framework import load as pload
from paddle_tpu_torch.framework import save as psave
from paddle_tpu_torch.io import DataLoader, TensorDataset
from paddle_tpu_torch.models import layer_from_numpy
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.vision.models import LeNet

LOSS_RTOL = 1e-5


class JaxTiny(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(4, 8)
        self.fc2 = jnn.Linear(8, 3)

    def forward(self, x):
        return self.fc2(JF.relu(self.fc1(x)))


class PortTiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.fc1 = pnn.Linear(4, 8, generator=g)
        self.fc2 = pnn.Linear(8, 3, generator=g)

    def forward(self, x):
        return self.fc2(PF.relu(self.fc1(x)))


def _nets(kind, seed=0):
    """(JAX network, the port's with its weights) of `kind`."""
    paddle.seed(seed)
    jnet = JaxTiny() if kind == "tiny" else JaxLeNet()
    state = {n: np.asarray(t._data) for n, t in jnet.state_dict().items()}
    pnet = PortTiny() if kind == "tiny" else LeNet(device="cpu")
    return jnet, layer_from_numpy(pnet, state, device="cpu")


def _data(kind, n=48):
    rng = np.random.default_rng(1)
    if kind == "tiny":
        x = rng.standard_normal((n, 4)).astype(np.float32)
        y = (x @ rng.standard_normal((4, 3))).argmax(1)[:, None]
    else:
        x = rng.random((n, 1, 28, 28)).astype(np.float32)
        y = rng.integers(0, 10, (n, 1))
    return x, y.astype(np.int64)


def recorder(base):
    """A callback over `base` (either package's ``Callback``) that
    records every event with its argument, and each batch's logs."""
    class Recorder(base):
        def __init__(self):
            super().__init__()
            self.events, self.batch_logs = [], []

        def _on(name):
            def on(self, *args):
                self.events.append((name,) + tuple(
                    a for a in args if isinstance(a, int)))
                if name == "on_train_batch_end":
                    self.batch_logs.append(dict(args[1]))
            return on

        for _name in ("on_train_begin", "on_train_end", "on_epoch_begin",
                      "on_epoch_end", "on_train_batch_begin",
                      "on_train_batch_end"):
            locals()[_name] = _on(_name)
        del _name

    return Recorder()


def _fit(pkg, net, kind, callbacks=(), epochs=2, lr=0.01, **fit_kw):
    """Model.fit + evaluate + predict in `pkg` ("jax" or "port")."""
    x, y = _data(kind)
    if pkg == "jax":
        model = paddle.Model(net)
        opt = paddle.optimizer.Adam(learning_rate=lr,
                                    parameters=net.parameters())
        model.prepare(opt, jnn.CrossEntropyLoss(),
                      paddle.metric.Accuracy(topk=(1, 2)))
        ds, inputs = JaxTensorDataset([x, y]), JaxTensorDataset([x])
    else:
        model = hapi.Model(net)
        opt = popt.Adam(learning_rate=lr, parameters=net.parameters())
        model.prepare(opt, pnn.CrossEntropyLoss(),
                      metric.Accuracy(topk=(1, 2)), amp_configs="O1")
        ds, inputs = TensorDataset([x, y]), TensorDataset([x])
    np.random.seed(3)
    model.fit(ds, eval_data=ds, epochs=epochs, batch_size=16,
              callbacks=list(callbacks), verbose=0, **fit_kw)
    logs = model.evaluate(ds, batch_size=16, verbose=0)
    preds = model.predict(inputs, batch_size=16, stack_outputs=True)
    return model, logs, preds


@pytest.mark.parametrize("kind", ["tiny", "lenet"])
def test_fit_evaluate_predict_match_jax(kind):
    jnet, pnet = _nets(kind)
    jrec, prec = recorder(jcb.Callback), recorder(pcb.Callback)
    _, jlogs, jpred = _fit("jax", jnet, kind, [jrec])
    _, plogs, ppred = _fit("port", pnet, kind, [prec])
    assert prec.events == jrec.events
    assert len(prec.batch_logs) == len(jrec.batch_logs) == 6
    for p, j in zip(prec.batch_logs, jrec.batch_logs):
        assert p.keys() == j.keys()
        np.testing.assert_allclose(p["loss"], j["loss"], rtol=LOSS_RTOL)
        assert (p["acc_top1"], p["acc_top2"]) == (j["acc_top1"],
                                                  j["acc_top2"])
    np.testing.assert_allclose(plogs.pop("loss"), jlogs.pop("loss"),
                               rtol=LOSS_RTOL)
    assert plogs == jlogs
    np.testing.assert_allclose(ppred[0], np.asarray(jpred[0]),
                               rtol=1e-4, atol=1e-5)


def test_callbacks_act_as_jax(tmp_path):
    """EarlyStopping stops at the same epoch, the LR schedule and the
    plateau's cut run alike, and the JSONL logs carry the same lines."""
    out = {}
    for pkg in ("jax", "port"):
        jnet, pnet = _nets("tiny", seed=4)
        cbm = jcb if pkg == "jax" else pcb
        lrm = paddle.optimizer.lr if pkg == "jax" else popt.lr
        sched = lrm.StepDecay(learning_rate=0.05, step_size=2, gamma=0.5)
        logger_cls = (paddle.hapi.callbacks.JSONLLogger if pkg == "jax"
                      else hapi.callbacks.JSONLLogger)
        path = tmp_path / f"{pkg}.jsonl"
        rec = recorder(cbm.Callback)
        cbs = [rec, cbm.LRScheduler(by_step=True),
               cbm.EarlyStopping(monitor="loss", patience=1,
                                 min_delta=10.0),
               cbm.ReduceLROnPlateau(monitor="loss", patience=0,
                                     factor=0.5, verbose=0),
               logger_cls(str(path)),
               cbm.ModelCheckpoint(save_dir=str(tmp_path / pkg))]
        model, logs, _ = _fit(pkg, jnet if pkg == "jax" else pnet, "tiny",
                              cbs, epochs=5, lr=sched)
        lines = [json.loads(s) for s in path.read_text().splitlines()]
        out[pkg] = (rec.events, sched.last_epoch, sched.base_lr,
                    sched.last_lr, lines, logs,
                    sorted(p.name for p in (tmp_path / pkg).iterdir()))
    (pe, pep, pb, plr, plines, plogs, pfiles), \
        (je, jep, jb, jlr, jlines, jlogs, jfiles) = out["port"], out["jax"]
    assert pe == je and ("on_epoch_end", 2) not in pe    # stopped after 2
    assert (pep, pb, plr) == (jep, jb, jlr)
    assert pfiles == jfiles == ["0.pdopt", "0.pdparams", "1.pdopt",
                                "1.pdparams", "final.pdopt",
                                "final.pdparams"]
    assert [sorted(x) for x in plines] == [sorted(x) for x in jlines]
    for p, j in zip(plines, jlines):
        np.testing.assert_allclose(p["loss"], j["loss"], rtol=LOSS_RTOL)


def test_jax_checkpoint_loads_into_port_and_back(tmp_path):
    jnet, pnet = _nets("lenet", seed=6)
    jmodel, jlogs, _ = _fit("jax", jnet, "lenet", epochs=1)
    jmodel.save(str(tmp_path / "jax"))
    _, fresh = _nets("lenet", seed=7)
    pmodel = hapi.Model(fresh)
    pmodel.prepare(popt.Adam(learning_rate=0.01,
                             parameters=fresh.parameters()),
                   pnn.CrossEntropyLoss(), metric.Accuracy(topk=(1, 2)))
    pmodel.load(str(tmp_path / "jax"))
    x, y = _data("lenet")
    plogs = pmodel.evaluate(TensorDataset([x, y]), batch_size=16)
    np.testing.assert_allclose(plogs.pop("loss"), jlogs.pop("loss"),
                               rtol=LOSS_RTOL)
    assert plogs == jlogs
    # the optimizer state came too: one more step alike
    jl, _ = jmodel.train_batch([paddle.to_tensor(x[:16])],
                               [paddle.to_tensor(y[:16])])
    pl, _ = pmodel.train_batch([x[:16]], [y[:16]])
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    assert pmodel._optimizer._global_step == jmodel._optimizer._global_step
    pmodel.save(str(tmp_path / "port"))
    back = paddle.Model(JaxLeNet())
    back.prepare(loss=jnn.CrossEntropyLoss())
    back.load(str(tmp_path / "port"))
    xs = paddle.to_tensor(x[:8])
    np.testing.assert_allclose(np.asarray(back.network(xs)._data),
                               pmodel.predict_batch([x[:8]])[0],
                               rtol=1e-4, atol=1e-5)
    with pytest.raises(NotImplementedError, match="jit.save"):
        pmodel.save(str(tmp_path / "inference"), training=False)


def test_save_load_round_trip_and_formats(tmp_path):
    state = {"w": torch.arange(6.0).reshape(2, 3),
             "half": torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
             "ids": torch.tensor([3, 1], dtype=torch.int32),
             "pow": torch.tensor(0.81),
             "nested": [torch.ones(2), {"step": 7}], "lr": 0.1}
    psave(state, str(tmp_path / "a" / "s.pdparams"))
    back = pload(str(tmp_path / "a" / "s.pdparams"), device="cpu")
    for k in ("w", "half", "ids", "pow"):
        assert back[k].dtype == state[k].dtype
        assert back[k].shape == state[k].shape
        assert torch.equal(back[k], state[k])
    assert torch.equal(back["nested"][0], torch.ones(2))
    assert back["nested"][1] == {"step": 7} and back["lr"] == 0.1
    jax_state = paddle.load(str(tmp_path / "a" / "s.pdparams"))
    np.testing.assert_array_equal(np.asarray(jax_state["w"]._data),
                                  state["w"].numpy())
    assert str(jax_state["half"]._data.dtype) == "bfloat16"
    paddle.save({"t": paddle.to_tensor(np.eye(2, dtype=np.float32))},
                str(tmp_path / "j.pdparams"))
    assert torch.equal(pload(str(tmp_path / "j.pdparams"),
                             device="cpu")["t"], torch.eye(2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs CUDA"):
            pload(str(tmp_path / "j.pdparams"))


@pytest.mark.parametrize("kind", ["tiny", "lenet"])
def test_summary_and_flops_match_jax(kind, capsys):
    jnet, pnet = _nets(kind)
    size = (2, 4) if kind == "tiny" else (1, 1, 28, 28)
    jtext, jstats = paddle.hapi.model_summary.summary_string(jnet, size)
    ptext, pstats = hapi.summary_string(pnet, size)
    assert ptext == jtext and pstats == jstats
    assert hapi.summary(pnet) == paddle.summary(jnet)
    assert hapi.Model(pnet).summary() == paddle.Model(jnet).summary()
    assert hapi.flops(pnet, list(size)) == paddle.flops(jnet, list(size))
    jrelu = {jnn.ReLU: lambda m, i, o: 10 * int(np.prod(o.shape))}
    prelu = {pnn.ReLU: lambda m, i, o: 10 * int(np.prod(o.shape))}
    assert hapi.flops(pnet, list(size), custom_ops=prelu) == \
        paddle.flops(jnet, list(size), custom_ops=jrelu)


def test_static_flops_matches_jax():
    small = dict(depths=(1, 1, 1, 1), base=8, image=32, classes=10)
    paddle.seed(0)
    jm, *_ = chip_smoke.build_static_resnet(
        jstatic, paddle.optimizer.Momentum, 2, **small)
    pm, *_ = chip_smoke.build_static_resnet(pstatic, popt.Momentum, 2,
                                            **small)
    want = paddle.hapi.dynamic_flops.static_flops(jm)
    assert hapi.static_flops(pm) == want > 0


def _metric_inputs():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((40, 5)).astype(np.float32)
    labels = rng.integers(0, 5, (40, 1))
    scores = rng.random((40, 1)).astype(np.float32)
    binary = (rng.random((40, 1)) < scores).astype(np.int64)
    return logits, labels, scores, binary


METRICS = {
    "accuracy_top1_3": lambda m: m.Accuracy(topk=(1, 3)),
    "accuracy_top2": lambda m: m.Accuracy(topk=2),
    "precision": lambda m: m.Precision(),
    "recall": lambda m: m.Recall(),
    "auc": lambda m: m.Auc(),
    "auc_coarse": lambda m: m.Auc(num_thresholds=7),
}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_matches_jax(name):
    logits, labels, scores, binary = _metric_inputs()
    jm, pm = METRICS[name](paddle.metric), METRICS[name](metric)
    jseen, pseen = [], []
    for lo in range(0, 40, 16):
        sl = slice(lo, lo + 16)
        if name.startswith("accuracy"):
            jargs = jm.compute(paddle.to_tensor(logits[sl]),
                               paddle.to_tensor(labels[sl]))
            pargs = pm.compute(torch.from_numpy(logits[sl]),
                               torch.from_numpy(labels[sl]))
            assert pargs.dtype == torch.float32
            jseen.append(jm.update(jargs))
            pseen.append(pm.update(pargs))
        else:
            jm.update(paddle.to_tensor(scores[sl]),
                      paddle.to_tensor(binary[sl]))
            pm.update(torch.from_numpy(scores[sl]),
                      torch.from_numpy(binary[sl]))
    assert pseen == jseen
    assert pm.accumulate() == jm.accumulate()
    assert pm.name() == jm.name()
    pm.reset()
    jm.reset()
    assert pm.accumulate() == jm.accumulate()
    for k in (1, 2):
        assert metric.accuracy(torch.from_numpy(logits),
                               torch.from_numpy(labels), k=k).tolist() == \
            np.asarray(paddle.metric.accuracy(
                paddle.to_tensor(logits), paddle.to_tensor(labels),
                k=k)._data).tolist()


def test_model_inputs_follow_the_network_and_loaders_take_its_device():
    _, pnet = _nets("tiny")
    model = hapi.Model(pnet)
    assert model.device == torch.device("cpu")
    model.prepare(popt.SGD(learning_rate=0.1,
                           parameters=pnet.parameters()),
                  pnn.CrossEntropyLoss())
    x, y = _data("tiny", 8)
    loader = model._as_loader(TensorDataset([x, y]), 4, False, False, 0)
    assert isinstance(loader, DataLoader) and loader.device == model.device
    losses, _ = model.train_batch(x, y)
    assert np.isfinite(losses[0])
    bar = hapi.ProgressBar(num=4)
    bar.update(2, [("loss", 0.5)])


LOSS_CASES = {
    "mean": dict(),
    "weight_ignore": dict(weight=True, ignore_index=2),
    "sum": dict(reduction="sum"),
    "none_ignore": dict(reduction="none", ignore_index=1),
    "soft_label": dict(soft_label=True),
    "axis1": dict(axis=1),
    "probabilities": dict(use_softmax=False),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_layers_match_jax(case):
    """``CrossEntropyLoss`` over each option of ``F.cross_entropy``, and
    ``MSELoss``, against the JAX layers at 1e-6 (fp32)."""
    kw = dict(LOSS_CASES[case])
    rng = np.random.default_rng(4)
    if kw.get("axis") == 1:
        logits = rng.standard_normal((3, 5, 4)).astype(np.float32)
        labels = rng.integers(0, 5, (3, 1, 4))
    else:
        logits = rng.standard_normal((6, 5)).astype(np.float32)
        labels = rng.integers(0, 5, (6, 1))
    if kw.pop("soft_label", False):
        soft = rng.random((6, 5)).astype(np.float32)
        labels = soft / soft.sum(-1, keepdims=True)
        kw["soft_label"] = True
    if not kw.get("use_softmax", True):
        e = np.exp(logits)
        logits = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    jkw, pkw = dict(kw), dict(kw)
    if kw.pop("weight", False):
        w = rng.random(5).astype(np.float32) + 0.5
        jkw["weight"], pkw["weight"] = paddle.to_tensor(w), \
            torch.from_numpy(w)
    want = jnn.CrossEntropyLoss(**jkw)(paddle.to_tensor(logits),
                                       paddle.to_tensor(labels))
    got = pnn.CrossEntropyLoss(**pkw)(torch.from_numpy(logits),
                                      torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               rtol=1e-6, atol=1e-6)
    a, b = rng.standard_normal((2, 4, 3)).astype(np.float32)
    for red in ("mean", "sum", "none"):
        np.testing.assert_allclose(
            pnn.MSELoss(red)(torch.from_numpy(a), torch.from_numpy(b)),
            np.asarray(jnn.MSELoss(red)(paddle.to_tensor(a),
                                        paddle.to_tensor(b))._data),
            rtol=1e-6)
