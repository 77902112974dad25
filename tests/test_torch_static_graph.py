"""Port parity: the static graph (``paddle_tpu_torch.static``) against the
JAX package's ``paddle_tpu.static``, op by op.

Each op of the static ResNet-50 slice is built into a one-op program in
both packages, with ``loss = mean(y * w)`` over random cotangent weights
w (scaled by y's size, so gradients are O(1)), then `append_backward`
with the op's data inputs as extra targets.  Both executors run from one
scope (the JAX startup's parameters, overwritten with random values and
carried as numpy), and the forward output, every ``@GRAD`` var and every
scope var after the run are compared: fp32 within atol = rtol = 1e-5
(the same arithmetic, summed in another order); under static AMP the
result dtypes must equal JAX's and the values agree within 1e-2 of each
tensor's largest magnitude (a bf16 rounding, 2^-8, may fall the other
way).
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import paddle_tpu.static as jstatic
from paddle_tpu.static import executor as jexecutor
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.models import scope_from_numpy, scope_to_numpy
from paddle_tpu_torch.static import backward as tbackward
from paddle_tpu_torch.static import executor as texecutor

FP32_TOL = 1e-5
AMP_TOL = 1e-2

# name -> (input specs {name: (shape, dtype, kind)}, builder(static, ins));
# kind "x": a differentiated input, "label": integer labels (not
# differentiated), "ties": values from {0, 1, 2} (pooling windows with
# tied maxima), "soft": rows of probabilities
OPS = {
    **{f"conv2d_k{k}_s{s}_p{p}{'_bias' if bias else ''}": (
        {"x": ([2, 3, 9, 9], "float32", "x")},
        lambda S, i, k=k, s=s, p=p, bias=bias: S.nn.conv2d(
            i["x"], 4, k, stride=s, padding=p,
            bias_attr=None if bias else False))
       for k, s, p, bias in [(1, 1, 0, False), (1, 2, 0, False),
                             (3, 1, 1, False), (3, 2, 1, True),
                             (7, 2, 3, False)]},
    "pool2d_max_3x3_s2_p1": (
        {"x": ([2, 3, 9, 9], "float32", "x")},
        lambda S, i: S.nn.pool2d(i["x"], pool_size=3, pool_type="max",
                                 pool_stride=2, pool_padding=1)),
    "pool2d_max_tied_windows": (
        {"x": ([2, 3, 8, 8], "float32", "ties")},
        lambda S, i: S.nn.pool2d(i["x"], pool_size=3, pool_type="max",
                                 pool_stride=2, pool_padding=1)),
    "pool2d_global_avg": (
        {"x": ([2, 5, 7, 7], "float32", "x")},
        lambda S, i: S.nn.pool2d(i["x"], global_pooling=True,
                                 pool_type="avg")),
    "pool2d_global_max_tied": (
        {"x": ([2, 5, 3, 3], "float32", "ties")},
        lambda S, i: S.nn.pool2d(i["x"], global_pooling=True,
                                 pool_type="max")),
    "pool2d_avg_3x3_s2_p1": (
        {"x": ([2, 3, 9, 9], "float32", "x")},
        lambda S, i: S.nn.pool2d(i["x"], pool_size=3, pool_type="avg",
                                 pool_stride=2, pool_padding=1)),
    "batch_norm": (
        {"x": ([4, 3, 5, 5], "float32", "x")},
        lambda S, i: S.nn.batch_norm(i["x"])),
    "batch_norm_relu": (
        {"x": ([4, 3, 5, 5], "float32", "x")},
        lambda S, i: S.nn.batch_norm(i["x"], act="relu")),
    "batch_norm_tanh": (
        {"x": ([4, 3, 5, 5], "float32", "x")},
        lambda S, i: S.nn.batch_norm(i["x"], act="tanh")),
    "batch_norm_is_test": (
        {"x": ([4, 3, 5, 5], "float32", "x")},
        lambda S, i: S.nn.batch_norm(i["x"], is_test=True)),
    "relu": ({"x": ([2, 3, 4, 4], "float32", "x")},
             lambda S, i: S.nn.relu(i["x"])),
    "elementwise_add": (
        {"x": ([2, 3, 4, 4], "float32", "x"),
         "y": ([2, 3, 4, 4], "float32", "x")},
        lambda S, i: i["x"] + i["y"]),
    "elementwise_add_broadcast": (
        {"x": ([2, 3, 4, 4], "float32", "x"),
         "y": ([4, 4], "float32", "x")},
        lambda S, i: i["x"] + i["y"]),
    "elementwise_sub_mul_div": (
        {"x": ([2, 3, 4], "float32", "x"), "y": ([2, 3, 4], "float32", "x")},
        lambda S, i: (i["x"] - i["y"]) * i["y"] / (i["x"] * i["y"] + 4.0)),
    "elementwise_scalars": (
        {"x": ([2, 3, 4], "float32", "x")},
        lambda S, i: 2.0 - (3.0 * i["x"] + 1.0) / 4.0),
    "flatten": ({"x": ([2, 3, 2, 2], "float32", "x")},
                lambda S, i: S.nn.flatten(i["x"], axis=1)),
    "fc_2d": ({"x": ([4, 6], "float32", "x")},
              lambda S, i: S.nn.fc(i["x"], 5)),
    "fc_2d_no_bias": ({"x": ([4, 6], "float32", "x")},
                      lambda S, i: S.nn.fc(i["x"], 5, bias_attr=False)),
    "fc_4d": ({"x": ([2, 3, 2, 2], "float32", "x")},
              lambda S, i: S.nn.fc(i["x"], 5)),
    "softmax_with_cross_entropy": (
        {"x": ([4, 7], "float32", "x"), "label": ([4, 1], "int64", "label")},
        lambda S, i: S.nn.softmax_with_cross_entropy(i["x"], i["label"])),
    "softmax_with_cross_entropy_soft_label": (
        {"x": ([4, 7], "float32", "x"), "label": ([4, 7], "float32", "soft")},
        lambda S, i: S.nn.softmax_with_cross_entropy(i["x"], i["label"],
                                                     soft_label=True)),
    "mean": ({"x": ([3, 5], "float32", "x")},
             lambda S, i: S.nn.mean(i["x"])),
}


def _inputs(specs, rng):
    feed = {}
    for name, (shape, dtype, kind) in specs.items():
        if kind == "label":
            feed[name] = rng.integers(0, 7, shape).astype(np.int64)
        elif kind == "ties":
            feed[name] = rng.integers(0, 3, shape).astype(np.float32)
        elif kind == "soft":
            p = rng.random(shape)
            feed[name] = (p / p.sum(-1, keepdims=True)).astype(np.float32)
        else:
            feed[name] = rng.standard_normal(shape).astype(np.float32)
    return feed


def _build(static, specs, build, amp):
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        ins = {n: static.data(n, shape, dtype)
               for n, (shape, dtype, _) in specs.items()}
        y = build(static, ins)
        w = static.data("w", y.shape)
        loss = static.nn.mean(y * w)
        static.append_backward(loss, parameter_list=[
            v for n, v in ins.items() if specs[n][2] != "label"])
    main._amp_bf16 = amp
    return main, startup, y


def _grads(main):
    return [n for n in main.global_block().vars if n.endswith("@GRAD")]


def _close(name, got, want, amp):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    if amp:
        err = np.abs(got - want).max(initial=0.0)
        assert err <= AMP_TOL * max(np.abs(want).max(initial=0.0), 1e-30), (
            name, err)
    else:
        np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
@pytest.mark.parametrize("case", list(OPS))
def test_op_forward_and_every_grad_match_jax(case, amp):
    specs, build = OPS[case]
    rng = np.random.default_rng(7)
    jm, js, jy = _build(jstatic, specs, build, amp)
    tm, ts, ty = _build(tstatic, specs, build, amp)
    names = _grads(jm)
    assert names == _grads(tm) and names
    assert [op.type for op in jm.global_block().ops] == [
        op.type for op in tm.global_block().ops]

    jexe, jscope = jstatic.Executor(), jstatic.Scope()
    jexe.run(js, scope=jscope)
    arrays = {}
    for n in jscope.names():
        a = rng.standard_normal(np.shape(jscope.get(n))).astype(np.float32)
        arrays[n] = np.abs(a) + 0.5 if "bn_var" in n else a
        jscope.set(n, arrays[n])
    tscope = scope_from_numpy(arrays, "cpu")
    feed = _inputs(specs, rng)
    feed["w"] = (rng.standard_normal(jy.shape) * np.prod(jy.shape)).astype(
        np.float32)

    fetch = [jy.name] + names
    want = jexe.run(jm, feed=feed, fetch_list=fetch, scope=jscope)
    got = tstatic.Executor("cpu").run(tm, feed=feed, fetch_list=fetch,
                                      scope=tscope, return_numpy=False)
    for name, g, w in zip(fetch, got, want):
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name, (
            name, g.dtype, w.dtype)
        _close(name, g.float().numpy(), w.astype(np.float32), amp)
    after = scope_to_numpy(tscope)
    assert sorted(after) == sorted(jscope.names())
    for n, v in after.items():
        _close(n, v, np.asarray(jscope.get(n)), amp)


def test_amp_op_sets_equal_jax():
    assert texecutor._AMP_BF16_OPS == jexecutor._AMP_BF16_OPS
    assert texecutor._AMP_F32_OPS == jexecutor._AMP_F32_OPS


@pytest.mark.parametrize("case", ["conv2d_k3_s2_p1_bias", "batch_norm_relu",
                                  "pool2d_max_tied_windows", "fc_4d",
                                  "softmax_with_cross_entropy"])
def test_saved_graph_grad_equals_recomputing_vjp(case):
    """The grad op differentiates the graph its forward op saved; a
    reference recomputes the forward inside ``torch.func.vjp`` with the
    missing cotangents zero-filled (the JAX package's rule).  The two
    agree exactly, for every differentiated input."""
    specs, build = OPS[case]
    main, _, _ = _build(tstatic, specs, build, amp=False)
    block = main.global_block()
    fwd = block.ops[0]
    gop = next(op for op in block.ops if getattr(op, "forward_op", None) == 0)
    rng = np.random.default_rng(3)
    args = []
    for n in fwd.in_order:
        v = block.var(n)
        if v.dtype == torch.int64:
            args.append(torch.from_numpy(rng.integers(0, 7, v.shape)))
        else:
            args.append(torch.from_numpy(
                rng.standard_normal(v.shape).astype(np.float32)))
    outs, saved = tbackward.forward_saving(fwd.fn, args, gop.diff_idx)
    avail = [n + "@GRAD" in gop.input("Out@GRAD") for n in fwd.out_order]
    ogs = [torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32))
           for o, a in zip(outs, avail) if a]
    got = gop.fn(saved, *ogs)

    def partial(*prims):
        full = list(args)
        for i, p in zip(gop.diff_idx, prims):
            full[i] = p
        res = fwd.fn(*full)
        return res if isinstance(res, tuple) else (res,)

    res, vjp = torch.func.vjp(partial, *[args[i] for i in gop.diff_idx])
    it = iter(ogs)
    cots = tuple(next(it) if a else torch.zeros_like(r)
                 for r, a in zip(res, avail))
    want = vjp(cots)
    assert len(got) == len(want) == len(gop.diff_idx)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


MINIMIZE_CASES = {
    "SGD": ("SGD", dict(learning_rate=0.1), False),
    "Momentum-weight_decay": ("Momentum", dict(
        learning_rate=0.1, momentum=0.9, weight_decay=0.01), False),
    "Momentum-param_learning_rate": ("Momentum", dict(
        learning_rate=0.1, momentum=0.9), True),
    "Adam": ("Adam", dict(learning_rate=0.01), False),
    "AdamW": ("AdamW", dict(learning_rate=0.01, weight_decay=0.01), False),
}


@pytest.mark.parametrize("case", list(MINIMIZE_CASES))
def test_static_minimize_matches_jax(case):
    """``Optimizer.minimize`` of a static loss: the same update ops, state
    vars and startup ops as the JAX package, and after two steps from
    one scope the same parameters and optimizer state (the learning rate
    read once, scaled by the parameter's ``optimize_attr``; coupled
    decay in the gradient, decoupled after the step)."""
    import paddle_tpu as paddle

    name, kwargs, param_lr = MINIMIZE_CASES[case]
    progs = {}
    for tag, static, opt_cls, attr_cls in (
            ("jax", jstatic, getattr(paddle.optimizer, name),
             paddle.ParamAttr),
            ("port", tstatic, getattr(popt, name), tstatic.ParamAttr)):
        main, startup = static.Program(), static.Program()
        with static.program_guard(main, startup):
            x = static.data("x", [4, 3])
            w = static.data("w", [4, 2])
            pred = static.nn.fc(x, 2, weight_attr=attr_cls(
                learning_rate=0.5) if param_lr else None)
            loss = static.nn.mean(pred * w)
            opt_cls(**kwargs).minimize(loss)
        progs[tag] = (main, startup, loss)
    (jm, js, jl), (tm, ts, tl) = progs["jax"], progs["port"]
    for j, t in ((jm, tm), (js, ts)):
        assert [(op.type, op.inputs, op.outputs) for op in
                j.global_block().ops] == [(op.type, op.inputs, op.outputs)
                                          for op in t.global_block().ops]
    jexe, jscope = jstatic.Executor(), jstatic.Scope()
    jexe.run(js, scope=jscope)
    tscope = scope_from_numpy(
        {n: np.asarray(jscope.get(n)) for n in jscope.names()}, "cpu")
    texe = tstatic.Executor("cpu")
    rng = np.random.default_rng(2)
    for _ in range(2):
        feed = {"x": rng.standard_normal((4, 3)).astype(np.float32),
                "w": rng.standard_normal((4, 2)).astype(np.float32)}
        want = jexe.run(jm, feed=feed, fetch_list=[jl], scope=jscope)[0]
        got = texe.run(tm, feed=feed, fetch_list=[tl], scope=tscope)[0]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    after = scope_to_numpy(tscope)
    assert sorted(after) == sorted(jscope.names())
    for n, v in after.items():
        np.testing.assert_allclose(v, np.asarray(jscope.get(n)), rtol=1e-6,
                                   atol=1e-7, err_msg=n)


def test_feed_on_the_device_is_used_as_is():
    t = torch.ones(2, 3)
    feeds = texecutor.coerce_feeds(["x", "y"], {"x": t, "y": np.ones(2)},
                                   torch.device("cpu"))
    assert feeds["x"] is t
    assert feeds["y"].dtype == torch.float64
    with pytest.raises(KeyError, match="missing from feed dict"):
        texecutor.coerce_feeds(["z"], {"x": t}, torch.device("cpu"))


# ---- the JAX package's first two static-graph tests and its BN test ----

def test_program_build_and_run():
    main = tstatic.Program()
    startup = tstatic.Program()
    with tstatic.program_guard(main, startup):
        x = tstatic.data("x", [4, 3])
        y = tstatic.nn.fc(x, 2)
        out = tstatic.nn.relu(y)
    exe = tstatic.Executor("cpu")
    exe.run(startup)
    res = exe.run(main, feed={"x": np.ones((4, 3), np.float32)},
                  fetch_list=[out])
    assert res[0].shape == (4, 2)
    assert (res[0] >= 0).all()


def test_append_backward_and_sgd_converges():
    """fit-a-line: y = xw+b fitted by static SGD."""
    rng = np.random.RandomState(0)
    true_w = rng.rand(3, 1).astype(np.float32)
    X = rng.rand(64, 3).astype(np.float32)
    Y = X @ true_w + 0.1

    main = tstatic.Program()
    startup = tstatic.Program()
    with tstatic.program_guard(main, startup):
        x = tstatic.data("x", [64, 3])
        y = tstatic.data("y", [64, 1])
        pred = tstatic.nn.fc(x, 1)
        diff = pred - y
        loss = tstatic.nn.mean(diff * diff)
        opt = popt.SGD(learning_rate=0.5)
        opt.minimize(loss)

    exe = tstatic.Executor("cpu")
    exe.run(startup)
    losses = []
    for _ in range(30):
        out = exe.run(main, feed={"x": X, "y": Y}, fetch_list=[loss])
        losses.append(float(out[0][0]))
    assert losses[-1] < losses[0] * 0.1, losses[::10]


def test_static_batch_norm_updates_running_stats():
    """Training-mode static BN blends the batch stats (biased variance)
    into the running Mean/Variance vars in place."""
    main, startup = tstatic.Program(), tstatic.Program()
    with tstatic.program_guard(main, startup):
        x = tstatic.data("x", [8, 3, 4, 4])
        y = tstatic.nn.batch_norm(x, momentum=0.9)
        out = tstatic.nn.mean(y)
    exe = tstatic.Executor("cpu")
    scope = tstatic.Scope()
    exe.run(startup, scope=scope)
    mean_name = next(n for n in scope.names() if "bn_mean" in n)
    var_name = next(n for n in scope.names() if "bn_var" in n)
    rng = np.random.RandomState(0)
    ref_mean = np.zeros(3, np.float64)
    ref_var = np.ones(3, np.float64)
    for i in range(3):
        xv = (rng.rand(8, 3, 4, 4) * (i + 1)).astype(np.float32)
        exe.run(main, feed={"x": xv}, fetch_list=[out], scope=scope)
        bm = xv.mean(axis=(0, 2, 3))
        bv = xv.var(axis=(0, 2, 3))
        ref_mean = 0.9 * ref_mean + 0.1 * bm
        ref_var = 0.9 * ref_var + 0.1 * bv
    np.testing.assert_allclose(scope.get(mean_name).numpy(), ref_mean,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(scope.get(var_name).numpy(), ref_var,
                               rtol=1e-4, atol=1e-5)


# ---- the device rule and the refusals ----

def test_executor_defaults_to_the_card_and_never_falls_back():
    if torch.cuda.is_available():
        assert tstatic.Executor().place.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="needs CUDA"):
        tstatic.Executor()


def _tiny_program():
    main, startup = tstatic.Program(), tstatic.Program()
    with tstatic.program_guard(main, startup):
        x = tstatic.data("x", [2, 3])
        loss = tstatic.nn.mean(tstatic.nn.fc(x, 2))
    return main, startup, loss


def _mesh(main):
    main._mesh_axes = {"data": 2}


def _pipeline(main):
    main._pipeline_opt = {"num_stages": 2}


@pytest.mark.parametrize("setup", [_mesh, _pipeline, "FLAGS_check_nan_inf"],
                         ids=["mesh", "pipeline", "check_nan_inf"])
def test_unported_programs_raise(setup, monkeypatch):
    main, startup, loss = _tiny_program()
    if setup == "FLAGS_check_nan_inf":
        monkeypatch.setenv(setup, "1")
    else:
        setup(main)
    exe = tstatic.Executor("cpu")
    exe.run(startup)
    with pytest.raises(NotImplementedError, match="not supported"):
        exe.run(main, feed={"x": np.ones((2, 3), np.float32)},
                fetch_list=[loss])


@pytest.mark.parametrize("package", ["jax", "port"])
def test_gradient_of_a_var_read_twice_by_one_op(package):
    """``mean(w * w)``: the gradient is 2w/N, and the port returns it,
    accumulating the second slot like another consumer (``@RENAME@1``
    and a ``sum``).  The JAX case records a known fault of the reference
    (ROADMAP queue 3), not the right answer: the JAX package names both
    slots' gradients ``w@GRAD``, so the second overwrites the first and
    it returns half the gradient, w/N.  Once the reference is repaired,
    its case is to expect 2w/N as the port's does."""
    static = jstatic if package == "jax" else tstatic
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        w = static.create_parameter([2, 3], "float32")
        loss = static.nn.mean(w * w)
        (gw,) = static.gradients(loss, w)
    assert gw.name == w.name + "@GRAD"
    exe = static.Executor() if package == "jax" else static.Executor("cpu")
    scope = static.Scope()
    exe.run(startup, scope=scope)
    got = exe.run(main, fetch_list=[gw], scope=scope)[0]
    wv = np.asarray(scope.get(w.name))
    gradient = 2 * wv / wv.size
    # the JAX package's known fault: half the gradient
    want = gradient / 2 if package == "jax" else gradient
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_clone_is_a_program_that_trains_alike():
    main, startup, loss = _tiny_program()
    with tstatic.program_guard(main, startup):
        popt.SGD(0.1).minimize(loss)
    twin = main.clone()
    assert [op.type for op in twin.global_block().ops] == [
        op.type for op in main.global_block().ops]
    assert list(twin.global_block().vars) == list(main.global_block().vars)
    exe = tstatic.Executor("cpu")
    feed = {"x": np.arange(6, dtype=np.float32).reshape(2, 3)}
    runs = []
    for prog in (main, twin):
        scope = tstatic.Scope()
        exe.run(startup, scope=scope)
        runs.append([exe.run(prog, feed=feed, fetch_list=[loss.name],
                             scope=scope)[0] for _ in range(3)])
    np.testing.assert_array_equal(runs[0], runs[1])


@pytest.mark.parametrize("call", [
    lambda m: tstatic.Executor("cpu").train_from_dataset(m),
    lambda m: tstatic.Executor("cpu").infer_from_dataset(m),
    lambda m: tstatic.ParamAttr(regularizer=0.01),
    # the eager minimize is ported (test_torch_eager_optimizer.py); what
    # still refuses on its way is an L1Decay, which JAX applies as L2
    lambda m: popt.SGD(0.1, weight_decay=popt.L1Decay(0.1)).minimize(
        torch.ones((), requires_grad=True)),
], ids=["train_from_dataset", "infer_from_dataset",
        "regularizer", "eager_minimize"])
def test_unported_entry_points_raise(call):
    main, _, _ = _tiny_program()
    with pytest.raises(NotImplementedError, match="not ported"):
        call(main)
