"""Port parity: the static graph's sub-blocks (`cond`, `while_loop`,
`switch_case`, `case`, `StaticRNN`), the utility ops of ``extras.py``,
the inference clone (``Program.clone(for_test=True)``) and static
dropout, each program built alike in both packages (``build(static)``),
the port's scope carried from the JAX startup's, both run on the CPU:
outputs and, where JAX differentiates, every parameter gradient within
1e-5.  ``jax.vjp`` of ``lax.while_loop`` raises, and so does the port's
grad op of a ``while`` op."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import paddle_tpu.static as jstatic
import paddle_tpu_torch.static as tstatic
from jax_static_start import numpy_start
from paddle_tpu.ops import sequence_ops as JS
from paddle_tpu.optimizer import SGD as JSGD
from paddle_tpu_torch.models.weights import scope_from_numpy
from paddle_tpu_torch.ops import sequence_ops as PS
from paddle_tpu_torch.optimizer import SGD as TSGD

TOL = 1e-5
B, D = 4, 3


_BUILT = {}


def _run_both(build, feed, key=None):
    """`build(static)` -> the fetch vars, in each package's programs; one
    start scope (``jax_static_start.numpy_start`` of the JAX startup) in
    both; one run of each from it.  The fetches: ([JAX], [port]) numpy lists.  With a `key` the
    programs, executors and start scope are built once and shared by the
    cases that pass it (one JAX compile per program)."""
    if key not in _BUILT:
        programs = []
        for pkg in (jstatic, tstatic):
            main, startup = pkg.Program(), pkg.Program()
            with pkg.program_guard(main, startup):
                programs.append((main, startup, build(pkg)))
        built = (programs, numpy_start(programs[0][1]), jstatic.Executor(),
                 tstatic.Executor("cpu"))
        if key is None:
            return _run(built, feed)
        _BUILT[key] = built
    return _run(_BUILT[key], feed)


def _run(built, feed):
    ((jmain, _, jfetch), (tmain, _, tfetch)), start, jexe, texe = built
    jscope = jstatic.Scope()
    for n, v in start.items():
        jscope.set(n, jnp.asarray(v))
    return ([jexe.run(jmain, feed=feed, fetch_list=jfetch, scope=jscope)],
            [texe.run(tmain, feed=feed, fetch_list=tfetch,
                      scope=scope_from_numpy(start, "cpu"))])


def _hold(jax_runs, port_runs, tol=TOL):
    for jr, pr in zip(jax_runs, port_runs):
        assert len(jr) == len(pr)
        for a, b in zip(jr, pr):
            np.testing.assert_allclose(b, a, rtol=tol, atol=tol)


def _with_grads(static, loss, outs):
    return [loss] + list(outs) + [g for _, g in static.append_backward(loss)]


X = np.random.default_rng(0).standard_normal((B, D)).astype(np.float32)


@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["true", "false"])
def test_cond_matches_jax(sign):
    """Each branch reads the fc's output; the one the sum's sign picks
    runs, its gradient reaching the fc's weights."""
    def build(static):
        x = static.data("x", [B, D])
        h = static.nn.fc(x, D)
        w = static.create_parameter([D], "float32")
        out = static.nn.cond(static.nn.reduce_sum(h) > 0.0,
                             lambda: h * w + 1.0, lambda: h - w)
        return _with_grads(static, static.nn.mean(static.nn.tanh_act(out)),
                           [out])

    _hold(*_run_both(build, {"x": sign * np.abs(X)}, key="cond"))


def _while(static, differentiate):
    x = static.data("x", [B, D])
    h = static.nn.fc(x, D)
    i = static.nn.mean(x) * 0.0
    out = static.nn.while_loop(lambda i, v: i < 3.0,
                               lambda i, v: [i + 1.0, v * 0.5 + 1.0],
                               [i, h])
    loss = static.nn.mean(out[1])
    if differentiate:
        return [loss] + [g for _, g in static.append_backward(loss)]
    return [loss, out[0], out[1]]


def test_while_loop_matches_jax():
    _hold(*_run_both(lambda s: _while(s, False), {"x": X}))


def test_while_loop_backward_raises_as_jax_does():
    """append_backward over a ``while`` op builds in both packages; the
    run raises the same ValueError in both, the scope left as it was."""
    with pytest.raises(ValueError, match="Reverse-mode differentiation "
                                         "does not work"):
        _run_both(lambda s: _while(s, True), {"x": X})
    main, startup = tstatic.Program(), tstatic.Program()
    with tstatic.program_guard(main, startup):
        fetches = _while(tstatic, True)
    exe, scope = tstatic.Executor("cpu"), tstatic.Scope()
    exe.run(startup, scope=scope)
    before = {n: scope.get(n).clone() for n in scope.names()}
    with pytest.raises(ValueError, match="Reverse-mode differentiation "
                                         "does not work"):
        exe.run(main, feed={"x": X}, fetch_list=fetches, scope=scope)
    for n, v in before.items():
        assert torch.equal(scope.get(n), v)


@pytest.mark.parametrize("index", [0, 2, 7], ids=["key0", "key2",
                                                   "unmatched"])
@pytest.mark.parametrize("default", [False, True],
                         ids=["no_default", "default"])
def test_switch_case_matches_jax(index, default):
    def build(static):
        x = static.data("x", [B, D])
        idx = static.data("idx", [1], dtype="int32")
        h = static.nn.fc(x, D)
        out = static.nn.switch_case(
            idx, [(0, lambda: h * 2.0), (2, lambda: h - 1.0),
                  (1, lambda: static.nn.sigmoid_act(h))],
            default=(lambda: h * h) if default else None)
        return _with_grads(static, static.nn.mean(out), [out])

    _hold(*_run_both(build, {"x": X, "idx": np.array([index], np.int32)},
                     key=("switch_case", default)))


@pytest.mark.parametrize("which", [0, 1, 2], ids=["first", "second",
                                                   "default"])
def test_case_matches_jax(which):
    """The first true predicate's branch runs (the second pair's
    predicate is also true when the first is), else the default."""
    def build(static):
        x = static.data("x", [B, D])
        k = static.data("k", [1])
        h = static.nn.fc(x, D)
        out = static.nn.case(
            [(k < 0.5, lambda: h + 1.0), (k < 1.5, lambda: h * 3.0)],
            default=lambda: static.nn.tanh_act(h))
        return _with_grads(static, static.nn.mean(out), [out])

    _hold(*_run_both(build, {"x": X, "k": np.array([which], np.float32)},
                     key="case"))


T_RNN = 5


def _rnn(static, mem_from_shape):
    """An Elman step over [T, B, D] inputs: memory from a fed h0 or from
    ``shape=`` + ``batch_ref=``, two step outputs."""
    x = static.data("xs", [T_RNN, B, D])
    h0 = static.data("h0", [B, D])
    rnn = static.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        prev = (rnn.memory(shape=[-1, D], batch_ref=h0, value=0.5)
                if mem_from_shape else rnn.memory(init=h0))
        nxt = static.nn.fc(xt + prev, D, activation="tanh")
        rnn.update_memory(prev, nxt)
        rnn.step_output(nxt)
        rnn.step_output(static.nn.fc(nxt, 2))
    hs, ys = rnn()
    assert hs.shape == [T_RNN, B, D] and ys.shape == [T_RNN, B, 2]
    loss = static.nn.mean(static.nn.reshape(ys, [T_RNN * B, 2]))
    return _with_grads(static, loss, [hs, ys])


@pytest.mark.parametrize("mem_from_shape", [False, True],
                         ids=["init", "shape"])
def test_static_rnn_matches_jax(mem_from_shape):
    rng = np.random.default_rng(1)
    feed = {"xs": rng.standard_normal((T_RNN, B, D)).astype(np.float32),
            "h0": rng.standard_normal((B, D)).astype(np.float32)}
    _hold(*_run_both(lambda s: _rnn(s, mem_from_shape), feed))


def _rnn_error(static, case):
    x = static.data("x", [T_RNN, B, D])
    rnn = static.StaticRNN()
    if case == "outside_step":
        rnn.step_input(x)
    with rnn.step():
        if case == "memory_without_init":
            rnn.memory()
        xt = rnn.step_input(x) if case != "no_step_input" else None
        if case == "not_updated":
            rnn.memory(init=static.data("h", [B, D]))
        if case != "no_step_output":
            rnn.step_output(xt if xt is not None else x)


@pytest.mark.parametrize("case,error,match", [
    ("outside_step", RuntimeError, "inside"),
    ("no_step_input", ValueError, "step_input"),
    ("no_step_output", ValueError, "step_output"),
    ("not_updated", ValueError, "never update_memory"),
    ("memory_without_init", ValueError, "init= or shape="),
])
def test_static_rnn_errors_are_the_jax_ones(case, error, match):
    for static in (jstatic, tstatic):
        with static.program_guard(static.Program(), static.Program()):
            with pytest.raises(error, match=match):
                _rnn_error(static, case)


def test_utility_ops_match_jax():
    """select_input, select_output, assign_value and a passing Assert."""
    def build(static):
        a = static.data("a", [B, D])
        b = static.data("b", [B, D])
        m = static.data("m", [1], dtype="int32")
        sel = static.nn.select_input([a, b], m)
        o0, o1 = static.select_output(a, [a, b], m)
        c = static.assign_value([2, 2], "float32", [[1, 2], [3, 4]])
        tok = static.nn.Assert(static.nn.reduce_sum(c) > 0.0)
        return [sel, o0, o1, c, tok]

    for m in (0, 1, 5):
        _hold(*_run_both(build, {"a": X, "b": X + 1,
                                 "m": np.array([m], np.int32)},
                         key="utility"))


def test_assert_and_print_run_on_the_host(capsys):
    main, startup = tstatic.Program(), tstatic.Program()
    with tstatic.program_guard(main, startup):
        x = tstatic.data("x", [2])
        y = tstatic.nn.Print(x, message="x: ")
        tok = tstatic.nn.Assert(tstatic.nn.reduce_sum(y) > 0.0, [y])
    exe = tstatic.Executor("cpu")
    exe.run(main, feed={"x": np.ones(2, np.float32)}, fetch_list=[tok])
    assert "x: x = tensor([1., 1.])" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match=r"Assert failed: \[-1. -1.\]"):
        exe.run(main, feed={"x": -np.ones(2, np.float32)}, fetch_list=[tok])


def _classifier(static, opt_cls, drop):
    """conv, a training batch norm, dropout and an fc, trained by SGD."""
    img = static.data("img", [B, 2, 4, 4])
    lbl = static.data("lbl", [B, 1], dtype="int64")
    h = static.nn.conv2d(img, 3, 3, padding=1)
    h = static.nn.batch_norm(h, act="relu")
    h = static.nn.dropout(static.nn.flatten(h), dropout_prob=drop, seed=5)
    logits = static.nn.fc(h, 4)
    loss = static.nn.mean(static.nn.softmax_with_cross_entropy(logits, lbl))
    test = static.default_main_program().clone(for_test=True)
    opt_cls(learning_rate=0.1).minimize(loss)
    return test, logits, loss


def test_clone_for_test_prunes_updates_and_matches_jax():
    """The clone taken before minimize and one taken after both hold no
    grad or update op; running the after-clone leaves every parameter and
    running stat bitwise as it was and matches the JAX clone's logits
    (batch norm on its running stats, set away from their 0 and 1
    starts; dropout the identity)."""
    rng = np.random.default_rng(2)
    feed = {"img": rng.standard_normal((B, 2, 4, 4)).astype(np.float32),
            "lbl": rng.integers(0, 4, (B, 1))}
    logits = []
    for pkg, opt in ((jstatic, JSGD), (tstatic, TSGD)):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            before, out, loss = _classifier(pkg, opt, 0.5)
        after = main.clone(for_test=True)
        for prog in (before, after):
            types = [op.type for op in prog.global_block().ops]
            assert "sgd" not in types and not any(
                t.endswith("_grad") for t in types)
            assert "dropout" not in types and "scale" in types
        if pkg is jstatic:
            carried = numpy_start(startup)
            for n in carried:
                if n.startswith("bn_"):
                    carried[n] = rng.uniform(0.5, 1.5, carried[n].shape
                                             ).astype(np.float32)
            exe, scope = pkg.Executor(), pkg.Scope()
            for n, v in carried.items():
                scope.set(n, jnp.asarray(v))
        else:
            exe = pkg.Executor("cpu")
            scope = scope_from_numpy(carried, "cpu")
            kept = {n: scope.get(n).clone() for n in scope.names()}
        logits.append(exe.run(after, feed=feed, fetch_list=[out],
                              scope=scope)[0])
    np.testing.assert_allclose(logits[1], logits[0], rtol=TOL, atol=TOL)
    for n, v in kept.items():
        assert torch.equal(scope.get(n), v), n


def _dropout_program(p):
    main, startup = tstatic.Program(), tstatic.Program()
    with tstatic.program_guard(main, startup):
        x = tstatic.data("x", [64, 64])
        w = tstatic.create_parameter([64], "float32", default_value=1.0)
        y = tstatic.nn.dropout(x * w, dropout_prob=p)
        loss = tstatic.nn.reduce_sum(y * x)
        (gw,) = tstatic.gradients(loss, w)
    return main, startup, y, gw


def test_static_dropout_masks():
    """Each run draws a fresh mask, keeping within 3 standard deviations
    of 1 - p of the entries, each scaled by 1/(1 - p); the grad op sees
    the forward's mask (dL/dw = sum over rows of mask x² / (1 - p));
    the counter advances once a run; a clone for test is the
    identity."""
    p, n = 0.3, 64 * 64
    main, startup, y, gw = _dropout_program(p)
    exe, scope = tstatic.Executor("cpu"), tstatic.Scope()
    exe.run(startup, scope=scope)
    x = np.random.default_rng(3).uniform(0.5, 1.5, (64, 64)).astype(
        np.float32)
    masks = []
    for step in range(3):
        yv, g = exe.run(main, feed={"x": x}, fetch_list=[y, gw], scope=scope)
        kept = yv != 0
        assert abs(kept.mean() - (1 - p)) < 3 * np.sqrt(p * (1 - p) / n)
        np.testing.assert_allclose(yv[kept], x[kept] / (1 - p), rtol=1e-6)
        np.testing.assert_allclose(g, (kept * x * x).sum(0) / (1 - p),
                                   rtol=1e-5)
        masks.append(kept)
        (ctr,) = main._rng_step_vars
        assert int(scope.get(ctr)) == step + 1
    assert not np.array_equal(masks[0], masks[1])
    assert not np.array_equal(masks[1], masks[2])
    test = main.clone(for_test=True)
    np.testing.assert_array_equal(
        exe.run(test, feed={"x": x}, fetch_list=[y], scope=scope)[0], x)
    assert int(scope.get(ctr)) == 3


def test_sub_blocks_under_static_amp_raise():
    main, startup = tstatic.Program(), tstatic.Program()
    with tstatic.program_guard(main, startup):
        x = tstatic.data("x", [B, D])
        h = tstatic.nn.fc(x, D)
        out = tstatic.nn.cond(tstatic.nn.reduce_sum(h) > 0.0,
                              lambda: h * 2.0, lambda: h - 1.0)
        loss = tstatic.nn.mean(out)
        tstatic.amp.decorate(TSGD(learning_rate=0.1)).minimize(loss)
    exe = tstatic.Executor("cpu")
    exe.run(startup)
    with pytest.raises(NotImplementedError, match="sub-blocks"):
        exe.run(main, feed={"x": X}, fetch_list=[loss])


def test_book_static_nn_ops_match_jax(monkeypatch):
    """The ``static.nn`` functions the book's programs use, in one
    program with every parameter's gradient: embedding (with a
    padding_idx), matmul, transpose, reshape, concat, layer_norm, the
    activations, reduce_sum, cross_entropy, accuracy, nce (the port's
    negatives patched to JAX's draw) and crf_decoding."""
    seed, vocab, neg = 3, 11, 4
    ids = np.asarray(jax.random.randint(JS._op_key(seed), (neg,), 0, vocab))
    monkeypatch.setattr(PS, "draw_negatives",
                        lambda *a: torch.tensor(ids))

    def build(static):
        w = static.data("w", [B, 5], dtype="int64")
        lbl = static.data("lbl", [B, 1], dtype="int64")
        lens = static.data("lens", [B], dtype="int64")
        e = static.nn.embedding(w, [vocab, D], padding_idx=2)     # B 5 D
        f = static.nn.layer_norm(static.nn.reshape(e, [B, 5 * D]),
                                 begin_norm_axis=1)
        g = static.nn.matmul(static.nn.reshape(f, [B, 5, D]),
                             static.nn.transpose(
                                 static.nn.reshape(f, [B, 5, D]), [0, 2, 1]))
        h = static.nn.concat_static([static.nn.tanh_act(g),
                                     static.nn.sigmoid_act(g)], axis=2)
        probs = static.nn.softmax(static.nn.fc(h, 4))
        ce = static.nn.cross_entropy(probs, lbl)
        acc = static.nn.accuracy(probs, lbl)
        trans = static.create_parameter([6, 4], "float32")
        path = static.nn.crf_decoding(static.nn.reshape(
            static.nn.fc(f, 20), [B, 5, 4]), trans, length=lens)
        cost = static.nn.nce(static.nn.fc(f, 6), lbl, vocab,
                             num_neg_samples=neg, seed=seed)
        loss = static.nn.mean(ce) + static.nn.mean(cost) + \
            static.nn.reduce_sum(static.nn.reduce_sum(g, dim=[1, 2])) * 0.01
        return [loss, acc, path] + [
            gr for _, gr in static.append_backward(loss)]

    rng = np.random.default_rng(6)
    feed = {"w": rng.integers(0, vocab, (B, 5)),
            "lbl": rng.integers(0, 4, (B, 1)),
            "lens": np.array([5, 1, 3, 4])}
    jax_runs, port_runs = _run_both(build, feed)
    _hold(jax_runs, port_runs)


def test_mode_aware_create_parameter_and_framework_names():
    """``create_parameter`` makes an eager parameter in dygraph (a random
    initializer draws from an explicit generator, the port's idiom) and a
    static one in the default programs under ``enable_static()``, as
    JAX's does; ``seed`` and ``get_rng_state``/``set_rng_state`` repeat
    the default generators' draws; ``no_grad`` is torch's."""
    import paddle_tpu_torch as P

    assert P.in_dynamic_mode()
    gen = torch.Generator().manual_seed(0)
    p = P.create_parameter([2, 3], "float32", name="w_eager", device="cpu",
                           generator=gen)
    assert isinstance(p, torch.nn.Parameter) and p.name == "w_eager"
    assert p.device.type == "cpu" and p.requires_grad
    main, startup = tstatic.Program(), tstatic.Program()
    P.enable_static()
    try:
        assert not P.in_dynamic_mode()
        with tstatic.program_guard(main, startup):
            v = P.create_parameter([4], "float32", is_bias=True)
    finally:
        P.disable_static()
    assert P.in_dynamic_mode()
    assert isinstance(v, tstatic.Variable) and v.is_parameter
    assert main.global_block().vars[v.name] is v
    assert [op.type for op in startup.global_block().ops] == ["init"]
    with pytest.raises(ValueError, match="generator"):
        P.create_parameter([3], device="cpu")
    state = P.get_rng_state()
    a = torch.rand(3)
    P.set_rng_state(state)
    assert torch.equal(a, torch.rand(3))
    P.seed(5)
    b = torch.rand(3)
    P.seed(5)
    assert torch.equal(b, torch.rand(3))
    with P.no_grad():
        assert not (p * 2).requires_grad
