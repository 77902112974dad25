"""Port parity: ResNet-50's static training program
(``chip_smoke.build_static_resnet``, line for line
``bench.py::_build_static_resnet50``) in the port against the JAX
package.

(1) At full ResNet-50 and B 2, after minimize, the two programs hold the
same ops (types, input and output names, in order), the same vars (names
in order, shapes, dtypes, flags) and the same startup ops; nothing runs.

(2) A small ResNet (depths 1, 1, 1, 1, base 8, 64x64 images, 10 classes,
B 4, Momentum(0.1, 0.9)) from the JAX startup's scope (after
``paddle.seed(0)``).  The JAX run takes three `run` steps, each fetching
every var of the step, then one ``run_chained(n_steps=2)``; each of the
four segments is also run by the port from the JAX run's scope at its
start.

- Op by op, at the first and third step: every op of the port's program
  runs on the JAX run's values of its inputs, and each of its outputs
  (every activation, every ``@GRAD``, ``@RENAME`` and ``@SUM``, the
  updated parameter, velocity and running stats) is held to the JAX
  run's value of that var: within 1e-4 of the tensor's largest magnitude
  for a float32 output, 1e-2 (2.5 bfloat16 ulps) for a bfloat16 one, and
  of the same dtype (``chip_smoke.replay_held``, which phase 9 of the
  chip check runs on the card against the CPU).  Each op sees the inputs
  the JAX op saw, so no rounding difference upstream can move it.  One
  case is told apart: where a batch norm with a fused relu puts an
  element within rounding of 0 on the other side, its grad op is held
  over the other channels.
- End to end, each segment from one scope: fp32, each step's loss within
  1e-5 relative and every running stat within 1e-4 of its largest
  magnitude, or four times the JAX package's own disagreement with
  itself, whichever is larger; that disagreement is the larger of two
  runs on the same batch in another row order (reversed, and rolled by
  one), the same arithmetic summed in another order.  Every parameter
  and velocity within FLIP_TOL of its largest magnitude: a ReLU whose
  input lies within rounding of 0 takes the other side in one of the two
  runs, and its cotangent then enters or leaves every gradient upstream
  of it, in the JAX package against itself as much as against the port
  (over 12 initializations, four segments each, the port against the
  JAX package moved a velocity by up to 9.6e-2 of its largest
  magnitude); each op's arithmetic is held by the op-by-op check.
- AMP: the JAX side runs in a subprocess with
  ``--xla_allow_excess_precision=false``, so XLA rounds to bfloat16
  wherever the program converts (by default it keeps the float32 value
  where a convert pair would round, and then departs from the program).
  Every step's loss within 2e-2 relative, or four times the JAX
  package's own disagreement with itself as for fp32 (the second step
  of the chain follows a step whose bfloat16 roundings already moved
  the gradients), and the dtype of every var of the step and of the
  scope equal to the JAX package's.

The port's chained run equals its stepped runs bitwise.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import bench
import chip_smoke
import paddle_tpu as paddle
import paddle_tpu.static as jstatic
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.models import scope_from_numpy, scope_to_numpy

SMALL = dict(depths=(1, 1, 1, 1), base=8, image=64, classes=10)
B = 4
LOSS_TOL, SCOPE_TOL, MARGIN = 1e-5, 1e-4, 4.0
FLIP_TOL = 0.25
OP_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
AMP_LOSS_TOL = 2e-2
CHAINED = (False, False, False, True)   # the four segments
REPLAYED = (0, 2)                        # the steps held op by op


def _dtype(v):
    if isinstance(v.dtype, torch.dtype):
        return str(v.dtype).removeprefix("torch.")
    return np.dtype(v.dtype).name


def _describe(main):
    block = main.global_block()
    ops = [(op.type, op.inputs, op.outputs,
            list(getattr(op, "in_order", [])),
            list(getattr(op, "out_order", []))) for op in block.ops]
    vars_ = [(n, v.shape, _dtype(v), v.persistable, v.is_parameter,
              v.stop_gradient) for n, v in block.vars.items()]
    return ops, vars_


def test_full_resnet50_program_equals_the_bench_program():
    jm, js, jl, jflops = bench._build_static_resnet50(jstatic, 2)
    tm, ts, tl, tflops = chip_smoke.build_static_resnet(
        tstatic, popt.Momentum, 2)
    assert tflops == jflops
    assert tl.name == jl.name
    assert tm._amp_bf16 and jm._amp_bf16
    for j, t in ((jm, tm), (js, ts)):
        (jops, jvars), (tops, tvars) = _describe(j), _describe(t)
        assert len(tops) == len(jops)
        for a, b in zip(tops, jops):
            assert a == b
        assert tvars == jvars
    params = [v for v in tm.global_block().vars.values()
              if v.is_parameter and not v.stop_gradient]
    assert len(params) == 161
    assert sum(int(np.prod(v.shape)) for v in params) == 25_557_032
    persistable = [n for n, v in tm.global_block().vars.items()
                   if v.persistable]
    assert sum(n.startswith("bn_") for n in persistable) == 106
    assert sum(n.endswith("_velocity") for n in persistable) == 161
    assert round(jflops / 1e9, 2) == 8.18       # forward flops per image


def _jax_program(amp):
    paddle.seed(0)
    jm, js, jl, _ = chip_smoke.build_static_resnet(
        jstatic, paddle.optimizer.Momentum, B, amp=amp, **SMALL)
    return jm, js, jl


def _port_program(amp):
    return chip_smoke.build_static_resnet(tstatic, popt.Momentum, B,
                                          amp=amp, **SMALL)


def _batch():
    rng = np.random.RandomState(0)
    img = rng.rand(B, 3, SMALL["image"], SMALL["image"]).astype(np.float32)
    lab = rng.randint(0, SMALL["classes"], (B, 1)).astype(np.int64)
    return {"image": img, "label": lab}


def _jax_scope(arrays):
    scope = jstatic.Scope()
    for n, a in arrays.items():
        scope.set(n, paddle.to_tensor(a)._data)
    return scope


def _numpy(scope):
    return {n: np.asarray(scope.get(n)) for n in scope.names()}


def _segment(exe, prog, loss, scope, feed, chained, names=()):
    """One segment on `scope`: its losses (float64) and the values of
    `names` (a `run` only)."""
    if chained:
        out = exe.run_chained(prog, feed=feed, fetch_list=[loss], n_steps=2,
                              scope=scope)[0]
        return np.asarray(out, np.float64).ravel(), {}
    out = exe.run(prog, feed=feed, fetch_list=[loss] + list(names),
                  scope=scope)
    return (np.asarray(out[0], np.float64).ravel(),
            dict(zip(names, out[1:])))


def _jax_run(amp, feed):
    """The JAX run's four segments from its startup: for each, the scope
    at its start and end, its losses and (a `run`) every var's value;
    and the JAX package's disagreement with itself there, the larger of
    two runs from the same scope on the batch in another row order
    (reversed, and rolled by one): relative for each loss
    (``loss_floor``), and for each var of the scope as a share of its
    largest magnitude (``floors``)."""
    jm, js, jl = _jax_program(amp)
    exe, scope = jstatic.Executor(), jstatic.Scope()
    exe.run(js, scope=scope)
    names = [n for n, v in jm.global_block().vars.items()
             if not v.is_data and not v.persistable]
    others = [{n: np.ascontiguousarray(v[order]) for n, v in feed.items()}
              for order in (np.arange(B)[::-1], np.roll(np.arange(B), 1))]
    segments = []
    for chained in CHAINED:
        start = _numpy(scope)
        losses, vals = _segment(exe, jm, jl, scope, feed, chained, names)
        after = _numpy(scope)
        loss_floor, floors = np.zeros_like(losses), {}
        for other in others:
            twin = _jax_scope(start)
            # the same fetches, so the same compiled step
            twin_losses = _segment(exe, jm, jl, twin, other, chained,
                                   names)[0]
            loss_floor = np.maximum(
                loss_floor, np.abs(twin_losses - losses) / np.abs(losses))
            for n, v in _numpy(twin).items():
                floors[n] = max(floors.get(n, 0.0), chip_smoke.share(
                    _tensor(v), _tensor(after[n])))
        segments.append(dict(start=start, losses=losses, vals=vals,
                             after=after, loss_floor=loss_floor,
                             floors=floors))
    return segments


def _jax_amp_reference(path):
    """Writes `_jax_run(amp=True)` to `path` (run in a subprocess under
    ``--xla_allow_excess_precision=false``); bfloat16 values are stored
    as float32, exactly, with their names listed."""
    arrays, bf16 = {}, []
    for i, seg in enumerate(_jax_run(True, _batch())):
        arrays[f"{i}/losses"] = seg["losses"]
        arrays[f"{i}/loss_floor"] = seg["loss_floor"]
        for part in ("start", "vals", "after"):
            for n, v in seg[part].items():
                v = np.asarray(v)
                if v.dtype.name == "bfloat16":
                    bf16.append(f"{i}/{part}/{n}")
                    v = v.astype(np.float32)
                arrays[f"{i}/{part}/{n}"] = v
    arrays["bf16"] = np.array(bf16)
    np.savez(path, **arrays)


def _load_reference(path):
    data = np.load(path)
    bf16 = set(data["bf16"].tolist())
    segments = [dict(start={}, vals={}, after={}) for _ in CHAINED]
    for key in data.files:
        if key == "bf16":
            continue
        i, part, *name = key.split("/", 2)
        seg = segments[int(i)]
        if part in ("losses", "loss_floor"):
            seg[part] = data[key]
            continue
        v = torch.from_numpy(data[key])
        seg[part][name[0]] = v.to(torch.bfloat16) if key in bf16 else v
    return segments


@pytest.fixture(scope="module", autouse=True)
def _jax_amp_process(tmp_path_factory):
    """The JAX package's AMP run, started as the module starts and taken
    in a subprocess: XLA reads its flags once per process, and this
    process's JAX is already up."""
    path = tmp_path_factory.mktemp("jax_amp") / "run.npz"
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "")
        + " --xla_allow_excess_precision=false").strip())
    code = ("import sys, jax; jax.config.update('jax_platforms', 'cpu'); "
            "sys.path[:0] = sys.argv[1:3]; "
            "import test_torch_static_resnet as t; "
            "t._jax_amp_reference(sys.argv[3])")
    proc = subprocess.Popen([sys.executable, "-c", code,
                             os.path.dirname(tests), tests, str(path)],
                            env=env)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def jax_amp_run(_jax_amp_process):
    proc, path = _jax_amp_process
    assert proc.wait(timeout=600) == 0
    return _load_reference(path)


@pytest.fixture(scope="module")
def jax_fp32_run():
    return _jax_run(False, _batch())


def _tensor(v):
    if isinstance(v, torch.Tensor):
        return v
    v = np.asarray(v)
    if v.dtype.name == "bfloat16":
        return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(v))


def _replay(main, seg, feed):
    """``chip_smoke.replay_held`` of the port's `main` on the JAX run's
    values: each op's outputs held to the JAX run's values of those
    vars."""
    env = {n: _tensor(v) for part in ("start", "vals")
           for n, v in seg[part].items()}
    env.update({n: torch.from_numpy(v) for n, v in feed.items()})
    after = {n: _tensor(v) for n, v in seg["after"].items()}
    return chip_smoke.replay_held(tstatic, main, env, after, "cpu")


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_small_resnet_every_op_matches_jax_on_its_inputs(amp, request):
    segments = request.getfixturevalue(
        "jax_amp_run" if amp else "jax_fp32_run")
    main = _port_program(amp)[0]
    feed = _batch()
    held = set()
    for step in REPLAYED:
        worst, past, _ = _replay(main, segments[step], feed)
        assert not past, (step, past[:10])
        held |= set(worst)
    assert {"conv2d_grad", "batch_norm_grad", "pool2d_grad", "sum",
            "momentum", "fc_grad"} <= held


@pytest.mark.parametrize("far", [False, True], ids=["at_rounding", "far"])
def test_op_by_op_check_tells_a_batch_norm_relu_flip_apart(far):
    """The reference's output of a batch norm with a fused relu moved to
    the other side of 0 at one element where it is 0: by a share of 1e-6
    of its largest value (what two sums in another order can do) the
    element and its channel are counted, and that grad op's other
    channels held; by a share of 1e-2 it is a fault."""
    main, startup, loss, _ = _port_program(False)
    feed = _batch()
    exe = tstatic.Executor("cpu")
    scope = tstatic.Scope()
    exe.run(startup, scope=scope)
    start = {n: scope.get(n).clone() for n in scope.names()}
    names = [n for n, v in main.global_block().vars.items()
             if not v.is_data and not v.persistable]
    vals = exe.run(main, feed=feed, fetch_list=names, scope=scope,
                   return_numpy=False)
    env = dict(start, **dict(zip(names, vals)))
    env.update({n: torch.from_numpy(v) for n, v in feed.items()})
    y = next(op.out_order[0] for op in main.global_block().ops
             if op.type == "batch_norm" and op.attrs.get("act") == "relu")
    at = (env[y] == 0).nonzero()[0].tolist()
    env[y] = env[y].clone()
    env[y][tuple(at)] = (1e-2 if far else 1e-6) * env[y].max()
    after = {n: scope.get(n) for n in scope.names()}
    worst, past, taken = chip_smoke.replay_held(tstatic, main, env, after,
                                                "cpu")
    assert taken == (1, 1)
    if far:
        assert [p[:3] for p in past] == [("batch_norm", y, "other side of 0"),
                                         ("batch_norm", y, "torch.float32")]
    else:
        assert not past, past


def _past(got, want, floors, tol):
    """{name: (share, floor)} of each of `want`'s names whose share is
    past max(tol, MARGIN x its floor)."""
    past = {}
    for n in want:
        share = chip_smoke.share(_tensor(got[n]), _tensor(want[n]))
        floor = floors.get(n, 0.0)
        if not share <= max(tol, MARGIN * floor):
            past[n] = (share, floor)
    return past


def test_small_resnet_fp32_trains_like_jax(jax_fp32_run):
    tm, _, tl, _ = _port_program(False)
    feed = _batch()
    texe = tstatic.Executor("cpu")
    for i, (seg, chained) in enumerate(zip(jax_fp32_run, CHAINED)):
        want, after = seg["losses"], seg["after"]
        tscope = scope_from_numpy(seg["start"], "cpu")
        got = _segment(texe, tm, tl, tscope, feed, chained)[0]
        got_after = scope_to_numpy(tscope)
        assert got.shape == want.shape == (2 if chained else 1,)
        assert sorted(got_after) == sorted(after)
        loss_err = np.abs(got - want) / np.abs(want)
        assert np.all(loss_err <= np.maximum(
            LOSS_TOL, MARGIN * seg["loss_floor"])), (
            i, got, want, seg["loss_floor"])
        stats = {n for n in after if n.startswith("bn_")}
        past = _past(got_after, {n: after[n] for n in stats}, seg["floors"],
                     SCOPE_TOL)
        assert not past, (i, past)
        past = _past(got_after, {n: after[n] for n in after
                                 if n not in stats}, {}, FLIP_TOL)
        assert not past, (i, past)


def test_small_resnet_amp_step_matches_jax(jax_amp_run):
    tm, _, tl, _ = _port_program(True)
    feed = _batch()
    texe = tstatic.Executor("cpu")
    names = [n for n, v in tm.global_block().vars.items()
             if not v.is_data and not v.persistable]
    for i, (seg, chained) in enumerate(zip(jax_amp_run, CHAINED)):
        tscope = tstatic.Scope()
        for n, v in seg["start"].items():
            tscope.set(n, v.clone())
        if chained:
            got = texe.run_chained(tm, feed=feed, fetch_list=[tl], n_steps=2,
                                   scope=tscope, return_numpy=False)[0]
        else:
            out = texe.run(tm, feed=feed, fetch_list=[tl] + names,
                           scope=tscope, return_numpy=False)
            got = out[0]
            for n, v in zip(names, out[1:]):
                assert v.dtype == seg["vals"][n].dtype, (i, n)
            assert {v.dtype for v in out[1:]} == {torch.bfloat16,
                                                  torch.float32}
        got = got.double().ravel().numpy()
        want = seg["losses"]
        assert np.all(np.isfinite(got)), (i, got)
        assert np.all(np.abs(got - want) <= np.maximum(
            AMP_LOSS_TOL, MARGIN * seg["loss_floor"]) * np.abs(want)), (
            i, got, want, seg["loss_floor"])
        for n, v in seg["after"].items():
            assert tscope.get(n).dtype == v.dtype, (i, n)


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_chained_run_equals_stepped_runs_bitwise(amp):
    tm, ts, tl, _ = _port_program(amp)
    feed = _batch()
    exe = tstatic.Executor("cpu")
    start = tstatic.Scope()
    exe.run(ts, scope=start)
    arrays = scope_to_numpy(start)
    stepped, chained = scope_from_numpy(arrays, "cpu"), scope_from_numpy(
        arrays, "cpu")
    losses = [exe.run(tm, feed=feed, fetch_list=[tl], scope=stepped)[0]
              for _ in range(2)]
    chain = exe.run_chained(tm, feed=feed, fetch_list=[tl], n_steps=2,
                            scope=chained)[0]
    assert np.array_equal(np.stack(losses), chain)
    a, b = scope_to_numpy(stepped), scope_to_numpy(chained)
    assert sorted(a) == sorted(b)
    for n in a:
        assert np.array_equal(a[n], b[n]), n


def test_cost_analysis_counts_a_training_step_and_leaves_the_scope():
    """FlopCounterMode over one block run: the forward's flops plus the
    backward's (about twice, less the image's own gradient), and no
    update written back."""
    tm, ts, tl, fwd = _port_program(False)
    feed = _batch()
    exe = tstatic.Executor("cpu")
    scope = tstatic.Scope()
    exe.run(ts, scope=scope)
    before = scope_to_numpy(scope)
    cost = exe.cost_analysis(tm, feed=feed, fetch_list=[tl], scope=scope)
    assert 2 * fwd * B < cost["flops"] <= 3 * fwd * B
    after = scope_to_numpy(scope)
    for n in before:
        assert np.array_equal(before[n], after[n]), n
