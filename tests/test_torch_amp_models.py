"""Port parity: dygraph AMP (``paddle_tpu_torch.amp``) on whole models.

GPT (2 layers, hidden 64, 4 heads, L 64, ``use_flash=True``: the
JAX side runs its Pallas kernels in interpret mode, the port the plain
versions) and a 2-layer BERT, each through two O1 ``auto_cast`` +
``GradScaler`` + AdamW steps from the same weights and batch, against
the JAX package's eager AMP run.  The JAX run is taken in a subprocess
with ``--xla_allow_excess_precision=false`` (XLA otherwise keeps f32
between ops where torch rounds each to bf16), started as the module
starts.  The bounds are bf16's: `LOSS_RTOL` (the bf16 loss, one ulp is
2^-8 to 2^-7 relative), `GRAD_RTOL` (each step-1 gradient as
||port - JAX|| / ||JAX||), `UPDATE_RTOL` (all parameters' two-step
change likewise) and `SIGN_STEP` (any parameter entry: a near-zero
gradient whose bf16 sign differs moves AdamW's first steps by -lr
instead of +lr).  ``PYTHONPATH=. python tests/test_torch_amp_models.py``
prints the JAX package against itself, excess precision on and off, on
the same quantities (see the constants for both readings).  The ops
one by one and the scaler are in ``test_torch_amp.py``."""
import os
import subprocess
import sys

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as conftest sets)
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import paddle_tpu as paddle
from paddle_tpu_torch import amp as pamp
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.models import BertConfig, BertForPretraining
from paddle_tpu_torch.models import gpt as pgpt

GPT_CFG = dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
               max_seq_len=64, dropout=0.0)
BERT_CFG = dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
                ffn_hidden=128, max_seq_len=128, dropout=0.0)
B, L, BERT_L = 2, 64, 32
LR, STEPS = 1e-3, 2
# bf16 bounds (module docstring).  Port against the JAX run, excess
# precision off: losses 1 ulp apart (4.6e-3 GPT, 5.5e-3 BERT relative),
# step-1 gradients up to 1.2e-2 (GPT) and 3.9e-2 (BERT) relative, the
# two-step change 4.9e-2 and 8.1e-2, entries up to 4.0e-3 apart.  The
# JAX package against itself, excess precision on vs off: losses and
# GPT's gradients equal, BERT's gradients 0.62 apart on the key
# projection's bias (its gradient is 0 in exact arithmetic, softmax
# being blind to a per-row shift: both runs hold rounding noise, 3e-3
# of norm against gradients of 1-15), the change 4.0e-3 (GPT) and
# 4.2e-2 (BERT, those biases' Adam steps following the noise's signs),
# entries 1.3e-3 and 3.9e-3.  So a gradient is held relative to the
# larger of its own norm and GRAD_FLOOR of the largest one's.
LOSS_RTOL = 1e-2
GRAD_RTOL = 5e-2
GRAD_FLOOR = 1e-2
UPDATE_RTOL = 1e-1
SIGN_STEP = 2 * LR * STEPS * 1.05


def _gpt_batch():
    rng = np.random.default_rng(0)
    return (rng.integers(0, GPT_CFG["vocab_size"], (B, L)).astype(np.int32),
            rng.integers(0, GPT_CFG["vocab_size"], (B, L)).astype(np.int32))


def _bert_batch():
    rng = np.random.default_rng(1)
    v = BERT_CFG["vocab_size"]
    ids = rng.integers(0, v, (B, BERT_L)).astype(np.int32)
    mlm = rng.integers(0, v, (B, BERT_L)).astype(np.int32)
    mlm[:, ::5] = -100
    types = (np.arange(BERT_L) >= BERT_L // 2).astype(np.int32)[None]
    return ids, mlm, np.array([0, 1], np.int32), types.repeat(B, 0)


def _f32(a):
    return np.asarray(a).astype(np.float32)


def _jax_model(which):
    if which == "gpt":
        from paddle_tpu.models.gpt import GPTConfig, GPTForPretraining

        paddle.seed(3)
        return GPTForPretraining(GPTConfig(use_flash=True, **GPT_CFG))
    from paddle_tpu.models.bert import BertConfig as JaxConfig
    from paddle_tpu.models.bert import BertForPretraining as JaxBert

    paddle.seed(5)
    return JaxBert(JaxConfig(**BERT_CFG))


def _batch_of(which):
    return _gpt_batch() if which == "gpt" else _bert_batch()


def _jax_amp_reference(path, which):
    """The JAX package's two eager AMP steps of `which` ("gpt" or
    "bert"), written to `path` (npz): the initial weights, each step's
    loss and its dtype, the step-1 unscaled gradients, the final
    weights, the scale after each step."""
    jm = _jax_model(which)
    out = {f"init/{n}": _f32(p._data) for n, p in jm.named_parameters()}
    opt = paddle.optimizer.AdamW(learning_rate=LR,
                                 parameters=jm.parameters())
    scaler = paddle.amp.GradScaler()
    batch = [paddle.to_tensor(a) for a in _batch_of(which)]
    for step in range(STEPS):
        with paddle.amp.auto_cast():
            loss = jm.loss(*batch)
        out[f"loss/{step}"] = _f32(loss._data)
        out["loss_dtype"] = np.array(str(loss._data.dtype))
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        if step == 0:
            out.update({f"grad/{n}": _f32(p.grad._data)
                        for n, p in jm.named_parameters()})
        opt.clear_grad()
        out[f"scale/{step}"] = np.array(scaler._scale)
    out.update({f"final/{n}": _f32(p._data)
                for n, p in jm.named_parameters()})
    np.savez(path, **out)


def _start(path, which, excess_precision=False):
    tests = os.path.dirname(os.path.abspath(__file__))
    flags = os.environ.get("XLA_FLAGS", "")
    if not excess_precision:
        flags += " --xla_allow_excess_precision=false"
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=flags.strip())
    code = ("import sys, jax; jax.config.update('jax_platforms', 'cpu'); "
            "sys.path[:0] = sys.argv[1:3]; import torch_threads; "
            "import test_torch_amp_models as t; "
            "t._jax_amp_reference(sys.argv[3], sys.argv[4])")
    return subprocess.Popen([sys.executable, "-c", code,
                             os.path.dirname(tests), tests, str(path),
                             which], env=env)


def _load(path):
    data = np.load(path)
    run = {"init": {}, "grad": {}, "final": {}, "loss": [], "scale": []}
    for key in sorted(data.files):
        part, _, name = key.partition("/")
        if part in ("loss", "scale"):
            run[part].append(float(data[key]))
        elif part == "loss_dtype":
            run["loss_dtype"] = str(data[key])
        else:
            run[part][name] = data[key]
    return run


@pytest.fixture(scope="module", autouse=True)
def _jax_amp_processes(tmp_path_factory):
    """Both JAX references, started as the module starts (XLA reads its
    flags once per process, and this process's JAX is already up)."""
    base = tmp_path_factory.mktemp("jax_amp")
    procs = {w: (_start(base / f"{w}.npz", w), base / f"{w}.npz")
             for w in ("gpt", "bert")}
    yield procs
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def jax_runs(_jax_amp_processes):
    runs = {}
    for which, (proc, path) in _jax_amp_processes.items():
        assert proc.wait(timeout=600) == 0
        runs[which] = _load(path)
    return runs


def _port_model(which, init):
    if which == "gpt":
        return pgpt.GPTForPretraining.from_numpy_params(
            init, pgpt.GPTConfig(use_flash=True, **GPT_CFG), device="cpu")
    return BertForPretraining.from_numpy_params(init, BertConfig(**BERT_CFG),
                                                device="cpu")


def _port_run(which, init):
    """The port's two steps, as `_jax_amp_reference` takes them."""
    pm = _port_model(which, init)
    opt = popt.AdamW(learning_rate=LR, parameters=pm.parameters())
    scaler = pamp.GradScaler()
    batch = [torch.from_numpy(a).long() for a in _batch_of(which)]
    run = {"loss": [], "scale": [], "grad": {}}
    for step in range(STEPS):
        with pamp.auto_cast():
            loss = pm.loss(*batch)
        run["loss"].append(float(loss.detach().float()))
        run["loss_dtype"] = loss.dtype
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        if step == 0:
            run["grad"] = {n: p.grad.numpy().copy()
                           for n, p in pm.named_parameters()}
            run["grad_dtypes"] = {p.grad.dtype for p in pm.parameters()}
        opt.clear_grad()
        run["scale"].append(scaler._scale)
    run["final"] = {n: p.detach().numpy() for n, p in pm.named_parameters()}
    return run


def _rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def compare(a, b):
    """The quantities the bounds hold, run `a` against run `b`."""
    names = sorted(b["final"])
    ga = np.concatenate([a["final"][n].ravel() - b["init"][n].ravel()
                         for n in names])
    gb = np.concatenate([b["final"][n].ravel() - b["init"][n].ravel()
                         for n in names])
    return {"loss": max(abs(x - y) / abs(y) for x, y in zip(a["loss"],
                                                             b["loss"])),
            "grad": max(_rel(a["grad"][n], b["grad"][n]) for n in names),
            "update": _rel(ga, gb),
            "entry": max(float(np.abs(a["final"][n] - b["final"][n]).max())
                         for n in names)}


@pytest.fixture(scope="module", params=["gpt", "bert"])
def amp_pair(request, jax_runs):
    want = jax_runs[request.param]
    got = _port_run(request.param, want["init"])
    got["init"] = want["init"]
    return request.param, got, want


def test_model_amp_losses_match_jax(amp_pair):
    _, got, want = amp_pair
    assert want["loss_dtype"] == "bfloat16"
    assert got["loss_dtype"] == torch.bfloat16
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    assert got["scale"] == want["scale"]


def test_model_amp_gradients_match_jax(amp_pair):
    """Step 1's unscaled gradients, float32 on every float32 parameter."""
    _, got, want = amp_pair
    assert got["grad_dtypes"] == {torch.float32}
    assert set(got["grad"]) == set(want["grad"])
    floor = GRAD_FLOOR * max(np.linalg.norm(g) for g in want["grad"].values())
    worst = {n: float(np.linalg.norm(got["grad"][n] - g)
                      / max(np.linalg.norm(g), floor))
             for n, g in want["grad"].items()}
    assert max(worst.values()) <= GRAD_RTOL, worst


def test_model_amp_parameters_match_jax(amp_pair):
    _, got, want = amp_pair
    diffs = compare(got, want)
    assert diffs["update"] <= UPDATE_RTOL, diffs
    assert diffs["entry"] <= SIGN_STEP, diffs


if __name__ == "__main__":
    # the JAX package against itself, excess precision on vs off: the
    # spread each bound above must clear
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        for which in ("gpt", "bert"):
            paths = {}
            for on in (False, True):
                paths[on] = os.path.join(d, f"{which}_{on}.npz")
                assert _start(paths[on], which, on).wait() == 0
            off, on = _load(paths[False]), _load(paths[True])
            print(which, "excess precision on vs off:", compare(on, off),
                  "losses", on["loss"], off["loss"])
