"""Shared machinery of the port's op-parity tests
(``test_torch_tensor_ops.py``, ``test_torch_activation_loss.py``): a case
is one call of a function or layer both packages export under one name;
`run` runs it in one package on the CPU, eagerly, with the gradient of
every float input (and a layer's parameters) under seeded cotangents;
`jax_traced` runs many cases' JAX calls traced into one jitted forward
and one jitted gradient, instead of one compile per eager op; `hold`
compares a case's port run with its JAX results.  A layer case's JAX
layer is built once, its initializers drawing from numpy
(`jax_static_start.numpy_initializers`), and the port's layer carries
its state (``models.layer_from_numpy``)."""
import numpy as np
import torch
from jax_static_start import numpy_initializers

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as ptorch
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.models import layer_from_numpy
from paddle_tpu_torch.nn import functional as PF

FWD_TOL, GRAD_TOL = 1e-6, 1e-5
CPU = {"device": "cpu"}
NAMESPACES = {"top": (paddle, ptorch), "F": (JF, PF), "nn": (jnn, pnn)}


def rand_f(shape, lo=-2.0, hi=2.0, seed=0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def rand_i(shape, hi, seed=0, lo=0):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(
        np.int64)


def case(fname, *args, nograd=False, pkw=None, ns="top", ctor=(),
         ckw=None, pctor=None, setup=None, **kw):
    """One call: the name both packages export in namespace `ns` ("top",
    "F", or "nn" for a layer built with `ctor` and then called), its
    positional arguments (numpy arrays, lists of them, or python
    values), its keyword arguments (arrays among them become tensors,
    float ones differentiated after the positional ones), and the
    port-only ones (`pkw`; `pctor` for the port layer's constructor,
    which both packages' take `ckw` too).
    `setup(layer, package)` runs on each package's new layer (the JAX
    package's module, or the port's ``nn``) before its state is read."""
    return dict(fname=fname, args=args, kw=kw, pkw=pkw or {},
                nograd=nograd, ns=ns, ctor=ctor, ckw=ckw or {},
                pctor=pctor or {},
                setup=setup)


def leaves(v):
    if isinstance(v, (list, tuple)):
        return [leaf for x in v for leaf in leaves(x)]
    return [v]


def convert(v, make):
    if isinstance(v, list) and v and isinstance(v[0], np.ndarray):
        return [make(x) for x in v]
    if isinstance(v, np.ndarray):
        return make(v)
    return v


def is_float(a):
    return isinstance(a, np.ndarray) and a.dtype == np.float32


def jax_layer(c):
    """The case's JAX layer, built once (its state kept as it was built,
    for the port's layer to carry)."""
    if "layer" not in c:
        with numpy_initializers(len(c["fname"])):
            layer = getattr(jnn, c["fname"])(*c["ctor"], **c["ckw"])
            if c["setup"] is not None:
                c["setup"](layer, paddle.nn)
        c["layer"] = layer
        c["state"] = {n: np.asarray(t._data)
                      for n, t in layer.state_dict().items()}
    return c["layer"]


def _callable(c, jax):
    ns = NAMESPACES[c["ns"]][0 if jax else 1]
    fn = getattr(ns, c["fname"])
    if c["ns"] != "nn":
        return fn
    if jax:
        return jax_layer(c)
    jax_layer(c)
    layer = fn(*c["ctor"], **c["ckw"], **c["pctor"])
    if c["setup"] is not None:
        c["setup"](layer, pnn)
    if c["state"]:
        layer_from_numpy(layer, c["state"], device="cpu")
    return layer


def cotangents(vals):
    """One seeded standard-normal cotangent per float32 output (arrays or
    their shapes and dtypes)."""
    return [np.random.default_rng(k).standard_normal(v.shape).astype(
        np.float32) for k, v in enumerate(
        [v for v in vals if v.dtype == np.float32])]


def run(c, jax):
    """Outputs and gradients (the float inputs', then a layer's
    parameters') of one case in one package, eagerly."""
    inputs = []

    def make(a):
        if jax:
            t = paddle.to_tensor(a, stop_gradient=not is_float(a))
        else:
            t = torch.from_numpy(a.copy()).requires_grad_(is_float(a))
        if is_float(a):
            inputs.append(t)
        return t

    args = [convert(a, make) for a in c["args"]]
    kw = {k: convert(v, make) for k, v in c["kw"].items()}
    fn = _callable(c, jax)
    out = fn(*args, **kw, **({} if jax else c["pkw"]))
    outs = leaves(out)
    vals = [np.asarray(o._data) if jax else o.detach().numpy()
            for o in outs]
    params = list(fn.parameters()) if c["ns"] == "nn" else []
    for p in params:
        if jax:
            p.clear_grad()
    grads = None
    fouts = [o for o, v in zip(outs, vals) if v.dtype == np.float32]
    if (inputs or params) and fouts and not c["nograd"]:
        total = 0
        for o, cot in zip(fouts, cotangents(vals)):
            total = total + (paddle.sum(o * paddle.to_tensor(cot)) if jax
                             else (o * torch.from_numpy(cot)).sum())
        if not (total.stop_gradient if jax else not total.requires_grad):
            total.backward()
        grads = []
        for t in inputs + params:
            g = t.grad
            grads.append(np.zeros(tuple(t.shape), np.float32) if g is None
                         else np.asarray(g._data) if jax else g.numpy())
    return vals, grads


def _params(c):
    return list(jax_layer(c).parameters()) if c["ns"] == "nn" else []


def with_params(params, datas, fn):
    """`fn()` under ``no_grad`` with each JAX parameter's data swapped for
    the matching array of `datas` (traced ones, inside a jitted function
    that JAX differentiates itself), put back after."""
    saved = [p._data for p in params]
    try:
        for p, d in zip(params, datas):
            p._data = d
        with paddle.no_grad():
            return fn()
    finally:
        for p, d in zip(params, saved):
            p._data = d


def jax_traced(cases):
    """`run`'s JAX results for `cases` (pairs of a key and a case)
    through the JAX package's functions traced into one jitted forward
    and gradient: the same functions on the same values, a layer's
    parameters swapped for traced ones (a layer whose forward updates
    its state belongs in an eager `run`), each case's cotangents as
    `run` draws them."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.core.tensor import _wrap_data

    floats = [[np.asarray(a) for a in leaves(list(c["args"]) + list(
        c["kw"].values())) if is_float(a)]
        + [np.asarray(p._data) for p in _params(c)] for _, c in cases]

    def forward(inputs):
        outs = []
        with paddle.no_grad():
            for (_, c), fl in zip(cases, inputs):
                it = iter(fl)
                def make(v):
                    return _wrap_data(next(it)) if is_float(v) \
                        else paddle.to_tensor(v)

                args = [convert(a, make) for a in c["args"]]
                kw = {k: convert(v, make) for k, v in c["kw"].items()}
                params = _params(c)
                out = with_params(params, [next(it) for _ in params],
                                  lambda: _callable(c, True)(*args, **kw))
                outs.append([o._data for o in leaves(out)])
        return outs

    shapes = jax.eval_shape(forward, floats)
    cots = [cotangents(case_vals) for case_vals in shapes]
    wants_grad = [bool(fl) and bool(ct) and not c["nograd"]
                  for (_, c), fl, ct in zip(cases, floats, cots)]

    def loss(inputs):
        outs = forward(inputs)
        total = jnp.zeros((), jnp.float32)
        for case_outs, ct, want in zip(outs, cots, wants_grad):
            if want:
                fouts = [o for o in case_outs if o.dtype == jnp.float32]
                total = total + sum(jnp.sum(o * c)
                                    for o, c in zip(fouts, ct))
        return total, outs

    (_, vals), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        floats)
    vals = [[np.asarray(v) for v in case_vals] for case_vals in vals]
    return {key: (case_vals, [np.asarray(g) for g in case_grads]
                  if want else None)
            for (key, _), case_vals, case_grads, want in zip(
                cases, vals, grads, wants_grad)}


def share(got, want):
    """|got - want| at its largest over want's largest magnitude."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    if got.size == 0:
        return 0.0
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def hold(c, want, want_g, fwd_tol=FWD_TOL):
    """The port's run of `c` against JAX's outputs and gradients: float
    outputs within `fwd_tol` and gradients within GRAD_TOL of the JAX
    tensor's largest magnitude, integer and boolean ones equal.  Returns
    the port's outputs."""
    got, got_g = run(c, jax=False)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w.dtype.kind in "fc":
            assert g.dtype.kind in "fc", (g.dtype, w.dtype)
            assert share(g, w) <= fwd_tol, share(g, w)
        else:
            assert g.dtype.kind == w.dtype.kind or {
                g.dtype.kind, w.dtype.kind} <= set("iu"), (g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w)
    assert (got_g is None) == (want_g is None)
    for g, w in zip(got_g or [], want_g or []):
        assert share(g, w) <= GRAD_TOL, share(g, w)
    return got
