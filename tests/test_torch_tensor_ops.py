"""Port parity: the op library's creation, manipulation and math
functions (``paddle_tpu_torch.ops``, the ``tensor`` namespace and the
top-level names) against the JAX package's, on the same seeded numpy
inputs, both on the CPU.

Each op is one case of its family's test: integer and boolean results
equal, float32 ones within 1e-6 of the JAX tensor's largest magnitude,
and where JAX differentiates, the gradient of every float input under
one random cotangent within 1e-5.  `topk`, `sort` and `argsort` also
run on a row of equal values, where JAX's order (lower index first)
must hold.  Where the JAX op itself is off the exact value by more than
that (its float32 `lgamma`: 1.6e-6 relative on [0.2, 3]), the port is
held to the float64 value (scipy) within 1e-6 and to JAX within JAX's
own error plus 1e-6.  The random creation ops are held to their shapes, dtypes,
ranges and moments: their draws cannot equal JAX's.  Every JAX result
is computed once, at module scope, and shared by the cases."""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import paddle_tpu as paddle
import paddle_tpu.tensor as jtensor
import paddle_tpu_torch as ptorch
from paddle_tpu_torch import tensor as ptensor
from torch_op_parity import (CPU, FWD_TOL, case, hold, jax_traced, rand_f,
                             rand_i, run, share)

_x, _i = rand_f, rand_i


A, B = _x((3, 4), seed=1), _x((3, 4), seed=2)
POS = _x((3, 4), 0.2, 3.0, seed=3)
UNIT = _x((3, 4), -0.9, 0.9, seed=4)
BIG = _x((3, 4), 1.2, 3.0, seed=5)
M3 = _x((2, 3, 4), seed=6)
IDX = np.array([2, 0, 1, 2], np.int64)


CREATION = {
    "full": case("full", [2, 3], 1.5, pkw=CPU),
    "full_int": case("full", [2, 3], 7, pkw=CPU),
    "fill_constant": case("fill_constant", [3], 2.0, pkw=CPU),
    "zeros": case("zeros", [2, 3], pkw=CPU),
    "ones": case("ones", [2, 3], "int64", pkw=CPU),
    "empty": case("empty", [2, 2], pkw=CPU),
    "zeros_like": case("zeros_like", A),
    "ones_like": case("ones_like", A),
    "empty_like": case("empty_like", A),
    "full_like": case("full_like", A, 3.25),
    "arange_int": case("arange", 2, 11, 3, pkw=CPU),
    "arange_float": case("arange", 0.5, 3.0, 0.25, pkw=CPU),
    "linspace": case("linspace", -1.0, 2.0, 7, pkw=CPU),
    "eye": case("eye", 3, 5, pkw=CPU),
    "diag_vector": case("diag", A[0], offset=1, padding_value=9),
    "diag_matrix": case("diag", A, offset=-1),
    "tril": case("tril", A, 1),
    "triu": case("triu", A, -1),
    "meshgrid": case("meshgrid", A[0], B[1, :3]),
    "assign": case("assign", A),
    "clone": case("clone", A),
}

MANIPULATION = {
    "cast": case("cast", A, "int32", nograd=True),
    "reshape": case("reshape", M3, [0, -1, 2]),
    "transpose": case("transpose", M3, [2, 0, 1]),
    "squeeze": case("squeeze", _x((3, 1, 4, 1)), axis=[1, 2]),
    "squeeze_all": case("squeeze", _x((3, 1, 4, 1))),
    "unsqueeze": case("unsqueeze", A, [0, -1]),
    "flatten": case("flatten", M3, 1, 2),
    "concat": case("concat", [A, B, POS], axis=1),
    "stack": case("stack", [A, B], axis=-1),
    "split": case("split", M3, [1, -1, 1], axis=2),
    "chunk": case("chunk", M3, 2, axis=2),
    "unbind": case("unbind", M3, 1),
    "unstack": case("unstack", M3, 2),
    "slice": case("slice", M3, [1, 2], [1, -3], [3, 10]),
    "strided_slice": case("strided_slice", M3, [1, 2], [0, 3], [3, 0],
                          [2, -2]),
    "getitem": case("getitem", M3, (slice(None), 1)),
    "tile": case("tile", A, [2, 1, 3]),
    "expand": case("expand", A[:1], [2, -1, 4]),
    "expand_as": case("expand_as", A[:1], M3[:, :1]),
    "broadcast_to": case("broadcast_to", A[:, :1], [3, 4]),
    "broadcast_tensors": case("broadcast_tensors", [A[:1], A[:, :1]]),
    "flip": case("flip", M3, [0, 2]),
    "roll": case("roll", M3, 2, axis=2),
    "roll_flat": case("roll", A, -5),
    "gather": case("gather", A, IDX, axis=1),
    "gather_col": case("gather", A, IDX[:3].reshape(3, 1)),
    "gather_nd": case("gather_nd", M3, np.array([[1, 2], [0, 0]])),
    "index_select": case("index_select", A, IDX[:2], axis=0),
    "index_sample": case("index_sample", A, _i((3, 2), 4)),
    "take_along_axis": case("take_along_axis", A, _i((3, 2), 4), 1),
    "scatter": case("scatter", A, np.array([2, 0]), B[:2]),
    "scatter_add": case("scatter", A, np.array([2, 0, 2]), B,
                        overwrite=False),
    "scatter_nd_add": case("scatter_nd_add", A, np.array([[0, 1], [2, 3],
                                                          [0, 1]]),
                           B[0, :3]),
    "put_along_axis": case("put_along_axis", A, _i((3, 1), 4), B[:, :1], 1),
    "put_along_axis_add": case("put_along_axis", A, _i((3, 2), 4), 0.5, 1,
                               reduce="add"),
    "pad_constant": case("pad", _x((2, 2, 3, 4)), [1, 2, 0, 1], value=0.5),
    "pad_all_axes": case("pad", A, [1, 0, 2, 1]),
    "pad_reflect": case("pad", _x((2, 2, 3, 4)), [1, 2, 2, 1],
                        mode="reflect"),
    "pad_replicate": case("pad", _x((2, 3, 4)), [2, 1], mode="replicate",
                          data_format="NCL"),
    "pad_circular": case("pad", _x((2, 2, 3, 4)), [1, 1, 1, 0],
                         mode="circular"),
    "shard_index": case("shard_index", _i((5,), 20), 20, 4, 1),
    "one_hot": case("one_hot", _i((3, 2), 5), 5),
    "rot90": case("rot90", M3, 1, axes=(1, 2)),
    "moveaxis": case("moveaxis", M3, 0, 2),
    "swapaxes": case("swapaxes", M3, 0, 2),
    "repeat_interleave": case("repeat_interleave", A, 2, axis=1),
}

UNARY = {n: case(n, x, nograd=nograd) for n, x, nograd in [
    ("abs", A, False), ("exp", A, False), ("expm1", A, False),
    ("log", POS, False), ("log2", POS, False), ("log10", POS, False),
    ("log1p", POS, False), ("sqrt", POS, False), ("rsqrt", POS, False),
    ("square", A, False), ("sin", A, False), ("cos", A, False),
    ("tan", UNIT, False), ("asin", UNIT, False), ("acos", UNIT, False),
    ("atan", A, False), ("sinh", A, False), ("cosh", A, False),
    ("tanh", A, False), ("asinh", A, False), ("acosh", BIG, False),
    ("atanh", UNIT, False), ("floor", A, False), ("ceil", A, False),
    ("round", A * 2.5, False), ("trunc", A, False), ("sign", A, False),
    ("reciprocal", POS, False), ("neg", A, False), ("erf", A, False),
    ("erfinv", UNIT, False), ("lgamma", POS, False),
    ("digamma", POS, False), ("isnan", A, True), ("isinf", A, True),
    ("isfinite", A, True)]}
UNARY.update({
    "scale": case("scale", A, 2.5, bias=-1.0),
    "scale_before": case("scale", A, 2.5, bias=-1.0, bias_after_scale=False),
    "clip": case("clip", A, -0.5, 1.0),
    "clip_low": case("clip", A, min=0.25),
    "lerp": case("lerp", A, B, POS),
    "stanh": case("stanh", A),
})

INTS, POS_INTS = _i((3, 4), 9), _i((3, 4), 5, lo=1)
BINARY = {n: case(n, x, y, nograd=nograd) for n, x, y, nograd in [
    ("add", A, B, False), ("subtract", A, B, False),
    ("multiply", A, B, False), ("divide", A, POS, False),
    ("floor_divide", A * 3, POS, True), ("remainder", A * 3, POS, False),
    ("mod", A * 3, POS, False), ("floor_mod", A * 3, POS, False),
    ("pow", POS, B, False), ("maximum", A, B, False),
    ("minimum", A, B, False), ("fmax", A, B, False), ("fmin", A, B, False),
    ("atan2", A, B, False), ("elementwise_add", A, B, False),
    ("elementwise_sub", A, B, False), ("elementwise_mul", A, B, False),
    ("elementwise_div", A, POS, False)]}
BINARY.update({
    "add_scalar": case("add", A, 2.5),
    "multiply_scalar_first": case("multiply", 3, B),
    "add_int_scalar": case("add", INTS, 2),
    "add_int_float_scalar": case("add", INTS, 0.5),
    "divide_ints": case("divide", INTS, POS_INTS),
    "floor_divide_ints": case("floor_divide", INTS * 3, POS_INTS),
    "remainder_ints": case("remainder", INTS * 3, POS_INTS),
    "pow_int_scalar": case("pow", INTS, 2),
})

ROUNDED = np.round(A * 2) / 2        # ties in value for the comparisons
COMPARE = {n: case(n, x, y) for n, x, y in [
    ("equal", ROUNDED, np.round(B * 2) / 2),
    ("not_equal", ROUNDED, np.round(B * 2) / 2),
    ("less_than", A, B), ("less_equal", ROUNDED, np.round(B * 2) / 2),
    ("greater_than", A, 0.0), ("greater_equal", A, B),
    ("logical_and", A > 0, B > 0), ("logical_or", A > 0, B > 0),
    ("logical_xor", A > 0, B > 0),
    ("bitwise_and", _i((3, 4), 16), _i((3, 4), 16, seed=1)),
    ("bitwise_or", _i((3, 4), 16), _i((3, 4), 16, seed=1)),
    ("bitwise_xor", _i((3, 4), 16), _i((3, 4), 16, seed=1))]}
COMPARE.update({
    "logical_not": case("logical_not", A > 0),
    "bitwise_not": case("bitwise_not", _i((3, 4), 16)),
    "equal_all": case("equal_all", A, A.copy()),
    "equal_all_not": case("equal_all", A, B),
    "allclose": case("allclose", A, A + 1e-7),
    "isclose": case("isclose", A, np.where(A > 0, A, A + 1e-3)),
})

REDUCE = {}
for _name in ("sum", "mean", "max", "min", "prod", "amax", "amin",
              "logsumexp"):
    for _ax, _kd in ((None, False), (1, True), ([0, 2], False)):
        REDUCE[f"{_name}_{_ax}_{_kd}"] = case(_name, M3, axis=_ax,
                                              keepdim=_kd)
REDUCE.update({
    "sum_bool": case("sum", A > 0, axis=1),
    "sum_dtype": case("sum", A, dtype="float64", nograd=True),
    "all": case("all", A > -1.5, axis=1), "any": case("any", A > 1.5),
    "argmax": case("argmax", M3, axis=2), "argmax_flat": case("argmax", M3),
    "argmin": case("argmin", M3, axis=1, keepdim=True),
    "cumsum": case("cumsum", M3, axis=1), "cumsum_flat": case("cumsum", A),
    "cumprod": case("cumprod", M3, dim=2),
})

LINALG = {
    "matmul": case("matmul", M3, _x((4, 5), seed=7)),
    "matmul_t": case("matmul", M3, _x((2, 5, 4), seed=7),
                     transpose_y=True),
    "matmul_tx": case("matmul", A, _x((3, 2), seed=7), transpose_x=True),
    "mm": case("mm", A, _x((4, 2), seed=7)),
    "bmm": case("bmm", M3, _x((2, 4, 3), seed=7)),
    "dot": case("dot", A, B), "addmm": case("addmm", _x((3, 2)), A,
                                            _x((4, 2), seed=7),
                                            beta=0.5, alpha=2.0),
    "t": case("t", A), "outer": case("outer", A[0], B[1]),
    "inner": case("inner", A, B), "kron": case("kron", A[:2, :2], B[:2]),
    "mv": case("mv", A, B[0]),
    "norm": case("norm", M3), "norm_axis": case("norm", M3, p=3, axis=1,
                                                keepdim=True),
    "norm_fro": case("norm", A, p="fro", axis=[0, 1]),
    "norm_inf": case("norm", M3, p=float("inf"), axis=2),
    "norm_1": case("norm", A, p=1, axis=0),
    "dist": case("dist", A, B, p=2.0),
    "cross": case("cross", _x((3, 3)), _x((3, 3), seed=8)),
    "cross_axis": case("cross", _x((2, 3)), _x((2, 3), seed=8), axis=1),
}

TIES = np.array([[1.0, 3.0, 3.0, 0.5, 3.0, 0.5, 2.0],
                 [2.0, 2.0, 2.0, 2.0, 1.0, 1.0, 1.0]], np.float32)
SEARCH = {
    "where": case("where", A > 0, A, B),
    "where_scalar": case("where", A > 0, A, 0.0),
    "where_nonzero": case("where", A > 0),
    "nonzero": case("nonzero", A > 0),
    "nonzero_tuple": case("nonzero", A > 0, as_tuple=True),
    "masked_select": case("masked_select", A, A > 0),
    "masked_select_bcast": case("masked_select", A, (A > 0)[:1]),
    "topk": case("topk", M3, 2), "topk_axis": case("topk", M3, 2, axis=1),
    "topk_smallest": case("topk", M3, 3, largest=False),
    "argsort": case("argsort", M3, axis=1),
    "argsort_desc": case("argsort", M3, descending=True),
    "sort": case("sort", M3, axis=2), "sort_desc": case("sort", M3, axis=0,
                                                        descending=True),
    "topk_ties": case("topk", TIES, 4), "topk_ties_smallest": case(
        "topk", TIES, 3, largest=False),
    "argsort_ties": case("argsort", TIES),
    "argsort_ties_desc": case("argsort", TIES, descending=True),
    "sort_ties_desc": case("sort", TIES, descending=True),
    "unique": case("unique", np.round(A), return_index=True,
                   return_inverse=True, return_counts=True),
    "increment": case("increment", A[0, :1].copy(), 2.0, nograd=True),
    "numel_t": case("numel_t", M3),
}

FAMILIES = {"creation": CREATION, "manipulation": MANIPULATION,
            "unary": UNARY, "binary": BINARY, "compare": COMPARE,
            "reduce": REDUCE, "linalg": LINALG, "search": SEARCH}


# cases whose JAX op reads its values on the host (nonzero, the mask of
# masked_select, unique) or writes in place: run eagerly, one by one
EAGER = {("search", n) for n in ("where_nonzero", "nonzero", "nonzero_tuple",
                                 "masked_select", "masked_select_bcast",
                                 "unique", "increment", "numel_t")}


@pytest.fixture(scope="module")
def jax_results():
    """Every case's JAX outputs and gradients, computed once."""
    cases = [((fam, name), c) for fam, family in FAMILIES.items()
             for name, c in family.items()]
    out = jax_traced([(k, c) for k, c in cases if k not in EAGER])
    out.update({k: run(c, jax=True) for k, c in cases if k in EAGER})
    return out


# ops whose JAX float32 value strays from the exact one by more than
# FWD_TOL, with the exact (float64) function
EXACT = {("unary", "lgamma"): "gammaln"}


def _hold(fam, name, jax_results):
    want, want_g = jax_results[(fam, name)]
    c = FAMILIES[fam][name]
    tol = FWD_TOL
    if (fam, name) in EXACT:
        import scipy.special

        exact = getattr(scipy.special, EXACT[(fam, name)])(
            c["args"][0].astype(np.float64))
        got = run(c, jax=False)[0]
        assert share(got[0], exact) <= FWD_TOL, share(got[0], exact)
        tol = FWD_TOL + share(want[0], exact)
    hold(c, want, want_g, tol)


def _params(family):
    return pytest.mark.parametrize("name", list(FAMILIES[family]))


@_params("creation")
def test_creation_matches_jax(name, jax_results):
    _hold("creation", name, jax_results)


@_params("manipulation")
def test_manipulation_matches_jax(name, jax_results):
    _hold("manipulation", name, jax_results)


@_params("unary")
def test_unary_math_matches_jax(name, jax_results):
    _hold("unary", name, jax_results)


@_params("binary")
def test_binary_math_matches_jax(name, jax_results):
    _hold("binary", name, jax_results)


@_params("compare")
def test_comparisons_match_jax(name, jax_results):
    _hold("compare", name, jax_results)


@_params("reduce")
def test_reductions_match_jax(name, jax_results):
    _hold("reduce", name, jax_results)


@_params("linalg")
def test_linalg_matches_jax(name, jax_results):
    _hold("linalg", name, jax_results)


@_params("search")
def test_search_and_sort_match_jax(name, jax_results):
    """Among them the constructed ties: equal values in index order."""
    _hold("search", name, jax_results)


def test_topk_ties_take_the_lower_index_first():
    """The tie order itself, not only agreement with JAX: of three
    equal largest values the lower indices win, in order."""
    v, i = ptorch.topk(torch.from_numpy(TIES), 4)
    assert i.tolist() == [[1, 2, 4, 6], [0, 1, 2, 3]]
    assert v[0].tolist() == [3.0, 3.0, 3.0, 2.0]


RANDOM = {
    "uniform": (lambda: ptorch.uniform([4000], min=-2.0, max=3.0,
                                       **CPU, generator=_gen()),
                "float32", (-2.0, 3.0), 0.5, 25 / 12),
    "uniform_seed": (lambda: ptorch.uniform([4000], seed=7, **CPU),
                     "float32", (-1.0, 1.0), 0.0, 1 / 3),
    "rand": (lambda: ptorch.rand([4000], **CPU, generator=_gen()),
             "float32", (0.0, 1.0), 0.5, 1 / 12),
    "randn": (lambda: ptorch.randn([4000], **CPU, generator=_gen()),
              "float32", None, 0.0, 1.0),
    "normal": (lambda: ptorch.normal(1.5, 2.0, [4000], **CPU,
                                     generator=_gen()),
               "float32", None, 1.5, 4.0),
    "randint": (lambda: ptorch.randint(2, 9, [4000], **CPU,
                                       generator=_gen()),
                "int64", (2, 8), 5.0, 4.0),
    "randperm": (lambda: ptorch.randperm(50, **CPU, generator=_gen()),
                 "int64", (0, 49), 24.5, 212.5),
    "bernoulli": (lambda: ptorch.bernoulli(torch.full([4000], 0.3),
                                           generator=_gen()),
                  "float32", (0.0, 1.0), 0.3, 0.21),
}


def _gen():
    return torch.Generator().manual_seed(0)


@pytest.mark.parametrize("name", list(RANDOM))
def test_random_creation_shapes_dtypes_ranges_moments(name):
    """Against the JAX op's shape and dtype kind, the range, and the
    distribution's mean and variance (within 5 standard errors)."""
    make, dtype, rng, mean, var = RANDOM[name]
    out = make()
    jax_fn = {"uniform_seed": "uniform"}.get(name, name)
    jax_out = {"uniform": lambda: paddle.uniform([4000], min=-2.0, max=3.0),
               "rand": lambda: paddle.rand([4000]),
               "randn": lambda: paddle.randn([4000]),
               "normal": lambda: paddle.normal(1.5, 2.0, [4000]),
               "randint": lambda: paddle.randint(2, 9, [4000]),
               "randperm": lambda: paddle.randperm(50),
               "bernoulli": lambda: paddle.bernoulli(
                   paddle.to_tensor(np.full([4000], 0.3, np.float32)))
               }[jax_fn]()
    assert tuple(out.shape) == tuple(jax_out.shape)
    assert str(out.dtype) == f"torch.{dtype}"
    assert out.dtype.is_floating_point == (
        np.asarray(jax_out._data).dtype.kind == "f")
    v = out.double()
    if rng is not None:
        assert rng[0] <= float(v.min()) and float(v.max()) <= rng[1]
    n = v.numel()
    if name == "randperm":
        assert sorted(out.tolist()) == list(range(50))
    assert abs(float(v.mean()) - mean) < 5 * (var / n) ** 0.5
    assert abs(float(v.var()) - var) < 0.1 * var


def test_multinomial_draws_from_the_rows():
    """Without replacement each row's draws are distinct classes of
    positive probability; with it their frequencies follow the row."""
    p = torch.tensor([[0.0, 0.5, 0.5, 0.0], [0.1, 0.2, 0.3, 0.4]])
    out = ptorch.multinomial(p, 2, generator=_gen())
    assert out.shape == (2, 2) and out.dtype == torch.int64
    assert sorted(out[0].tolist()) == [1, 2] and len(set(out[1].tolist())) \
        == 2
    many = ptorch.multinomial(p[1:], 20000, replacement=True,
                              generator=_gen())
    freq = torch.bincount(many[0], minlength=4).double() / 20000
    assert torch.allclose(freq, p[1].double(), atol=0.02)
    jax_out = paddle.multinomial(paddle.to_tensor(p.numpy()), 2)
    assert list(jax_out.shape) == [2, 2]


# the JAX modules' own helpers and imports, not ops
HELPERS = {"Tensor", "apply_op", "eager_op", "convert_dtype", "to_tensor",
           "builtins_sum", "transpose_to_last", "transpose_from_last",
           "isnan_raw", "isinf_raw", "isfinite_raw"}
JAX_TENSOR_MODULES = ["creation", "logic", "manipulation", "math", "random",
                      "search", "stat"]


@pytest.mark.parametrize("module", JAX_TENSOR_MODULES)
def test_tensor_namespace_has_the_jax_names(module):
    """Each ``tensor`` submodule holds every name its JAX twin exports
    from the creation, math and manipulation modules, as the same
    function as ``ops``; names from ``ops/linalg_extra.py`` wait."""
    import paddle_tpu.ops.linalg_extra as jl

    jmod = getattr(jtensor, module)
    pmod = getattr(ptensor, module)
    names = [n for n in dir(jmod) if not n.startswith("_")
             and callable(getattr(jmod, n)) and n not in HELPERS
             and getattr(getattr(jmod, n), "__module__", "").startswith(
                 ("paddle_tpu.ops.creation", "paddle_tpu.ops.math",
                  "paddle_tpu.ops.manipulation", "paddle_tpu.core.registry"))
             and not hasattr(jl, n)]
    assert names
    missing = [n for n in names if not hasattr(pmod, n)]
    assert not missing, missing


def test_top_level_has_the_jax_op_names_and_to_tensor_defaults_to_the_card():
    """``paddle_tpu_torch.X`` for every public name of the JAX creation,
    math and manipulation modules; `to_tensor` and the creation
    functions without a tensor argument default to the card and raise
    without one, never making the tensor on the CPU."""
    import paddle_tpu.ops.creation as jc
    import paddle_tpu.ops.manipulation as jm
    import paddle_tpu.ops.math as jmath

    for mod in (jc, jm, jmath):
        names = [n for n in dir(mod) if not n.startswith("_")
                 and callable(getattr(mod, n)) and n not in HELPERS
                 and getattr(getattr(mod, n), "__module__", "") != "numpy"]
        missing = [n for n in names if not hasattr(ptorch, n)]
        assert not missing, (mod.__name__, missing)
    assert ptorch.to_tensor([1.5, 2], device="cpu").dtype == torch.float32
    if torch.cuda.is_available():
        assert ptorch.to_tensor([1]).device.type == "cuda"
        assert ptorch.zeros([2]).device.type == "cuda"
        return
    for make in (lambda: ptorch.to_tensor([1.0]), lambda: ptorch.zeros([2]),
                 lambda: ptorch.arange(3), lambda: ptorch.randn([2])):
        with pytest.raises(RuntimeError, match="needs CUDA"):
            make()


HOST_ONLY = {
    "concat": lambda a, b: ptorch.concat([a, b]),
    "stack": lambda a, b: ptorch.stack([a, b], axis=1),
    "exp": lambda a, b: ptorch.exp(a),
    "add": lambda a, b: ptorch.add(a, b),
    "equal": lambda a, b: ptorch.equal(a, b),
    "one_hot": lambda a, b: ptorch.one_hot((a > 0).astype(np.int64), 2),
}


@pytest.mark.parametrize("name", sorted(HOST_ONLY))
def test_host_data_alone_runs_on_the_card(name):
    """An op given only host data (numpy arrays) makes its tensors on the
    card, and without one raises rather than run on the CPU; beside a
    tensor, host data follows that tensor's device."""
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    if dev == "cuda":
        assert HOST_ONLY[name](A, B).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="needs CUDA"):
            HOST_ONLY[name](A, B)
    if name not in ("exp", "one_hot"):
        assert HOST_ONLY[name](A, torch.from_numpy(B).to(dev)).device.type \
            == dev


def test_where_host_data_follows_the_condition():
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    cond = torch.from_numpy(A > 0).to(dev)
    out = ptorch.where(cond, A, B)
    assert out.device.type == dev
    np.testing.assert_array_equal(out.cpu().numpy(), np.where(A > 0, A, B))
    assert ptorch.where(cond, 1.0, 0.0).dtype == torch.float32


AMP_CASES = [("bmm", "O1", (M3, _x((2, 4, 3), seed=7))),
             ("matmul", "O1", (M3, _x((4, 5), seed=7))),
             ("mm", "O2", (A, _x((4, 2), seed=7))),
             ("add", "O1", (A, B)), ("add", "O2", (A, B)),
             ("exp", "O2", (A,)), ("sum", "O2", (A,)),
             ("tanh", "O2", (A,))]


@pytest.mark.parametrize("fname,level,args", AMP_CASES,
                         ids=[f"{f}-{lv}" for f, lv, _ in AMP_CASES])
def test_amp_casts_as_the_jax_op(fname, level, args):
    """Under ``auto_cast`` each op casts its float32 inputs exactly where
    the JAX op is cast (O1: ``bmm`` and ``matmul_v2`` on the white list;
    O2: every op but the black list's ``exp`` and ``reduce_sum``): the
    output dtypes equal, the values within a bf16 rounding."""
    from paddle_tpu_torch import amp as pamp

    with paddle.amp.auto_cast(level=level):
        want = getattr(paddle, fname)(*[paddle.to_tensor(a) for a in args])
    with pamp.auto_cast(level=level):
        got = getattr(ptorch, fname)(*[torch.from_numpy(a) for a in args])
    assert str(got.dtype).replace("torch.", "") == str(want._data.dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want._data).astype(np.float32),
                               rtol=2e-2, atol=2e-2)
