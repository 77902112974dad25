"""Port parity: the loss, norm and metric long tail (``ops.loss_extra``)
against the JAX package's on the same seeded numpy inputs, both on the
CPU.  Each function is one case of ``torch_op_parity``: float outputs
within 1e-5 of the JAX tensor's largest magnitude, integer ones and the
host metric ops' outputs equal, the gradient of every float input under
one seeded cotangent within 1e-5.  The JAX results come from one jitted
forward and gradient at module scope, but for the cases whose JAX
function reads a float input on the host (run eagerly).  The JAX golden
tests of ``tests/test_loss_extra.py`` have counterparts here."""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401

import paddle_tpu as paddle
import paddle_tpu_torch as ptorch
from paddle_tpu.ops import loss_extra as JL
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.ops import loss_extra as PL
from torch_op_parity import case, hold, jax_traced, rand_f, rand_i, run

TOL = 1e-5
X = rand_f((4, 5), seed=1)
Y = rand_f((4, 5), seed=2)
TAGS_IN = np.array([[0, 1, 2, 0, 1, 3, 2, 2], [2, 0, 0, 1, 4, 2, 0, 1],
                    [1, 1, 0, 2, 3, 3, 2, 0]])
TAGS_LAB = np.array([[0, 1, 2, 2, 1, 3, 2, 2], [2, 0, 1, 1, 4, 2, 0, 0],
                     [0, 1, 0, 2, 3, 2, 2, 0]])

LOSSES = {
    "huber_loss": case("huber_loss", X, Y),
    "huber_loss_delta": case("huber_loss", X, Y, delta=0.5),
    "rank_loss": case("rank_loss", rand_f((4, 1), 0, 1, seed=3),
                      rand_f((4, 1), seed=4), rand_f((4, 1), seed=5)),
    "bpr_loss": case("bpr_loss", X, rand_i((4, 1), 5, seed=6)),
    "modified_huber_loss": case("modified_huber_loss",
                                rand_f((6,), -3, 3, seed=7),
                                rand_i((6,), 2, seed=8).astype(np.float32)),
    "teacher_student_sigmoid_loss": case(
        "teacher_student_sigmoid_loss", rand_f((8,), -20, 20, seed=9),
        np.array([-2.0, -1.5, -0.5, -0.2, 0.3, 0.9, 1.2, 1.9], np.float32)),
    "teacher_student_bounds": case(
        "teacher_student_sigmoid_loss", rand_f((4,), -3, 3, seed=10),
        np.array([-2.0, -0.5, 0.4, 1.6], np.float32),
        soft_max_up_bound=1.0, soft_max_lower_bound=-2.0),
    "squared_l2_distance": case("squared_l2_distance", X, Y),
    "squared_l2_distance_3d": case("squared_l2_distance",
                                   rand_f((3, 2, 4), seed=11),
                                   rand_f((3, 2, 4), seed=12)),
    "squared_l2_norm": case("squared_l2_norm", X),
    "l1_norm": case("l1_norm", X),
    "clip_by_norm": case("clip_by_norm", X, 1.0),
    "clip_by_norm_unclipped": case("clip_by_norm", X, 100.0),
    "cos_sim": case("cos_sim", X, Y),
    "mean_iou": case("mean_iou", rand_i((20,), 4, seed=13),
                     rand_i((20,), 4, seed=14), 4),
    "mean_iou_dropped": case("mean_iou", np.array([0, 5, 1, 3, 3]),
                             np.array([0, 5, 2, 3, 6]), 4),
    "edit_distance": case("edit_distance", rand_i((3, 6), 4, seed=15),
                          rand_i((3, 5), 4, seed=16),
                          input_length=np.array([6, 3, 0]),
                          label_length=np.array([5, 4, 2])),
    "edit_distance_raw": case("edit_distance", rand_i((2, 4), 3, seed=17),
                              rand_i((2, 4), 3, seed=18), normalized=False),
    "ctc_align": case("ctc_align", np.array([[1, 1, 0, 2, 2, 0, 3],
                                             [0, 4, 4, 4, 0, 0, 4]])),
    "ctc_align_no_merge": case("ctc_align", np.array([[1, 1, 0, 2, 2, 3]]),
                               blank=2, merge_repeated=False,
                               padding_value=-1,
                               input_length=np.array([5])),
    **{f"chunk_eval_{scheme}": case(
        "chunk_eval", TAGS_IN, TAGS_LAB, chunk_scheme=scheme,
        num_chunk_types=types, seq_length=np.array([8, 6, 7]))
       for scheme, types in (("IOB", 2), ("IOE", 2), ("IOBES", 1),
                             ("plain", 3))},
    "chunk_eval_excluded": case("chunk_eval", TAGS_IN, TAGS_LAB,
                                chunk_scheme="IOB", num_chunk_types=2,
                                excluded_chunk_types=[1]),
    "chunk_eval_1d": case("chunk_eval", TAGS_IN[0], TAGS_LAB[0],
                          chunk_scheme="IOB", num_chunk_types=2),
    "positive_negative_pair": case(
        "positive_negative_pair", np.array([3.0, 1.0, 2.0, 2.0, 0.5, 1.5],
                                           np.float32),
        np.array([1.0, 0.0, 2.0, 1.0, 0.0, 1.0], np.float32),
        np.array([0, 0, 0, 1, 1, 1]), nograd=True),
    "center_loss": case("center_loss", X, np.array([0, 2, 0, 1]),
                        rand_f((3, 5), seed=19), alpha=0.3),
    "center_loss_frozen": case("center_loss", X, np.array([0, 2, 0, 1]),
                               rand_f((3, 5), seed=19),
                               update_centers=False),
}
# the cases whose JAX function reads its inputs on the host (the metric
# ops and center_loss's update) run eagerly
EAGER = {k for k in LOSSES if k.startswith((
    "edit_distance", "ctc_align", "chunk_eval", "positive_negative_pair",
    "center_loss"))}


@pytest.fixture(scope="module")
def jax_results():
    out = jax_traced([(k, c) for k, c in LOSSES.items() if k not in EAGER])
    out.update({k: run(LOSSES[k], jax=True) for k in EAGER})
    return out


@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_extra_matches_jax(name, jax_results):
    hold(LOSSES[name], *jax_results[name], fwd_tol=TOL)


def test_the_module_has_the_jax_names():
    assert sorted(PL.__all__) == sorted(JL.__all__)
    for name in JL.__all__:
        assert hasattr(ptorch, name) and hasattr(ptorch.ops, name), name


def _np(t):
    return t.detach().cpu().numpy()


def test_huber_loss_values_and_grad_golden():
    x = torch.tensor([0.0, 1.0, 4.0], requires_grad=True)
    out = ptorch.huber_loss(x, torch.tensor([0.5, 0.0, 0.0]), delta=1.0)
    r = np.array([0.5, -1.0, -4.0], np.float32)
    np.testing.assert_allclose(_np(out), np.where(np.abs(r) <= 1.0,
                                                  0.5 * r * r,
                                                  np.abs(r) - 0.5), rtol=1e-6)
    out.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [-0.5, 1.0, 1.0], rtol=1e-6)


def test_rank_bpr_modified_huber_teacher_student_golden():
    out = ptorch.rank_loss(torch.tensor([1.0, 0.0]), torch.tensor([2.0, 0.5]),
                           torch.tensor([1.0, 1.5]))
    o = np.array([1.0, -1.0])
    np.testing.assert_allclose(_np(out), np.log1p(np.exp(o))
                               - np.array([1.0, 0.0]) * o, rtol=1e-6)
    x = np.array([[2.0, 1.0, 0.0], [0.0, 1.0, 3.0]], np.float32)
    lbl = np.array([0, 2])
    want = [[sum(np.log1p(np.exp(x[i, j] - x[i, lbl[i]]))
                 for j in range(3) if j != lbl[i]) / 2] for i in range(2)]
    np.testing.assert_allclose(_np(ptorch.bpr_loss(torch.from_numpy(x),
                                                   torch.from_numpy(lbl))),
                               want, rtol=1e-5)
    np.testing.assert_allclose(_np(ptorch.modified_huber_loss(
        torch.tensor([-2.0, 0.5, 2.0]), torch.ones(3))), [8.0, 0.25, 0.0],
        rtol=1e-6)
    x = np.array([0.3, -0.7, 1.2, 0.4], np.float32)
    sp = np.log1p(np.exp(x))
    np.testing.assert_allclose(_np(ptorch.teacher_student_sigmoid_loss(
        torch.from_numpy(x), torch.tensor([-2.0, -1.0, 0.6, 1.4]))),
        [sp[0], sp[1] - x[1], 2 * sp[2] - x[2] * 0.6,
         2 * sp[3] - x[3] - x[3] * 0.4], rtol=1e-5)


def test_center_loss_updates_centers_golden():
    centers = torch.zeros(3, 2)
    loss, c_out = ptorch.center_loss(torch.tensor([[1.0, 0.0], [0.0, 1.0]]),
                                     torch.tensor([0, 0]), centers, alpha=0.5)
    np.testing.assert_allclose(_np(loss).reshape(-1), [0.5, 0.5], rtol=1e-6)
    np.testing.assert_allclose(_np(c_out)[0], [1.0 / 6, 1.0 / 6], rtol=1e-5)
    np.testing.assert_allclose(_np(c_out)[1:], 0.0)
    assert not centers.any() and not c_out.requires_grad


def test_norm_family_golden():
    t = torch.tensor([[3.0, 4.0]])
    np.testing.assert_allclose(_np(ptorch.squared_l2_norm(t)), [25.0])
    np.testing.assert_allclose(_np(ptorch.l1_norm(t)), [7.0])
    np.testing.assert_allclose(_np(ptorch.clip_by_norm(t, 1.0)),
                               [[0.6, 0.8]], rtol=1e-6)
    np.testing.assert_allclose(_np(ptorch.clip_by_norm(t, 10.0)), _np(t))
    y = torch.tensor([[1.0, 0.0]])
    np.testing.assert_allclose(_np(ptorch.cos_sim(t, y)), [[0.6]], rtol=1e-6)
    np.testing.assert_allclose(_np(ptorch.squared_l2_distance(t, y)), [20.0],
                               rtol=1e-6)


def test_mean_iou_golden():
    miou, wrong, correct = ptorch.mean_iou(torch.tensor([0, 1, 1, 2]),
                                           torch.tensor([0, 1, 2, 2]), 3)
    np.testing.assert_allclose(float(miou), (1 + 0.5 + 0.5) / 3, rtol=1e-6)
    np.testing.assert_array_equal(_np(correct), [1, 1, 1])
    np.testing.assert_array_equal(_np(wrong), [0, 1, 0])


def test_edit_distance_ctc_align_pairs_golden():
    inp, lbl = torch.tensor([[1, 2, 3, 0]]), torch.tensor([[1, 3, 3, 0]])
    d, n = ptorch.edit_distance(inp, lbl, input_length=np.array([3]),
                                label_length=np.array([3]), normalized=False)
    np.testing.assert_allclose(_np(d), [[1.0]])
    assert int(n[0]) == 1
    d2, _ = ptorch.edit_distance(inp, lbl, input_length=np.array([3]),
                                 label_length=np.array([3]))
    np.testing.assert_allclose(_np(d2), [[1.0 / 3]], rtol=1e-6)
    out, lens = ptorch.ctc_align(torch.tensor([[1, 1, 0, 2, 2, 0, 3]],
                                              dtype=torch.int32), blank=0)
    np.testing.assert_array_equal(_np(out)[0, :3], [1, 2, 3])
    assert int(lens[0, 0]) == 3
    p, n, u = ptorch.positive_negative_pair(torch.tensor([3.0, 1.0, 2.0]),
                                            torch.tensor([1.0, 0.0, 2.0]),
                                            torch.tensor([0, 0, 0]))
    assert (float(p[0]), float(n[0]), float(u[0])) == (2.0, 1.0, 0.0)


def test_chunk_eval_iob_golden():
    prec, rec, f1, ni, nl, nc = ptorch.chunk_eval(
        torch.tensor([[0, 1, 2, 0]]), torch.tensor([[0, 1, 2, 2]]),
        chunk_scheme="IOB", num_chunk_types=1)
    assert (int(ni[0]), int(nl[0]), int(nc[0])) == (2, 1, 1)
    np.testing.assert_allclose(float(prec[0]), 0.5)
    np.testing.assert_allclose(float(rec[0]), 1.0)
    np.testing.assert_allclose(float(f1[0]), 2 * 0.5 / 1.5, rtol=1e-6)
    assert ni.dtype == torch.int64 and prec.dtype == torch.float32


def test_cross_entropy_negative_ignore_index_golden():
    """``F.cross_entropy``'s default ignore_index -100: ignored rows add
    no loss and leave the mean's denominator, weighted too (the JAX
    golden test's oracle)."""
    logits_np = np.random.RandomState(0).rand(4, 5).astype(np.float32)
    logits = torch.from_numpy(logits_np)
    labels = torch.tensor([1, -100, 3, -100])
    lp = logits_np - np.log(np.exp(logits_np).sum(-1, keepdims=True))
    np.testing.assert_allclose(float(PF.cross_entropy(logits, labels)),
                               (-lp[0, 1] - lp[2, 3]) / 2, rtol=1e-5)
    per = _np(PF.cross_entropy(logits, labels, reduction="none")).reshape(-1)
    assert per[1] == 0.0 and per[3] == 0.0
    w = torch.tensor([1, 2, 1, 4, 1], dtype=torch.float32)
    np.testing.assert_allclose(
        float(PF.cross_entropy(logits, labels, weight=w)),
        (2 * -lp[0, 1] + 4 * -lp[2, 3]) / 6, rtol=1e-5)


def test_cross_entropy_mean_stays_a_tensor_under_a_transform():
    """The masked mean's denominator stays a tensor (JAX's counterpart
    traces it under ``jit``): the loss goes through ``torch.func.grad``,
    which refuses a read back to the host, and its gradient equals the
    eager one."""
    logits = torch.from_numpy(np.random.RandomState(0).rand(4, 5).astype(
        np.float32))
    labels = torch.tensor([1, -100, 3, 2])
    g = torch.func.grad(lambda lg: PF.cross_entropy(lg, labels))(logits)
    lg = logits.clone().requires_grad_()
    PF.cross_entropy(lg, labels).backward()
    np.testing.assert_allclose(g.numpy(), lg.grad.numpy(), rtol=1e-6)
    assert not g[1].any()
