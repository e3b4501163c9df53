"""Sparse embedding gradients of the PyTorch/CUDA port against the JAX
reference (tests/test_selected_rows.py's 13 cases).

The reference's gradient is a SelectedRows (rows, value, height); the
port's is torch's sparse COO tensor, handled by
paddle_tpu_torch/core/selected_rows.py. Each case runs through both
packages from the same weights and ids, and the dense forms, the touched
rows and the updated tables must agree (f32, 1e-6).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as ref
import paddle_tpu.nn.functional as RF
from paddle_tpu import SelectedRows

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch.core import selected_rows as sr

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)


def _tables(vocab, dim, seed=0, **kw):
    """The reference's Embedding and the port's with the same table."""
    ref.seed(seed)
    r = ref.nn.Embedding(vocab, dim, **kw)
    p = pt.nn.Embedding(vocab, dim, device="cpu", **kw)
    with torch.no_grad():
        p.weight.copy_(torch.tensor(np.asarray(r.weight._val)))
    return r, p


def _np(t):
    if isinstance(t, torch.Tensor):
        return (t.to_dense() if t.is_sparse else t).detach().numpy()
    if isinstance(t, SelectedRows):
        return np.asarray(t.to_dense())
    return np.asarray(t._val if hasattr(t, "_val") else t)


def test_to_dense_and_merge():
    rows, value = [1, 3, 1], np.array([[1., 2.], [3., 4.], [5., 6.]],
                                      np.float32)
    want = SelectedRows(rows, value, height=5)
    got = sr.make(rows, torch.tensor(value), 5)
    np.testing.assert_array_equal(sr.to_dense(got).numpy(),
                                  np.asarray(want.to_dense()))
    merged = sr.merge(got)
    assert sr.rows(merged).tolist() == [1, 3] and sr.height(merged) == 5
    np.testing.assert_array_equal(sr.value(merged).numpy(),
                                  np.asarray(want.merge().value))


def test_add():
    a = sr.make([0], torch.ones(1, 2), 3)
    b = sr.make([2], torch.ones(1, 2) * 2, 3)
    want = (SelectedRows([0], np.ones((1, 2), np.float32), 3)
            + SelectedRows([2], np.ones((1, 2), np.float32) * 2, 3))
    got = sr.add(a, b)
    assert got.is_sparse and sr.rows(got).tolist() == [0, 2]
    np.testing.assert_array_equal(sr.to_dense(got).numpy(),
                                  np.asarray(want.to_dense()))
    np.testing.assert_array_equal(sr.add(a, torch.ones(3, 2)).numpy(),
                                  np.asarray(want.to_dense()) * 0 + 1
                                  + np.array([[1, 1], [0, 0], [0, 0]]))


def test_grad_is_sparse_and_matches_dense_and_reference():
    ids = np.array([[1, 2, 1], [7, 2, 0]], dtype=np.int64)
    r, p = _tables(10, 4, sparse=True)
    dense = pt.nn.Embedding(10, 4, device="cpu")
    dense.load_state_dict(p.state_dict())
    ref.sum(r(ref.to_tensor(ids)) ** 2).backward()
    (p(torch.tensor(ids)) ** 2).sum().backward()
    (dense(torch.tensor(ids)) ** 2).sum().backward()
    g = p.weight.grad
    assert g.is_sparse and sr.height(g) == 10
    assert sr.value(g).shape[0] == ids.size        # one row per id
    assert isinstance(r.weight.grad, SelectedRows)
    np.testing.assert_allclose(_np(g), _np(r.weight.grad), **TOL)
    np.testing.assert_allclose(_np(g), _np(dense.weight.grad), **TOL)
    assert not _np(g)[3].any()


@pytest.mark.parametrize("padding_idx", [0, -2])
def test_padding_idx_zero_row_and_grad(padding_idx):
    ids = np.array([[0, 2, 4]], dtype=np.int64)
    r, p = _tables(6, 4, padding_idx=padding_idx, sparse=True)
    out_r, out_p = r(ref.to_tensor(ids)), p(torch.tensor(ids))
    np.testing.assert_allclose(out_p.detach().numpy(), _np(out_r), **TOL)
    ref.sum(out_r).backward()
    out_p.sum().backward()
    pad = padding_idx % 6
    assert not _np(p.weight.grad)[pad].any()
    assert not p.weight.detach()[pad].any()
    np.testing.assert_allclose(_np(p.weight.grad), _np(r.weight.grad), **TOL)


def _train(P, emb, opt_cls, ids, steps, square=True, **kw):
    opt = opt_cls(parameters=emb.parameters(), **kw)
    for _ in range(steps):
        x = P.to_tensor(ids) if P is ref else torch.tensor(ids)
        out = emb(x)
        loss = (out * out) if square else out
        (ref.sum(loss) if P is ref else loss.sum()).backward()
        opt.step()
        opt.clear_grad()
    return _np(emb.weight)


def test_sgd_sparse_update_matches_dense_and_reference():
    ids = np.array([1, 3, 3], dtype=np.int64)
    r, p = _tables(8, 4, sparse=True)
    _, d = _tables(8, 4)
    want = _train(ref, r, ref.optimizer.SGD, ids, 3, learning_rate=0.5)
    got = _train(pt, p, pt.optimizer.SGD, ids, 3, learning_rate=0.5)
    dense = _train(pt, d, pt.optimizer.SGD, ids, 3, learning_rate=0.5)
    np.testing.assert_allclose(got, dense, **TOL)
    np.testing.assert_allclose(got, want, **TOL)


def test_adam_lazy_mode_touches_only_rows():
    ids = np.array([2, 5], dtype=np.int64)
    r, p = _tables(8, 4, sparse=True)
    w0 = _np(p.weight).copy()
    want = _train(ref, r, ref.optimizer.Adam, ids, 2, learning_rate=0.1,
                  lazy_mode=True)
    got = _train(pt, p, pt.optimizer.Adam, ids, 2, learning_rate=0.1,
                 lazy_mode=True)
    changed = np.abs(got - w0).sum(axis=1) > 0
    assert changed[2] and changed[5]
    assert not changed[[0, 1, 3, 4, 6, 7]].any()
    np.testing.assert_allclose(got, want, **TOL)


def test_adam_non_lazy_dense_fallback():
    ids = np.array([0, 1], dtype=np.int64)
    r, p = _tables(4, 2, sparse=True)
    _, d = _tables(4, 2)
    kw = dict(learning_rate=0.05, square=False)
    want = _train(ref, r, ref.optimizer.Adam, ids, 2, **kw)
    got = _train(pt, p, pt.optimizer.Adam, ids, 2, **kw)
    dense = _train(pt, d, pt.optimizer.Adam, ids, 2, **kw)
    np.testing.assert_allclose(got, dense, **TOL)
    np.testing.assert_allclose(got, want, **TOL)


def test_grad_accumulation_without_clear():
    r, p = _tables(6, 2, sparse=True)
    for _ in range(2):
        ref.sum(r(ref.to_tensor(np.array([1], np.int64)))).backward()
        p(torch.tensor([1])).sum().backward()
    g = p.weight.grad
    assert g.is_sparse and sr.value(g).shape[0] == 2   # not merged
    np.testing.assert_allclose(_np(g)[1], [2.0, 2.0], **TOL)
    np.testing.assert_allclose(_np(g), _np(r.weight.grad), **TOL)


def test_to_static_falls_back_to_dense():
    r, p = _tables(8, 4, sparse=True)
    seen = []

    def steps(P, emb, opt, x, dense_check):
        @P.jit.to_static
        def step(x):
            loss = (emb(x) ** 2).sum()
            loss.backward()
            if dense_check:
                seen.append(emb.weight.grad.is_sparse)
            opt.step()
            opt.clear_grad()
            return loss
        return [float(step(x)) for _ in range(4)]

    want = steps(ref, r, ref.optimizer.SGD(learning_rate=0.1,
                                           parameters=r.parameters()),
                 ref.to_tensor(np.array([1, 2], np.int64)), False)
    got = steps(pt, p, pt.optimizer.SGD(learning_rate=0.1,
                                        parameters=p.parameters()),
                torch.tensor([1, 2]), True)
    assert seen and not any(seen)
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_functional_grad_of_sparse_embedding():
    """The reference's paddle.grad densifies; the port's functional grad
    (torch.autograd.grad) keeps the sparse gradient, whose dense form is
    the reference's."""
    a = np.random.RandomState(0).randn(6, 3).astype("float32")
    w = ref.to_tensor(a, stop_gradient=False)
    (want,) = ref.grad(RF.embedding(ref.to_tensor(np.array([1, 4])), w,
                                    sparse=True).sum(), w)
    wt = torch.tensor(a, requires_grad=True)
    (got,) = torch.autograd.grad(
        PF.embedding(torch.tensor([1, 4]), wt, sparse=True).sum(), wt)
    assert got.is_sparse
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_non_leaf_weight_falls_back_dense():
    a = np.random.RandomState(0).randn(6, 3).astype("float32")
    w = torch.tensor(a, requires_grad=True)
    PF.embedding(torch.tensor([1, 4]), w * 2.0, sparse=True).sum().backward()
    rw = ref.to_tensor(a, stop_gradient=False)
    ref.sum(RF.embedding(ref.to_tensor(np.array([1, 4])), rw * 2.0,
                         sparse=True)).backward()
    assert not w.grad.is_sparse and not isinstance(rw.grad, SelectedRows)
    np.testing.assert_allclose(_np(w.grad), _np(rw.grad), **TOL)


def test_adamw_lazy_decays_touched_rows_only():
    r, p = _tables(6, 2, sparse=True)
    with torch.no_grad():
        p.weight.fill_(1.0)
    r.weight._value = jnp.ones((6, 2))
    ids = np.array([2], dtype=np.int64)
    for P, emb in ((ref, r), (pt, p)):
        opt = P.optimizer.AdamW(learning_rate=0.1, weight_decay=0.5,
                                lazy_mode=True, parameters=emb.parameters())
        x = P.to_tensor(ids) if P is ref else torch.tensor(ids)
        # a zero gradient on row 2 still decays that row
        out = emb(x)
        ((ref.sum(out) if P is ref else out.sum()) * 0.0).backward()
        opt.step()
    got = _np(p.weight)
    assert got[2, 0] < 1.0
    np.testing.assert_array_equal(got[[0, 1, 3, 4, 5]], 1.0)
    np.testing.assert_allclose(got, _np(r.weight), **TOL)


def test_clip_keeps_grad_sparse_and_scales():
    ids = np.array([1, 5], dtype=np.int64)
    r, p = _tables(8, 4, sparse=True)
    w0 = _np(p.weight).copy()
    want = _train(ref, r, ref.optimizer.SGD, ids, 1, learning_rate=1.0,
                  grad_clip=ref.nn.ClipGradByGlobalNorm(0.01))
    got = _train(pt, p, pt.optimizer.SGD, ids, 1, learning_rate=1.0,
                 grad_clip=pt.nn.ClipGradByGlobalNorm(0.01))
    delta = got - w0
    assert not delta[[i for i in range(8) if i not in (1, 5)]].any()
    assert np.linalg.norm(delta) <= 0.01 + 1e-5
    np.testing.assert_allclose(got, want, **TOL)
