"""Port parity: sparse storage (``ndarray/sparse.py``), row-sparse
gradients, the sparse-gradient ``Embedding`` and the lazy SGD update,
against the JAX package on the CPU.

Mirrors the JAX package's ``tests/test_sparse.py`` case for case, each
case run through both packages on the same numpy inputs, less five of its
tests: the four KVStore tests (``row_sparse_pull`` and sparse pushes wait
for the multi-GPU item, ROADMAP.md queue 1, item 10, with the port's
kvstore) and ``test_parameter_grad_stype_row_sparse`` (``Parameter(
grad_stype=...)`` waits for ``gluon/parameter.py``'s surface, item 6).
Beyond it: ``dot`` held off the tape, the autograd rules for row-sparse
buffers and cotangents, a lazy SGD over 3 steps with momentum, weight
decay and clipping, the dense rules of ``Adam`` and ``lazy_update=False``
(each densifies on purpose), the trainer's fallback and stale-gradient
check, and the embedding's padding id and ids out of range.

Tolerance: ``ND_TOL`` (1e-5 relative, 1e-6 absolute) on values; indices
and integer results are equal bit for bit, with their dtypes. The port
holds a gluon parameter's row-sparse gradient as a coalesced sparse COO
``.grad``; ``RowSparseNDArray.from_torch`` reads it as the JAX package's
``RowSparseNDArray``.
"""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import optimizer as jopt
from incubator_mxnet_tpu.ndarray import sparse as jsparse

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import gluon, optimizer
from incubator_mxnet_tpu_torch.gluon.model_zoo import load_jax_params
from incubator_mxnet_tpu_torch.ndarray import sparse

ND_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with mx.cpu():
        yield


def _rand_dense_sparse_rows(shape=(6, 4), nz_rows=(1, 4), seed=0):
    rng = np.random.RandomState(seed)
    a = np.zeros(shape, np.float32)
    for r in nz_rows:
        a[r] = rng.randn(*shape[1:])
    return a


def _sparse_csr(seed, shape=(6, 8), cut=0.8):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    a[np.abs(a) < cut] = 0
    return a


def _same_rsp(got, want):
    """Row-sparse arrays equal: indices bit for bit (int32), values and
    the dense view within ND_TOL."""
    assert isinstance(got, sparse.RowSparseNDArray)
    assert isinstance(want, jsparse.RowSparseNDArray)
    assert got.shape == want.shape and got.nnz == want.nnz
    gi, wi = got.indices.asnumpy(), want.indices.asnumpy()
    assert gi.dtype == wi.dtype == np.int32
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(got.data.asnumpy(), want.data.asnumpy(),
                               **ND_TOL)
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **ND_TOL)


def _same_csr(got, want):
    assert isinstance(got, sparse.CSRNDArray)
    assert got.shape == want.shape and got.nnz == want.nnz
    for name in ("indices", "indptr"):
        g = getattr(got, name).asnumpy()
        w = getattr(want, name).asnumpy()
        assert g.dtype == w.dtype == np.int32, name
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got.data.asnumpy(), want.data.asnumpy(),
                               **ND_TOL)
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **ND_TOL)


# ---------------------------------------------------------------------------
# storage casts
# ---------------------------------------------------------------------------
def test_cast_storage_row_sparse_roundtrip():
    a = _rand_dense_sparse_rows()
    rsp = mx.nd.array(a).tostype("row_sparse")
    want = jmx.nd.array(a).tostype("row_sparse")
    assert rsp.stype == "row_sparse" and rsp.nnz == 2
    _same_rsp(rsp, want)
    back = rsp.tostype("default")
    assert back.stype == "default"
    np.testing.assert_array_equal(back.asnumpy(), a)
    _same_rsp(mx.nd.cast_storage(mx.nd.array(a), "row_sparse"), want)


def test_cast_storage_csr_roundtrip():
    a = _sparse_csr(1, (5, 7), 0.3)
    csr = mx.nd.array(a).tostype("csr")
    assert csr.stype == "csr" and csr.nnz == int((a != 0).sum())
    _same_csr(csr, jmx.nd.array(a).tostype("csr"))
    np.testing.assert_array_equal(csr.tostype("default").asnumpy(), a)
    with pytest.raises(ValueError):
        csr.tostype("row_sparse")


def test_row_sparse_array_constructor_sorts():
    data = np.array([[3.0, 3], [1, 1], [2, 2]], np.float32)
    rsp = sparse.row_sparse_array((data[:2], [3, 1]), shape=(5, 2))
    _same_rsp(rsp, jsparse.row_sparse_array((data[:2], [3, 1]),
                                            shape=(5, 2)))
    np.testing.assert_array_equal(rsp.indices.asnumpy(), [1, 3])
    # duplicates are sorted, not merged, as the reference's
    dup = sparse.row_sparse_array((data, [3, 1, 3]), shape=(5, 2))
    np.testing.assert_array_equal(dup.indices.asnumpy(), [1, 3, 3])
    np.testing.assert_array_equal(dup.data.asnumpy(), data[[1, 0, 2]])
    with pytest.raises(ValueError, match="shape required"):
        sparse.row_sparse_array((data, [0, 1, 2]))


def test_csr_matrix_constructor_and_slice():
    a = np.array([[1, 0, 2], [0, 0, 0], [0, 3, 0]], np.float32)
    csr = sparse.csr_matrix(a)
    want = jsparse.csr_matrix(a)
    _same_csr(csr, want)
    for key in (slice(1, 3), slice(0, 1), slice(None), slice(2, 2)):
        _same_csr(csr[key], want[key])
    with pytest.raises(ValueError, match="step 1"):
        csr[::2]
    with pytest.raises(TypeError):
        csr[1]
    parts = (a[a != 0], np.nonzero(a)[1], [0, 2, 2, 3])
    _same_csr(sparse.csr_matrix(parts, shape=(3, 3)),
              jsparse.csr_matrix(parts, shape=(3, 3)))


def test_sparse_zeros():
    z = sparse.zeros("row_sparse", (4, 3))
    assert z.nnz == 0 and z.indices.dtype == np.int32
    np.testing.assert_array_equal(z.asnumpy(), np.zeros((4, 3)))
    zc = sparse.zeros("csr", (4, 3))
    _same_csr(zc, jsparse.zeros("csr", (4, 3)))
    assert sparse.zeros("default", (2, 2)).stype == "default"


def test_retain():
    a = _rand_dense_sparse_rows(nz_rows=(0, 2, 5))
    kept = sparse.row_sparse_array(a).retain(mx.nd.array([0, 5]))
    want = jsparse.row_sparse_array(a).retain(jmx.nd.array([0, 5]))
    _same_rsp(kept, want)
    _same_rsp(sparse.retain(sparse.row_sparse_array(a), [2, 4]),
              jsparse.retain(jsparse.row_sparse_array(a), [2, 4]))


def test_rsp_add():
    a = _rand_dense_sparse_rows(nz_rows=(1, 3), seed=2)
    b = _rand_dense_sparse_rows(nz_rows=(3, 5), seed=3)
    out = sparse.add(sparse.row_sparse_array(a), sparse.row_sparse_array(b))
    want = jsparse.add(jsparse.row_sparse_array(a),
                       jsparse.row_sparse_array(b))
    assert out.stype == "row_sparse"
    _same_rsp(out, want)
    _same_rsp(sparse.elemwise_add(sparse.row_sparse_array(a),
                                  sparse.row_sparse_array(b)), want)
    _same_rsp(sparse.row_sparse_array(a) + sparse.row_sparse_array(b), want)
    # row_sparse + dense densifies
    d = sparse.row_sparse_array(a) + mx.nd.array(b)
    assert d.stype == "default"
    np.testing.assert_allclose(d.asnumpy(), a + b, **ND_TOL)
    d = sparse.add(mx.nd.array(a), sparse.csr_matrix(b))
    np.testing.assert_allclose(d.asnumpy(), a + b, **ND_TOL)


def test_sparse_names_match_the_reference():
    public = {n for n in dir(jsparse) if not n.startswith("_")
              and callable(getattr(jsparse, n))
              and getattr(getattr(jsparse, n), "__module__", "").endswith(
                  "sparse")}
    assert public <= set(dir(sparse)), public - set(dir(sparse))
    for name in ("sparse", "cast_storage", "BaseSparseNDArray",
                 "RowSparseNDArray", "CSRNDArray"):
        assert hasattr(mx.nd, name) and hasattr(jmx.nd, name), name
    assert mx.nd.sparse is sparse


# ---------------------------------------------------------------------------
# sparse dot
# ---------------------------------------------------------------------------
def test_csr_dot_dense_matches_oracle():
    a = _sparse_csr(0)
    b = np.random.RandomState(10).randn(8, 5).astype(np.float32)
    out = sparse.dot(sparse.csr_matrix(a), mx.nd.array(b))
    want = jsparse.dot(jsparse.csr_matrix(a), jmx.nd.array(b))
    assert out.shape == (6, 5)
    np.testing.assert_allclose(out.asnumpy(), want.asnumpy(), **ND_TOL)
    np.testing.assert_allclose(out.asnumpy(), a @ b, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sparse.csr_matrix(a).dot(b).asnumpy(),
                               want.asnumpy(), **ND_TOL)


def test_csr_dot_dense_transpose():
    a = _sparse_csr(1)
    b = np.random.RandomState(11).randn(6, 3).astype(np.float32)
    out = sparse.dot(sparse.csr_matrix(a), mx.nd.array(b), transpose_a=True)
    want = jsparse.dot(jsparse.csr_matrix(a), jmx.nd.array(b),
                       transpose_a=True)
    assert out.stype == "default" and out.shape == (8, 3)
    np.testing.assert_allclose(out.asnumpy(), want.asnumpy(), **ND_TOL)


def test_dot_of_row_sparse_and_dense_densifies():
    a = _rand_dense_sparse_rows(nz_rows=(0, 3))
    b = np.random.RandomState(12).randn(4, 2).astype(np.float32)
    out = sparse.dot(sparse.row_sparse_array(a), mx.nd.array(b))
    want = jsparse.dot(jsparse.row_sparse_array(a), jmx.nd.array(b))
    np.testing.assert_allclose(out.asnumpy(), want.asnumpy(), **ND_TOL)
    dense = sparse.dot(mx.nd.array(a), mx.nd.array(b))
    np.testing.assert_allclose(dense.asnumpy(), want.asnumpy(), **ND_TOL)
    with pytest.raises(ValueError, match="2-D dense rhs"):
        sparse.dot(sparse.csr_matrix(a), mx.nd.array(b[:, 0]))


def test_dot_stays_off_the_tape():
    """The reference builds dot's result outside ``invoke``: no tape node,
    so a head made of it alone cannot backpropagate."""
    a = _sparse_csr(2)
    b = np.random.RandomState(13).randn(8, 2).astype(np.float32)
    for pkg, sp in ((jmx, jsparse), (mx, sparse)):
        w = pkg.nd.array(b)
        w.attach_grad()
        with pkg.autograd.record():
            out = sp.dot(sp.csr_matrix(a), w)
        with pytest.raises(ValueError, match="not computed under"):
            out.backward()
    assert not out._data.requires_grad


# ---------------------------------------------------------------------------
# row-sparse gradients through autograd
# ---------------------------------------------------------------------------
def _rows_function(pkg, sp, rows, shape):
    """A custom op ``x -> x[rows]`` whose backward returns a row-sparse
    gradient."""

    class Rows(pkg.autograd.Function):
        def forward(self, x):
            return pkg.nd.array(x.asnumpy()[rows])

        def backward(self, dy):
            return sp.row_sparse_array((dy.asnumpy(), rows), shape=shape)

    return Rows()


@pytest.mark.parametrize("req", ["write", "add"])
@pytest.mark.parametrize("buffer", ["row_sparse", "default"])
def test_row_sparse_cotangents_into_buffers(req, buffer):
    """A row-sparse cotangent into a row-sparse buffer replaces
    (``write``) or merges (``add``); into a dense buffer it is scattered.
    Two backwards, so ``add`` shows the merge."""
    x0 = np.random.RandomState(20).randn(6, 3).astype(np.float32)
    gs = [np.random.RandomState(21 + i).randn(2, 3).astype(np.float32)
          for i in range(2)]
    results = []
    for pkg, sp in ((jmx, jsparse), (mx, sparse)):
        x = pkg.nd.array(x0)
        x.attach_grad(grad_req=req, stype=buffer)
        for rows, g in zip(([4, 1], [2, 4]), gs):
            f = _rows_function(pkg, sp, rows, x0.shape)
            with pkg.autograd.record():
                y = f(x)
            y.backward(pkg.nd.array(g))
        results.append(x.grad)
    want, got = results
    if buffer == "row_sparse":
        _same_rsp(got, want)
    else:
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **ND_TOL)


def test_dense_cotangent_into_a_row_sparse_buffer_is_cast():
    x0 = _rand_dense_sparse_rows(nz_rows=(0, 2, 5), seed=4)
    m = (np.arange(6) % 2 == 0).astype(np.float32)[:, None]
    results = []
    for pkg in (jmx, mx):
        x = pkg.nd.array(x0)
        x.attach_grad(stype="row_sparse")
        with pkg.autograd.record():
            y = (x * pkg.nd.array(m)).sum()
        y.backward()
        results.append(x.grad)
    _same_rsp(results[1], results[0])


def test_interior_nodes_take_a_dense_cotangent():
    """A row-sparse cotangent reaching an interior node arrives dense: the
    gradient of ``rows(2 * x)`` is held by x's dense buffer."""
    x0 = np.random.RandomState(22).randn(5, 2).astype(np.float32)
    results = []
    for pkg, sp in ((jmx, jsparse), (mx, sparse)):
        x = pkg.nd.array(x0)
        x.attach_grad()
        f = _rows_function(pkg, sp, [3, 0], x0.shape)
        with pkg.autograd.record():
            y = (f(x * 2.0) * 3.0).sum()
        y.backward()
        results.append(x.grad.asnumpy())
    np.testing.assert_allclose(results[1], results[0], **ND_TOL)


def test_autograd_grad_returns_row_sparse():
    w0 = np.random.RandomState(23).randn(10, 4).astype(np.float32)
    out = []
    for pkg, sp in ((jmx, jsparse), (mx, sparse)):
        w = pkg.nd.array(w0)
        w.attach_grad()
        f = _rows_function(pkg, sp, [1, 3], w0.shape)
        with pkg.autograd.record():
            loss = (f(w) ** 2).sum()
        (g,) = pkg.autograd.grad([loss], [w])
        out.append(g)
    _same_rsp(out[1], out[0])
    np.testing.assert_array_equal(out[1].indices.asnumpy(), [1, 3])


def test_row_sparse_grad_copy_is_independent():
    """A copy of a row-sparse gradient owns its rows: the next backward
    into the buffer leaves it as it was."""
    x = mx.nd.array(np.ones((6, 2), np.float32))
    x.attach_grad(stype="row_sparse")
    for rows in ([1, 3], [5]):
        f = _rows_function(mx, sparse, rows, (6, 2))
        with mx.autograd.record():
            y = f(x).sum()
        y.backward()
        if rows == [1, 3]:
            snap = x.grad.copy()
    assert snap.nnz == 2 and x.grad.nnz == 1
    np.testing.assert_array_equal(snap.indices.asnumpy(), [1, 3])


# ---------------------------------------------------------------------------
# sparse embedding gradients and the lazy optimizer
# ---------------------------------------------------------------------------
def _load(emb, w0):
    """The same table in a JAX or a port Embedding."""
    if isinstance(emb, torch.nn.Module):
        load_jax_params(emb, {"weight": w0}, ctx=mx.cpu())
    else:
        emb.initialize()
        emb.weight.set_data(jmx.nd.array(w0))
    return emb


def _emb_grad(pkg, gl, ids, w0, sparse_grad=True):
    emb = _load(gl.nn.Embedding(w0.shape[0], w0.shape[1],
                                sparse_grad=sparse_grad), w0)
    x = pkg.nd.array(ids, dtype="int32")
    with pkg.autograd.record():
        out = emb(x)
        loss = (out * out).sum()
    loss.backward()
    if pkg is jmx:
        return emb, emb.weight.grad()
    return emb, emb.weight.grad


def test_sparse_grad_embedding_backward_is_row_sparse():
    w0 = np.random.RandomState(30).randn(10, 4).astype(np.float32)
    ids = np.array([[1, 3], [3, 7]])
    _, want = _emb_grad(jmx, jgluon, ids, w0)
    emb, g = _emb_grad(mx, gluon, ids, w0)
    assert g.is_sparse and g.is_coalesced()
    _same_rsp(sparse.RowSparseNDArray.from_torch(g), want)
    np.testing.assert_array_equal(g.indices()[0].numpy(), [1, 3, 7])
    # the dense oracle: the same lookup without sparse_grad
    _, dense = _emb_grad(mx, gluon, ids, w0, sparse_grad=False)
    assert not dense.is_sparse
    np.testing.assert_allclose(g.to_dense().numpy(), dense.numpy(), **ND_TOL)


@pytest.mark.parametrize("ids", [[[0, 5, -1], [4, -1, 4]],
                                 [[2, 12, -11], [5, 2, 10]]],
                         ids=["padding_id", "out_of_range"])
def test_embedding_padding_id_and_ids_out_of_range(ids):
    """The padding id -1 reads the last row and its gradient lands there,
    as in the JAX package; the port's indices name that row (9), where the
    reference's keep -1 (its dense view and updates land in row 9 alike).
    An id outside [-n, n) reads NaN in both, and adds no row to the
    port's gradient; the reference lists it with rows that its dense view
    and its updates drop."""
    w0 = np.random.RandomState(31).randn(10, 3).astype(np.float32)
    ids = np.array(ids)
    jemb, want = _emb_grad(jmx, jgluon, ids, w0)
    emb, g = _emb_grad(mx, gluon, ids, w0)
    np.testing.assert_array_equal(
        emb(mx.nd.array(ids, dtype="int32")).asnumpy(),
        jemb(jmx.nd.array(ids, dtype="int32")).asnumpy())
    got = sparse.RowSparseNDArray.from_torch(g)
    wrapped = np.where(ids < 0, ids + 10, ids)
    inside = wrapped[(wrapped >= 0) & (wrapped < 10)]
    np.testing.assert_array_equal(got.indices.asnumpy(), np.unique(inside))
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **ND_TOL)


def test_embedding_takes_dtype_and_weight_initializer():
    emb = gluon.nn.Embedding(10, 3, dtype="bfloat16",
                             weight_initializer="ones", sparse_grad=True)
    jemb = jgluon.nn.Embedding(10, 3, dtype="bfloat16",
                               weight_initializer="ones", sparse_grad=True)
    emb.initialize("zeros", ctx=mx.cpu())
    jemb.initialize("zeros")
    assert emb.weight.dtype == torch.bfloat16
    assert str(jemb.weight.data().dtype) == "bfloat16"
    np.testing.assert_array_equal(emb.weight.float().detach().numpy(),
                                  np.asarray(jemb.weight.data().asnumpy(),
                                             np.float32))
    np.testing.assert_array_equal(emb.weight.float().detach().numpy(), 1.0)


def test_embedding_padding_id_beside_the_last_row_sums_both():
    """-1 and n - 1 in one batch name one row: the port's gradient holds
    it once, with both lookups summed, as the dense gradient does (the
    reference keeps two entries, -1 and 9, and its dense view writes one
    over the other)."""
    w0 = np.random.RandomState(32).randn(10, 3).astype(np.float32)
    ids = np.array([[0, 9, -1], [4, -1, 9]])
    _, g = _emb_grad(mx, gluon, ids, w0)
    _, dense = _emb_grad(mx, gluon, ids, w0, sparse_grad=False)
    got = sparse.RowSparseNDArray.from_torch(g)
    np.testing.assert_array_equal(got.indices.asnumpy(), [0, 4, 9])
    np.testing.assert_allclose(got.asnumpy(), dense.numpy(), **ND_TOL)


def _train(pkg, gl, w0, sparse_grad, opt, kw, batches):
    emb = _load(gl.nn.Embedding(w0.shape[0], w0.shape[1],
                                sparse_grad=sparse_grad), w0)
    tr = gl.Trainer(emb.collect_params(), opt, dict(kw))
    for idx in batches:
        x = pkg.nd.array(idx, dtype="int32")
        with pkg.autograd.record():
            loss = (emb(x) ** 2).sum()
        loss.backward()
        tr.step(2)
    w = emb.weight.data() if pkg is jmx else emb.weight
    return emb, tr, w.asnumpy() if pkg is jmx else w.detach().numpy()


_BATCHES = [np.random.RandomState(40 + i).randint(0, 20, (4, 3))
            for i in range(3)]


def test_sparse_embedding_training_matches_dense():
    """Lazy SGD (momentum 0, wd 0) on row-sparse gradients equals dense
    SGD: the reference's lazy_update equivalence case."""
    w0 = np.random.RandomState(41).randn(20, 8).astype(np.float32)
    kw = {"learning_rate": 0.1, "wd": 0.0}
    _, _, sparse_w = _train(mx, gluon, w0, True, "sgd", kw, _BATCHES)
    _, _, dense_w = _train(mx, gluon, w0, False, "sgd", kw, _BATCHES)
    _, _, want = _train(jmx, jgluon, w0, True, "sgd", kw, _BATCHES)
    np.testing.assert_allclose(sparse_w, dense_w, **ND_TOL)
    np.testing.assert_allclose(sparse_w, want, **ND_TOL)


def test_lazy_sgd_three_steps_with_momentum_as_the_reference():
    """The lazy rule with momentum, weight decay and clipping over 3
    steps: the weights and the momentum against the JAX package's; rows
    no batch touched keep their values and a zero momentum bit for bit."""
    w0 = np.random.RandomState(42).randn(20, 8).astype(np.float32)
    kw = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-2,
          "clip_gradient": 0.5}
    emb, tr, got = _train(mx, gluon, w0, True, "sgd", kw, _BATCHES)
    jemb, jtr, want = _train(jmx, jgluon, w0, True, "sgd", kw, _BATCHES)
    np.testing.assert_allclose(got, want, **ND_TOL)
    mom = tr._updater.states[0].numpy()
    np.testing.assert_allclose(mom, np.asarray(jtr._updater.states[0]),
                               **ND_TOL)
    touched = np.unique(np.concatenate([b.ravel() for b in _BATCHES]))
    untouched = np.setdiff1d(np.arange(20), touched)
    assert untouched.size
    np.testing.assert_array_equal(got[untouched], w0[untouched])
    np.testing.assert_array_equal(mom[untouched], 0.0)
    assert tr._fused.last_fallback == "row-sparse gradient"


@pytest.mark.parametrize("opt, kw", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-2,
             "lazy_update": False}),
    ("adam", {"learning_rate": 0.01, "wd": 1e-2}),
    ("adamw", {"learning_rate": 0.01, "wd": 1e-2})],
    ids=["sgd_not_lazy", "adam", "adamw"])
def test_dense_rules_densify_the_row_sparse_gradient(opt, kw):
    """``lazy_update=False``, Adam and AdamW densify on purpose: every
    row moves (weight decay, Adam's moments), as the JAX package's."""
    w0 = np.random.RandomState(43).randn(20, 8).astype(np.float32)
    _, _, got = _train(mx, gluon, w0, True, opt, kw, _BATCHES)
    _, _, want = _train(jmx, jgluon, w0, True, opt, kw, _BATCHES)
    _, _, dense = _train(mx, gluon, w0, False, opt, kw, _BATCHES)
    np.testing.assert_allclose(got, want, **ND_TOL)
    np.testing.assert_allclose(got, dense, **ND_TOL)
    assert not np.any(np.all(got == w0, axis=1))


def test_lazy_sgd_momentum_only_touches_rows():
    opt = optimizer.create("sgd", learning_rate=0.1, momentum=0.9)
    updater = optimizer.get_updater(opt)
    jupdater = jopt.get_updater(jopt.create("sgd", learning_rate=0.1,
                                            momentum=0.9))
    w, jw = mx.nd.ones((5, 2)), jmx.nd.ones((5, 2))
    g = sparse.row_sparse_array((np.ones((1, 2), np.float32), [2]),
                                shape=(5, 2))
    jg = jsparse.row_sparse_array((np.ones((1, 2), np.float32), [2]),
                                  shape=(5, 2))
    for _ in range(2):
        updater(0, g, w)
        jupdater(0, jg, jw)
        w1 = w.asnumpy()
        np.testing.assert_array_equal(w1[[0, 1, 3, 4]], 1.0)
        np.testing.assert_allclose(w1, jw.asnumpy(), **ND_TOL)
    assert w1[2][0] < 0.9


def test_dense_only_optimizer_densifies_sparse_grad():
    w, jw = mx.nd.ones((4, 2)), jmx.nd.ones((4, 2))
    g = sparse.row_sparse_array((np.ones((1, 2), np.float32), [1]),
                                shape=(4, 2))
    jg = jsparse.row_sparse_array((np.ones((1, 2), np.float32), [1]),
                                  shape=(4, 2))
    optimizer.get_updater(optimizer.create("adam", learning_rate=0.1))(
        0, g, w)
    jopt.get_updater(jopt.create("adam", learning_rate=0.1))(0, jg, jw)
    np.testing.assert_allclose(w.asnumpy(), jw.asnumpy(), **ND_TOL)


def test_sgd_sparse_learning_rate_change_applies():
    opt = optimizer.create("sgd", learning_rate=0.1, momentum=0.0)
    updater = optimizer.get_updater(opt)
    g = sparse.row_sparse_array((np.ones((1, 2), np.float32), [1]),
                                shape=(4, 2))
    w = mx.nd.ones((4, 2))
    updater(0, g, w)
    np.testing.assert_allclose(w.asnumpy()[1], 0.9, rtol=1e-5)
    opt.lr = 0.5
    w2 = mx.nd.ones((4, 2))
    updater(1, g, w2)
    np.testing.assert_allclose(w2.asnumpy()[1], 0.5, rtol=1e-5)


def test_trainer_stale_gradient_check_keeps_working():
    w0 = np.random.RandomState(44).randn(10, 4).astype(np.float32)
    emb = _load(gluon.nn.Embedding(10, 4, sparse_grad=True), w0)
    tr = gluon.Trainer(emb.collect_params(), "sgd", {"learning_rate": 0.1})
    x = mx.nd.array([[1, 2]], dtype="int32")
    with mx.autograd.record():
        loss = emb(x).sum()
    loss.backward()
    tr.step(1)
    with pytest.raises(UserWarning, match="has not been updated"):
        tr.step(1)
    tr.step(1, ignore_stale_grad=True)
    with mx.autograd.record():
        loss = emb(x).sum()
    loss.backward()
    tr.step(1)


def test_step_engines_keep_the_embedding_gradient_dense():
    """Inside the SuperStep and SPMDTrainer bodies (the JAX package's
    traced steps) the sparse-gradient Embedding takes its dense path: the
    fused window trains as the eager dense steps do."""
    from incubator_mxnet_tpu_torch import autograd, parallel

    w0 = np.random.RandomState(45).randn(12, 4).astype(np.float32)
    idx = np.random.RandomState(46).randint(0, 12, (3, 2, 5))
    ys = np.zeros((3, 2, 5, 4), np.float32)

    def loss_fn(out, y):
        return ((out - y) ** 2).sum(axis=(1, 2))

    emb = _load(gluon.nn.Embedding(12, 4, sparse_grad=True), w0)
    w = emb.weight
    with autograd.record(), autograd.dense_grads():
        out = emb(torch.from_numpy(idx[0]))
    (g,) = torch.autograd.grad(out.sum(), [w])
    assert not g.is_sparse
    tr = gluon.Trainer(emb.collect_params(), "sgd", {"learning_rate": 0.05})
    eng = tr.superstep(emb, loss_fn, window=3)
    eng.run_window(torch.from_numpy(idx), torch.from_numpy(ys))
    assert eng.last_fallback is None
    ref = _load(gluon.nn.Embedding(12, 4), w0)
    rtr = gluon.Trainer(ref.collect_params(), "sgd", {"learning_rate": 0.05})
    for i in range(3):
        with autograd.record():
            loss = loss_fn(ref(torch.from_numpy(idx[i])),
                           torch.from_numpy(ys[i])).float().mean()
        autograd.backward(loss)
        rtr.step(1)
    np.testing.assert_allclose(w.detach().numpy(), ref.weight.detach().numpy(),
                               **ND_TOL)
    st = parallel.SPMDTrainer(
        _load(gluon.nn.Embedding(12, 4, sparse_grad=True), w0), loss_fn,
        "sgd", {"learning_rate": 0.05})
    st.step(torch.from_numpy(idx[0]), torch.from_numpy(ys[0]))
