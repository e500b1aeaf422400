"""Port parity: the fused conv + BatchNorm kernels' plain versions.

On the CPU the port's ``fused_conv``, ``conv_bwd_dx`` and ``conv_bwd_dw``
take their plain versions (the CUDA kernels need a card,
``tests/test_torch_fused_conv_kernel.py``). Each is held against the JAX
package on the same numpy inputs: the forward against
``_fused_conv_ref``; the backward against ``jax.vjp`` of the prologue and
conv (``_apply_prologue_host``, ``_conv_raw``) with the statistics
cotangents folded as the JAX package folds them; a few cases against
``fused_conv_bn(..., interpret=True)``, which runs the Pallas kernels in
interpret mode, forward and backward.

Tolerances, max abs error over max(1, max|JAX|) of each output: fp32 1e-5
(both compute in fp32 and differ in the order of sums), bf16 2e-2 (the
JAX reference convolves natively in bf16, rounding its outputs and its
statistics' inputs to bf16, while the port accumulates in fp32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.config import config
from incubator_mxnet_tpu.ops import pallas_conv as pc

from incubator_mxnet_tpu_torch.ops import fused_conv as fc

TOLS = {"float32": 1e-5, "bfloat16": 2e-2}

# (name, n, h, w, ci, co, k, stride, pad, kind, relu); kind "plain": no
# prologue, "pro": BatchNorm prologue, "res": + residual join and emit
CASES = [
    ("1x1_plain", 2, 6, 6, 8, 16, 1, 1, 0, "plain", True),
    ("1x1_s2_plain", 2, 8, 7, 16, 24, 1, 2, 0, "plain", True),
    ("3x3_pro", 2, 7, 7, 16, 8, 3, 1, 1, "pro", True),
    ("3x3_s2_pro", 2, 9, 8, 8, 16, 3, 2, 1, "pro", True),
    ("3x3_pro_no_relu", 1, 6, 6, 8, 8, 3, 1, 1, "pro", False),
    ("1x1_res_emit", 2, 5, 5, 16, 32, 1, 1, 0, "res", True),
    ("5x5_s2_res_emit", 2, 9, 9, 8, 12, 5, 2, 2, "res", True),
]


def _inputs(case, seed=0):
    _, n, h, w, ci, co, k, stride, pad, kind, _ = case
    rs = np.random.RandomState(seed)
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    d = dict(x=rs.randn(n, h, w, ci), w=rs.randn(k, k, ci, co) * 0.3,
             dy=rs.randn(n, ho, wo, co), ds=rs.randn(co) * 0.1,
             dss=rs.randn(co) * 0.01)
    if kind != "plain":
        d.update(a=rs.rand(ci) + 0.5, b=rs.randn(ci) * 0.5)
    if kind == "res":
        d.update(r=rs.randn(n, h, w, ci), ar=rs.rand(ci) + 0.5,
                 br=rs.randn(ci) * 0.5, g=rs.randn(n, h, w, ci))
    return {key: v.astype(np.float32) for key, v in d.items()}


_ACT = ("x", "w", "r", "g", "dy", "y")


def _jax(d, dtype):
    return {k: (jnp.asarray(v).astype(dtype) if k in _ACT
                else jnp.asarray(v)) for k, v in d.items()}


def _torch(d, dtype):
    dt = getattr(torch, dtype)
    return {k: (torch.from_numpy(v).to(dt) if k in _ACT
                else torch.from_numpy(v)) for k, v in d.items()}


def _close(name, got, want, tol):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape, (name, got.shape, want.shape)
    ref = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * ref, f"{name}: max abs err {err} > {tol} x {ref}"


def _jax_backward(j, case, y):
    """The JAX package's backward formula: dy_t folded and rounded to y's
    type, then the vjp of (prologue, conv) and the prologue output."""
    _, _, _, _, _, _, _, stride, pad, kind, relu = case
    dyt = pc._fold_bn_cotangents(j["dy"], y, j["ds"],
                                 j["dss"]).astype(y.dtype)
    if kind == "plain":
        _, vjp = jax.vjp(lambda x_, w_: pc._conv_part_ref(
            x_, w_, None, None, stride, pad, relu), j["x"], j["w"])
        return dict(zip(("dx", "dw"), vjp(dyt)))
    names = ("x", "w", "a", "b") + (("r", "ar", "br") if kind == "res"
                                    else ())

    def f(*args):
        kw = dict(zip(names, args))
        xp = pc._apply_prologue_host(kw["x"], kw["a"], kw["b"],
                                     r=kw.get("r"), ar=kw.get("ar"),
                                     br=kw.get("br"), relu=relu)
        return pc._conv_raw(xp, kw["w"], stride, pad), xp

    _, vjp = jax.vjp(f, *(j[k] for k in names))
    g = j["g"] if kind == "res" else jnp.zeros_like(j["x"])
    return dict(zip(("d" + k for k in names), vjp((dyt, g))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernels_plain_versions_match_jax_reference(case, dtype):
    _, _, _, _, _, _, _, stride, pad, kind, relu = case
    tol = TOLS[dtype]
    d = _inputs(case)
    j, t = _jax(d, dtype), _torch(d, dtype)
    res = kind == "res"
    jkw = dict(r=j.get("r"), ar=j.get("ar"), br=j.get("br"))
    tkw = dict(r=t.get("r"), ar=t.get("ar"), br=t.get("br"))
    jy, js, jss = pc._fused_conv_ref(j["x"], j["w"], j.get("a"), j.get("b"),
                                     stride, pad, relu, **jkw)
    launches = (fc.fused_conv_launches, fc.conv_bwd_dx_launches,
                fc.conv_bwd_dw_launches)
    out = fc.fused_conv(t["x"], t["w"], t.get("a"), t.get("b"), stride, pad,
                        relu, emit=res, **tkw)
    assert out[0].dtype == t["x"].dtype and out[1].dtype == torch.float32
    for name, got, want in zip(("y", "sum", "sumsq"), out, (jy, js, jss)):
        _close(name, got, want, tol)
    if res:
        want_xp = pc._apply_prologue_host(j["x"], j["a"], j["b"], relu=relu,
                                          **jkw)
        _close("emitted", out[3], want_xp, tol)

    # backward, from the JAX forward's y (the kernels' saved output)
    want = _jax_backward(j, case, jy)
    ty = torch.from_numpy(np.array(jy.astype(jnp.float32))).to(
        t["x"].dtype)
    args = (t["x"], t["w"], t.get("a"), t.get("b"), ty, t["dy"], t["ds"],
            t["dss"], stride, pad, relu)
    dx = fc.conv_bwd_dx(*args, g=t.get("g"), **tkw)
    dw = fc.conv_bwd_dw(*args, **tkw)
    _close("dw", dw, want["dw"], tol)
    _close("dx", dx[0], want["dx"], tol)
    if kind == "plain":
        assert dx[1] is None and dx[2] is None
    else:
        _close("da", dx[1], want["da"], tol)
        _close("db", dx[2], want["db"], tol)
    if res:
        _close("dr", dx[3], want["dr"], tol)
        _close("dar", dx[4], want["dar"], tol)
        _close("dbr", dx[2], want["dbr"], tol)
    assert (fc.fused_conv_launches, fc.conv_bwd_dx_launches,
            fc.conv_bwd_dw_launches) == launches       # CPU: no kernel


INTERPRET_CASES = [CASES[1], CASES[3], CASES[5]]


@pytest.mark.parametrize("case", INTERPRET_CASES,
                         ids=[c[0] for c in INTERPRET_CASES])
def test_autograd_matches_pallas_interpret(case):
    """``fused_conv_bn`` and its gradients against the Pallas kernels in
    interpret mode (dx through the kernel at stride 2 as well), fp32."""
    _, _, _, _, _, _, _, stride, pad, kind, relu = case
    d = _inputs(case, seed=1)
    j, t = _jax(d, "float32"), _torch(d, "float32")
    names = ("x", "w") + (("a", "b") if kind != "plain" else ()) \
        + (("r", "ar", "br") if kind == "res" else ())
    res = kind == "res"

    def call(mod, kw, **extra):
        return mod.fused_conv_bn(
            kw["x"], kw["w"], kw.get("a"), kw.get("b"), stride=stride,
            pad=pad, relu=relu, resid=kw.get("r"),
            resid_scale=kw.get("ar"), resid_shift=kw.get("br"),
            emit_act=res, **extra)

    def jf(*args):
        return call(pc, dict(zip(names, args)), interpret=True)

    cts = (j["dy"], j["ds"], j["dss"]) + ((j["g"],) if res else ())
    config.set("MXTPU_CONV_BWD", "pallas")
    try:
        outs, vjp = jax.vjp(jf, *(j[k] for k in names))
        want = vjp(cts)
    finally:
        config.unset("MXTPU_CONV_BWD")

    leaves = {k: t[k].clone().requires_grad_(True) for k in names}
    got = call(fc, leaves)
    for name, x, y in zip(("y", "sum", "sumsq", "emitted"), got, outs):
        _close(name, x.detach(), y, 1e-5)
    tcts = [t["dy"], t["ds"], t["dss"]] + ([t["g"]] if res else [])
    torch.autograd.backward(list(got), tcts)
    for k, w in zip(names, want):
        _close("d" + k, leaves[k].grad, w, 1e-5)


def test_relu_mask_is_strict_at_zero():
    """Where the prologue's pre-activation is exactly 0 the ReLU passes no
    gradient (the strict ``lin > 0`` mask of the TPU kernels), in dx, da,
    db and dw alike, as ``jax.vjp`` of the JAX package's prologue."""
    rs = np.random.RandomState(5)
    x = rs.randn(2, 5, 5, 8).astype(np.float32)
    x[:, 1:3] = 0.0                     # a=1, b=0: lin == 0 exactly here
    w = (rs.randn(3, 3, 8, 8) * 0.3).astype(np.float32)
    a = np.ones(8, np.float32)
    b = np.zeros(8, np.float32)
    dy = rs.randn(2, 5, 5, 8).astype(np.float32)
    jx, jw, ja, jb = map(jnp.asarray, (x, w, a, b))
    _, vjp = jax.vjp(lambda x_, w_, a_, b_: pc._conv_part_ref(
        x_, w_, a_, b_, 1, 1, True), jx, jw, ja, jb)
    want = vjp(jnp.asarray(dy))
    tx, tw, ta, tb = (torch.from_numpy(v).requires_grad_(True)
                      for v in (x, w, a, b))
    y, _, _ = fc.fused_conv_bn(tx, tw, ta, tb, stride=1, pad=1, relu=True)
    y.backward(torch.from_numpy(dy))
    assert torch.all(tx.grad[:, 1:3] == 0)
    assert torch.any(tx.grad[:, 3:] != 0)
    for name, got, w_ in zip(("dx", "dw", "da", "db"),
                             (tx.grad, tw.grad, ta.grad, tb.grad), want):
        _close(name, got, w_, 1e-5)


def test_emit_without_resid_raises_and_contract_checks():
    x = torch.zeros(1, 4, 4, 8)
    w = torch.zeros(1, 1, 8, 8)
    with pytest.raises(ValueError, match="emit_act requires a resid"):
        fc.fused_conv_bn(x, w, emit_act=True)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fc.fused_conv(x.half(), w.half())
    with pytest.raises(ValueError, match="only odd"):
        fc.fused_conv(x, torch.zeros(2, 2, 8, 8))
    with pytest.raises(ValueError, match="stride 3"):
        fc.fused_conv(x, w, stride=3)
    with pytest.raises(ValueError, match="channel mismatch"):
        fc.fused_conv(x, torch.zeros(1, 1, 4, 8))


def test_resid_without_scale_is_the_identity_join():
    """``resid`` with no ``a``, scale or shift: a=1, b=0, ar=1, br=0, as
    the JAX package's defaults (``fused_conv_bn`` :1153)."""
    rs = np.random.RandomState(7)
    x, r = (rs.randn(1, 4, 4, 8).astype(np.float32) for _ in range(2))
    w = rs.randn(1, 1, 8, 16).astype(np.float32)
    want = pc.fused_conv_bn(jnp.asarray(x), jnp.asarray(w),
                            resid=jnp.asarray(r), emit_act=True,
                            interpret=True)
    got = fc.fused_conv_bn(torch.from_numpy(x), torch.from_numpy(w),
                           resid=torch.from_numpy(r), emit_act=True)
    for name, g, w_ in zip(("y", "sum", "sumsq", "emitted"), got, want):
        _close(name, g, w_, 1e-5)


def test_bn_scale_shift_matches_jax():
    rs = np.random.RandomState(3)
    s, ss = rs.randn(16).astype(np.float32), rs.rand(16).astype(np.float32)
    s = s * 4
    ss = ss * 40 + 20
    g, be = rs.rand(16).astype(np.float32), rs.randn(16).astype(np.float32)
    want = pc.bn_scale_shift(jnp.asarray(s), jnp.asarray(ss), 24,
                             jnp.asarray(g), jnp.asarray(be))
    got = fc.bn_scale_shift(*(torch.from_numpy(v) for v in (s, ss)), 24,
                            torch.from_numpy(g), torch.from_numpy(be))
    for name, x, y in zip(("a", "b", "mean", "var"), got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
