"""Optimizer update ops and the AMP ops.

Counterpart of the JAX package's ``ops/optimizer_ops.py`` (the reference's
``src/operator/optimizer_op.cc``, contrib ``adamw.cc``, ``multi_lars``,
``multi_sum_sq``, ``amp_cast.cc``, ``all_finite.cc``): every optimizer
step is an op, with the reference's exact formulas. ``adam_update`` has no
bias correction (as the C++ op); ``adamw_update``'s ``wd`` is decoupled
and scaled by ``eta``; ``lamb_update_phase1`` corrects only when
``bias_correction``; ``clip_gradient`` applies only when > 0; the
``mp_*`` rules update an fp32 master weight and return the weight in its
own type. None is a TPU kernel there, so each is plain PyTorch here.

The ops are functional: they return the new weight and states. The
``mx.nd`` wrappers (``ndarray/__init__.py``) write them back with the
reference's in-place rule: the weight only through ``out=``, the trailing
state arrays always.
"""

from __future__ import annotations

import torch

from ..base import resolve_dtype
from .registry import register


def _clip(g, clip):
    return g.clamp(-clip, clip) if clip is not None and clip > 0 else g


def _apply_wd(grad, weight, wd, rescale, clip):
    """``clip(grad * rescale) + wd * weight``."""
    return _clip(grad * rescale, clip) + wd * weight


@register("sgd_update")
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    """``w - lr * (clip(rescale * g) + wd * w)``."""
    return weight - lr * _apply_wd(grad, weight, wd, rescale_grad,
                                   clip_gradient)


@register("sgd_mom_update")
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    """Returns (weight, mom)."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    mom2 = momentum * mom - lr * g
    return weight + mom2, mom2


@register("mp_sgd_update")
def mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0):
    """The fp32 master ``weight32`` updated; returns (weight in its own
    type, weight32)."""
    g = _apply_wd(grad.to(torch.float32), weight32, wd, rescale_grad,
                  clip_gradient)
    w32 = weight32 - lr * g
    return w32.to(weight.dtype), w32


@register("mp_sgd_mom_update")
def mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Returns (weight, mom, weight32)."""
    g = _apply_wd(grad.to(torch.float32), weight32, wd, rescale_grad,
                  clip_gradient)
    mom2 = momentum * mom - lr * g
    w32 = weight32 + mom2
    return w32.to(weight.dtype), mom2, w32


@register("nag_mom_update")
def nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """Nesterov momentum. Returns (weight, mom)."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    mom2 = momentum * mom + g
    return weight - lr * (g + momentum * mom2), mom2


@register("adam_update")
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    """Adam without bias correction (as the C++ op). Returns (weight,
    mean, var)."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    mean2 = beta1 * mean + (1 - beta1) * g
    var2 = beta2 * var + (1 - beta2) * g.square()
    return weight - lr * mean2 / (var2.sqrt() + epsilon), mean2, var2


@register("adamw_update")
def adamw_update(weight, grad, mean, var, rescale_grad=1.0, lr=0.001,
                 beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                 clip_gradient=-1.0):
    """AdamW: the decay ``wd * w`` decoupled from the moments, the whole
    step scaled by ``eta``. Returns (weight, mean, var)."""
    g = _clip(grad * rescale_grad, clip_gradient)
    mean2 = beta1 * mean + (1 - beta1) * g
    var2 = beta2 * var + (1 - beta2) * g.square()
    w = weight - eta * (lr * mean2 / (var2.sqrt() + epsilon) + wd * weight)
    return w, mean2, var2


@register("rmsprop_update")
def rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.9, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    """Returns (weight, n)."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    n2 = gamma1 * n + (1 - gamma1) * g.square()
    w = weight - lr * g / (n2 + epsilon).sqrt()
    if clip_weights > 0:
        w = w.clamp(-clip_weights, clip_weights)
    return w, n2


@register("rmspropalex_update")
def rmspropalex_update(weight, grad, n, g_acc, delta, lr=0.001, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0):
    """Graves' RMSProp. Returns (weight, n, g_acc, delta)."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    n2 = gamma1 * n + (1 - gamma1) * g.square()
    gacc2 = gamma1 * g_acc + (1 - gamma1) * g
    d2 = gamma2 * delta - lr * g / (n2 - gacc2.square() + epsilon).sqrt()
    return weight + d2, n2, gacc2, d2


@register("ftrl_update")
def ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    """Returns (weight, z, n)."""
    g = _clip(grad * rescale_grad, clip_gradient)
    n2 = n + g.square()
    sigma = (n2.sqrt() - n.sqrt()) / lr
    z2 = z + g - sigma * weight
    w = torch.where(z2.abs() <= lamda1, torch.zeros_like(weight),
                    -(z2 - torch.sign(z2) * lamda1)
                    / ((beta + n2.sqrt()) / lr + wd))
    return w, z2, n2


@register("signsgd_update")
def signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    g = _clip(grad * rescale_grad, clip_gradient)
    return weight * (1 - lr * wd) - lr * torch.sign(g)


@register("signum_update")
def signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    """Signum: ``wd * w`` folded into the gradient before the momentum and
    the sign. Returns (weight, mom)."""
    g = _clip(grad * rescale_grad, clip_gradient) + wd * weight
    mom2 = momentum * mom - (1 - momentum) * g
    return weight * (1 - lr * wd_lh) + lr * torch.sign(mom2), mom2


@register("lamb_update_phase1")
def lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    """Returns (update direction, mean, var)."""
    g = _clip(grad * rescale_grad, clip_gradient)
    mean2 = beta1 * mean + (1 - beta1) * g
    var2 = beta2 * var + (1 - beta2) * g.square()
    m_hat, v_hat = mean2, var2
    if bias_correction:
        m_hat = mean2 / (1 - beta1 ** t)
        v_hat = var2 / (1 - beta2 ** t)
    return m_hat / (v_hat.sqrt() + epsilon) + wd * weight, mean2, var2


def _trust_ratio(r1, r2, lower_bound, upper_bound):
    if lower_bound > 0:
        r1 = r1.clamp_min(lower_bound)
    if upper_bound > 0:
        r1 = r1.clamp_max(upper_bound)
    return torch.where((r1 > 0) & (r2 > 0), r1 / r2, torch.ones_like(r1))


@register("lamb_update_phase2")
def lamb_update_phase2(weight, g_update, r1, r2, lr=0.001,
                       lower_bound=-1.0, upper_bound=-1.0):
    """``w - lr * (r1 / r2) * update``, the trust ratio 1 unless both
    norms are positive."""
    ratio = _trust_ratio(r1.clamp_min(0.0), r2, lower_bound, upper_bound)
    return weight - lr * ratio * g_update


@register("multi_sgd_update")
def multi_sgd_update(*args, lrs=(), wds=(), rescale_grad=1.0,
                     clip_gradient=-1.0, num_weights=None):
    """``args`` = (w0, g0, w1, g1, ...); returns the new weights."""
    n = num_weights if num_weights is not None else len(args) // 2
    return tuple(sgd_update(args[2 * i], args[2 * i + 1], lr=lrs[i],
                            wd=wds[i], rescale_grad=rescale_grad,
                            clip_gradient=clip_gradient) for i in range(n))


@register("multi_sgd_mom_update")
def multi_sgd_mom_update(*args, lrs=(), wds=(), momentum=0.0,
                         rescale_grad=1.0, clip_gradient=-1.0,
                         num_weights=None):
    """``args`` = (w0, g0, m0, w1, ...); returns (w0', m0', w1', ...)."""
    n = num_weights if num_weights is not None else len(args) // 3
    outs = []
    for i in range(n):
        outs.extend(sgd_mom_update(*args[3 * i:3 * i + 3], lr=lrs[i],
                                   momentum=momentum, wd=wds[i],
                                   rescale_grad=rescale_grad,
                                   clip_gradient=clip_gradient))
    return tuple(outs)


# -- AMP support ops ------------------------------------------------------------
@register("amp_cast")
def amp_cast(x, dtype="float16"):
    return x.to(resolve_dtype(dtype))


@register("amp_multicast")
def amp_multicast(*arrays, num_outputs=None, cast_narrow=False):
    """Every array in the widest of their types (the narrowest with
    ``cast_narrow``)."""
    target = arrays[0].dtype
    for a in arrays[1:]:
        if cast_narrow:
            if torch.finfo(a.dtype).bits < torch.finfo(target).bits:
                target = a.dtype
        else:
            target = torch.promote_types(a.dtype, target)
    return tuple(a.to(target) for a in arrays)


@register("all_finite", differentiable=False)
def all_finite(data, init_output=True):
    """(1,) float32: 1 if every element is finite, else 0."""
    return torch.isfinite(data).all().to(torch.float32).reshape(1)


@register("multi_all_finite", differentiable=False)
def multi_all_finite(*arrays, num_arrays=None, init_output=True):
    ok = torch.stack([torch.isfinite(a).all() for a in arrays]).all()
    return ok.to(torch.float32).reshape(1)


# -- the rest of optimizer_op.cc -------------------------------------------------
@register("ftml_update")
def ftml_update(weight, grad, d, v, z, lr=0.01, beta1=0.6, beta2=0.999,
                epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0,
                clip_grad=-1.0):
    """Follow the Moving Leader. Returns (weight, d, v, z)."""
    g = _clip(grad.to(torch.float32) * rescale_grad, clip_grad) + wd * weight
    v2 = beta2 * v + (1 - beta2) * g.square()
    d2 = (1 - beta1 ** t) / lr * ((v2 / (1 - beta2 ** t)).sqrt() + epsilon)
    z2 = beta1 * z + (1 - beta1) * g - (d2 - beta1 * d) * weight
    return (-z2 / d2).to(weight.dtype), d2, v2, z2


@register("mp_nag_mom_update")
def mp_nag_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """NAG on the fp32 master. Returns (weight, mom, weight32)."""
    g = _apply_wd(grad.to(torch.float32), weight32, wd, rescale_grad,
                  clip_gradient)
    m2 = momentum * mom + g
    w32 = weight32 - lr * (momentum * m2 + g)
    return w32.to(weight.dtype), m2, w32


@register("mp_lamb_update_phase1")
def mp_lamb_update_phase1(weight, grad, mean, var, weight32, beta1=0.9,
                          beta2=0.999, epsilon=1e-6, t=1, wd=0.0,
                          rescale_grad=1.0, bias_correction=True):
    """LAMB phase 1 on the fp32 master (no clipping, as the reference).
    Returns (update direction, mean, var)."""
    g = grad.to(torch.float32) * rescale_grad
    m2 = beta1 * mean + (1 - beta1) * g
    v2 = beta2 * var + (1 - beta2) * g.square()
    mh, vh = m2, v2
    if bias_correction:
        mh = m2 / (1 - beta1 ** t)
        vh = v2 / (1 - beta2 ** t)
    return mh / (vh.sqrt() + epsilon) + wd * weight32, m2, v2


@register("mp_lamb_update_phase2")
def mp_lamb_update_phase2(weight, g_update, r1, r2, weight32, lr=0.001,
                          lower_bound=-1.0, upper_bound=-1.0):
    """LAMB phase 2 on the fp32 master (``r1`` taken as it is). Returns
    (weight, weight32)."""
    w32 = weight32 - lr * _trust_ratio(r1, r2, lower_bound,
                                       upper_bound) * g_update
    return w32.to(weight.dtype), w32


@register("multi_sum_sq", differentiable=False)
def multi_sum_sq(*arrays, num_arrays=None):
    """(n,) fp32: each array's sum of squares."""
    return torch.stack([a.to(torch.float32).square().sum() for a in arrays])


@register("multi_lars", differentiable=False)
def multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, eta=0.001, eps=1e-9,
               rescale_grad=1.0):
    """LARS: ``lr_i * eta * |w_i| / (|g_i| + wd_i * |w_i| + eps)`` where
    both norms are positive, else ``lr_i``."""
    wn = weights_sum_sq.sqrt()
    gn = grads_sum_sq.sqrt() * rescale_grad
    ratio = eta * wn / (gn + wds * wn + eps)
    return lrs * torch.where((wn > 0) & (gn > 0), ratio,
                             torch.ones_like(ratio))


@register("multi_mp_sgd_update")
def multi_mp_sgd_update(*args, lrs=(), wds=(), rescale_grad=1.0,
                        clip_gradient=-1.0, num_weights=None):
    """``args`` = (w0, g0, w32_0, ...); returns (w0', w32_0', ...)."""
    n = num_weights if num_weights is not None else len(args) // 3
    outs = []
    for i in range(n):
        outs.extend(mp_sgd_update(*args[3 * i:3 * i + 3], lr=lrs[i],
                                  wd=wds[i], rescale_grad=rescale_grad,
                                  clip_gradient=clip_gradient))
    return tuple(outs)


@register("multi_mp_sgd_mom_update")
def multi_mp_sgd_mom_update(*args, lrs=(), wds=(), momentum=0.0,
                            rescale_grad=1.0, clip_gradient=-1.0,
                            num_weights=None):
    """``args`` = (w0, g0, m0, w32_0, ...); returns (w0', m0', w32_0',
    ...)."""
    n = num_weights if num_weights is not None else len(args) // 4
    outs = []
    for i in range(n):
        outs.extend(mp_sgd_mom_update(*args[4 * i:4 * i + 4], lr=lrs[i],
                                      momentum=momentum, wd=wds[i],
                                      rescale_grad=rescale_grad,
                                      clip_gradient=clip_gradient))
    return tuple(outs)


def _preloaded(multi, per):
    """``preloaded_<multi>``: ``lrs`` and ``wds`` arrive as the last two
    arrays (on the device) instead of attributes; ``per`` arrays a
    weight."""
    def op(*args, num_weights=None, **kwargs):
        lrs, wds, body = args[-2], args[-1], args[:-2]
        n = num_weights if num_weights is not None else len(body) // per
        return multi(*body, lrs=lrs, wds=wds, num_weights=n, **kwargs)

    op.__doc__ = multi.__doc__
    return op


register("preloaded_multi_sgd_update")(_preloaded(multi_sgd_update, 2))
register("preloaded_multi_sgd_mom_update")(
    _preloaded(multi_sgd_mom_update, 3))
register("preloaded_multi_mp_sgd_update")(_preloaded(multi_mp_sgd_update, 3))
register("preloaded_multi_mp_sgd_mom_update")(
    _preloaded(multi_mp_sgd_mom_update, 4))


@register("reset_arrays", differentiable=False)
def reset_arrays(*arrays, num_arrays=None):
    """Zeros of each array (the ``mx.nd`` wrapper writes them into the
    arrays)."""
    return tuple(torch.zeros_like(a) for a in arrays)
