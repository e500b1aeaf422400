"""Shared by the ``tests/test_torch_np_*.py`` files: the cases of
``chip_smoke.NP_CASES`` through the JAX package and through the port.

The port runs each case as ``chip_smoke.py`` runs it on the card
(``run_nd_case``: ``mx.nd``/``mx.np`` under ``autograd.record()`` with the
gradient of a seeded head). The JAX package runs a case with gradients as
one jitted call of ``jax.value_and_grad`` over its own ``mx.nd``/``mx.np``
entry point with the same head (its eager tape compiles every primitive
and its transpose one at a time: several times slower at these sizes);
a case without gradients runs eagerly, as the dynamic-shape ops must.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np

import incubator_mxnet_tpu as jmx

import incubator_mxnet_tpu_torch as mx

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


def cases(*families):
    """The cases of ``NP_CASES`` in ``families``, by id."""
    out = {c.id: c for c in cs.NP_CASES if c.family in families}
    assert len(out) == sum(c.family in families for c in cs.NP_CASES)
    return out


def port(case):
    """The port's results on the CPU."""
    return cs.run_nd_case(mx, case, mx.cpu())


def _head(outs, sq):
    head = 0.0
    for i, o in enumerate(outs):
        if not jnp.issubdtype(o.dtype, jnp.inexact):
            continue
        parts = [jnp.real(o), jnp.imag(o)] if jnp.iscomplexobj(o) else [o]
        for j, p in enumerate(parts):
            if i in sq:
                p = p * p
            head = head + jnp.sum(p * cs._nd_rand(99 + i + 50 * j, *p.shape))
    return head


def reference(case):
    """The JAX package's results of ``case``, as ``run_nd_case`` gives
    them: the outputs (after ``case.post``), then the gradients."""
    if not case.grad:
        return cs.run_nd_case(jmx, case, raw_array_kwargs=True)
    fn = cs._nd_fn(jmx, case.name)
    at = [i for i, a in enumerate(case.arrays) if isinstance(a, np.ndarray)]
    kwargs = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
              for k, v in case.kwargs.items()}

    def loss(*data):
        xs = list(case.arrays)
        for i, d in zip(at, data):
            xs[i] = jmx.nd.NDArray(d)
        out = fn(xs, **kwargs) if case.name in cs.NP_SEQUENCE_ARGS \
            else fn(*xs, **kwargs)
        outs = [o._data for o in (out if isinstance(out, (tuple, list))
                                  else [out])]
        return _head(outs, case.sq), outs

    step = jax.jit(jax.value_and_grad(loss, argnums=[at.index(i)
                                                     for i in case.grad],
                                      has_aux=True))
    (_, outs), grads = step(*[jnp.asarray(case.arrays[i]) for i in at])
    got = [np.asarray(o) for o in outs]
    if case.post is not None:
        got = list(case.post(got))
    return got + [np.asarray(g) for g in grads]


def check(case):
    """The port's results of ``case`` against the JAX package's."""
    cs.check_nd_case(case, port(case), reference(case))
