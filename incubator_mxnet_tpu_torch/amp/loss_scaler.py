"""Dynamic loss scaler (counterpart of the JAX package's
``amp/loss_scaler.py``, reference ``python/mxnet/amp/loss_scaler.py``)."""

from __future__ import annotations

import torch


class LossScaler:
    """Dynamic scaling: the scale starts at ``init_scale`` (2^16), doubles
    after ``scale_window`` (2000) steps without an overflow and halves on
    an overflow, staying between 1 and 2^24 (reference semantics)."""

    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000, tolerance=0.0):
        self.loss_scale = init_scale
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._unskipped = 0
        self._max_scale = 2.0 ** 24

    @staticmethod
    def has_overflow(params) -> bool:
        """True when a gradient of ``params`` (tensors, with ``.grad``)
        holds an inf or a NaN: one device-side ``multi_all_finite`` over
        every gradient and one host read (the reference reads each
        gradient in turn; the answer is the same)."""
        from ..ops.optimizer_ops import multi_all_finite

        grads = []
        for p in params:
            g = getattr(p, "grad", None)
            if g is not None:
                grads.append(g.coalesce().values() if g.is_sparse else g)
        if not grads:
            return False
        with torch.no_grad():
            ok = multi_all_finite(*grads, num_arrays=len(grads))
        return not bool(ok.item())

    def update_scale(self, overflow: bool) -> None:
        if overflow:
            self.loss_scale = max(self.loss_scale / self._scale_factor, 1.0)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped == self._scale_window:
                self.loss_scale = min(self.loss_scale * self._scale_factor,
                                      self._max_scale)
                self._unskipped = 0
