"""Deadline-driven micro-batch sizing.

The latency/throughput knob the paper leaves to the operator (§7.3) made
operational: an online latency model picks the largest micro-batch that is
predicted to fit the ingest deadline.

:class:`LatencyModel` is the estimator ``InferenceSession.ingest`` uses for
its ``deadline_ms`` knob (the admission controller of the serving layer
lands with ROADMAP.md Queue 1 item 9).  It is a control-loop
estimator, not a regression: one EWMA step per observed batch keeps it
O(1) and lets it track regime changes (engine hot-swap, cap-ladder
steps, graph growth) within a few batches.
"""
from __future__ import annotations


class LatencyModel:
    """Online affine model of micro-batch latency: ``t(bs) ~ a + b * bs``.

    ``a`` captures per-dispatch overhead (routing, kernel dispatch, queue
    bookkeeping), ``b`` the marginal per-update cost.  Implemented as
    EWMA-weighted least squares over four running moments — exact for
    truly affine data (any weighting), and the exponential decay lets it
    track regime changes.  With constant batch sizes the slope is
    indeterminate (zero variance); the fallback splits the observed mean
    evenly, which still predicts exactly at the operating point — all the
    controller needs.
    """

    def __init__(self, alpha: float = 0.25):
        self.alpha = alpha
        self.n_obs = 0
        self._ex = self._ey = self._exy = self._exx = 0.0

    def observe(self, batch_size: int, seconds: float) -> None:
        bs = max(int(batch_size), 1)
        s = max(float(seconds), 1e-9)
        w = 1.0 if self.n_obs == 0 else self.alpha
        self._ex += w * (bs - self._ex)
        self._ey += w * (s - self._ey)
        self._exy += w * (bs * s - self._exy)
        self._exx += w * (bs * bs - self._exx)
        self.n_obs += 1

    @property
    def b(self) -> float:
        """Seconds per update (slope)."""
        var = self._exx - self._ex ** 2
        if var <= max(1e-9, 1e-6 * self._exx):   # constant batch sizes
            return self._ey / (2 * self._ex) if self._ex else 1e-12
        return max((self._exy - self._ex * self._ey) / var, 1e-12)

    @property
    def a(self) -> float:
        """Seconds of fixed per-batch overhead (intercept)."""
        return max(self._ey - self.b * self._ex, 0.0)

    def predict(self, batch_size: int) -> float:
        return self.a + self.b * max(int(batch_size), 1)

    def batch_for(self, deadline_s: float, *, lo: int = 1,
                  hi: int = 1 << 20, margin: float = 0.85) -> int:
        """Largest batch size predicted to finish within ``margin`` of the
        deadline (clamped to [lo, hi]; ``hi`` before any observation)."""
        if self.n_obs == 0 or deadline_s <= 0:
            return hi
        budget = deadline_s * margin - self.a
        if budget <= 0:
            return lo
        return int(min(max(budget / max(self.b, 1e-12), lo), hi))
