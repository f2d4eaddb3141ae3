"""Production serving: a fixed-shape SafeMPC controller — port of
``safe_exploration_tpu/runtime/serve.py``.

The research runners rebuild nothing between steps but plan on whatever
model they hold; a deployment wants the serving contract of the JAX
package's ``ServeController``:

  * ``ServeController.step(x)`` runs one control step (plan, fallback
    chain, state carry) on a bucketed view of the model that is built once
    per GP bucket, never per step, so every step of a bucket has the same
    shapes and does no work beyond the step itself;
  * ``observe(x, u, x_next)`` feeds the transition back through the O(n^2)
    incremental GP append; crossing a power-of-2 bucket rebuilds the view
    and the step explicitly (counted in ``recompiles``, the JAX package's
    name for its AOT recompiles: the initial build plus one per crossing,
    O(log n_max) over a deployment);
  * step wall-clock latencies (host, after the device has finished) are
    kept in a bounded window so a deployment reads p50 / p99 from the
    controller itself; the first step after each (re)build is left out.

The JAX package compiles its step ahead of time because JAX traces lazily;
PyTorch runs eagerly, so a rebuild here is the view and the step's
closure. Planner draws come from a ``torch.Generator`` (or are handed in
per step as ``noise``), where the JAX package splits a key per step.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from safe_exploration_tpu_torch.models.ssm import (
    ssm_append_point,
    ssm_bucketed,
)

__all__ = ["ServeController"]


def _bucket_size(ssm_plan) -> int:
    """Rows of the view's posterior: its GP buffer, or a sparse model's
    inducing set."""
    gp = getattr(ssm_plan, "gp", None)
    if gp is not None:
        return gp.x.shape[0]
    sgp = getattr(ssm_plan, "sgp", None)
    return 0 if sgp is None else sgp.z.shape[0]


class ServeController:
    """Fixed-shape single-plant SafeMPC control loop.

    Args:
      exp: ``build_experiment(cfg)`` dict (env, get_action, init_state, a,
        b, ...); the controller runs on its device and dtype.
      ssm: the trained SSM (the exact GP for ``observe``; any SSM family
        the planner takes serves ``step``).
      generator: draws of sampling-based planners (``None``: a CPU
        generator seeded 0); the SQP draws nothing.
      on_full: what ``observe`` does once the GP buffer is full:
        ``"raise"`` (default: a silent learning stop must be loud) or
        ``"drop"`` (count the transition in ``dropped_points`` and keep
        serving on the frozen model).
      latency_window: ring-buffer size of the step-latency samples.
    """

    def __init__(self, exp: dict, ssm, generator: torch.Generator | None
                 = None, *, on_full: str = "raise",
                 latency_window: int = 4096):
        if on_full not in ("raise", "drop"):
            raise ValueError(
                f"on_full must be 'raise' or 'drop', got {on_full!r}")
        self._exp = exp
        self._ssm_full = ssm
        self._dtype, self._device = exp["a"].dtype, exp["a"].device
        self._state = exp["init_state"]()
        self._generator = (torch.Generator().manual_seed(0)
                           if generator is None else generator)
        self._latencies: collections.deque[float] = collections.deque(
            maxlen=latency_window)
        self._last_flags: tuple | None = None
        self._on_full = on_full
        self.dropped_points = 0
        self.recompiles = 0
        self._bucket_n = -1
        # buffer occupancy, tracked on the host (capacity is static; the
        # count starts at the model's head and bumps per accepted append):
        # the saturation guard costs no device read per observe()
        gp = getattr(ssm, "gp", None)
        self._capacity = gp.n_max if gp is not None else 0
        self._n_pts = int(gp.head) if gp is not None else 0
        self._build_step(ssm_bucketed(ssm))

    # ------------------------------------------------------------------ build

    def _build_step(self, ssm_plan) -> None:
        """(Re)build the step for the bucket of ``ssm_plan``, the current
        model's bucketed view."""
        get_action = self._exp["get_action"]
        generator = self._generator
        self._ssm_plan = ssm_plan
        self._bucket_n = _bucket_size(ssm_plan)

        def step(state, ssm, x, noise):
            u, state, info = get_action(generator, state, ssm, x,
                                        noise=noise)
            return u, state, (info["feasible"], info["n_fail"],
                              info["violation"])

        self._step = step
        self.recompiles += 1
        # the next step is this build's first: its latency is left out
        self._skip_next_latency = True

    # ------------------------------------------------------------------ serve

    def _tensor(self, v) -> torch.Tensor:
        return torch.as_tensor(np.asarray(v), dtype=self._dtype).to(
            self._device)

    def step(self, x, *, noise=None) -> np.ndarray:
        """One control step at state ``x``: plan (or fall back) and return
        u on the host once the device has finished. ``noise`` (one solve's
        planner draws) replaces the generator's. Its wall time is the
        latency sample."""
        x = self._tensor(x)
        t0 = time.perf_counter()
        u, self._state, self._last_flags = self._step(
            self._state, self._ssm_plan, x, noise)
        u = u.cpu().numpy()
        if self._skip_next_latency:
            self._skip_next_latency = False     # the first step of a build
        else:
            self._latencies.append(time.perf_counter() - t0)
        return u

    @property
    def last_feasible(self) -> bool:
        return bool(self._last_flags[0])

    @property
    def last_n_fail(self) -> int:
        return int(self._last_flags[1])

    def observe(self, x, u, x_next) -> None:
        """Feed one observed transition back into the model: append the
        residual ``x_next - (a x + b u)`` through the O(n^2) incremental GP
        update, and rebuild the step when the append crosses a bucket.

        A full buffer (``head == n_max``) would make the append a silent
        no-op; this guard raises instead, or under ``on_full="drop"``
        counts the transition in ``dropped_points``."""
        if self._capacity and self._n_pts >= self._capacity:
            if self._on_full == "raise":
                raise RuntimeError(
                    f"ServeController GP buffer is full ({self._n_pts}/"
                    f"{self._capacity} points): observe() would silently "
                    "stop learning. Build the controller with a larger "
                    "n_max, or pass on_full='drop' to keep serving on the "
                    "frozen model (dropped transitions counted in "
                    ".dropped_points).")
            self.dropped_points += 1
            return
        x, u, x_next = self._tensor(x), self._tensor(u), self._tensor(x_next)
        y = x_next - (self._exp["a"] @ x + self._exp["b"] @ u)
        self._ssm_full = ssm_append_point(self._ssm_full, x, u, y)
        self._n_pts += 1
        new_plan = ssm_bucketed(self._ssm_full)    # one host read of the mask
        if _bucket_size(new_plan) != self._bucket_n:
            self._build_step(new_plan)
        else:
            self._ssm_plan = new_plan      # the same bucket: same shapes

    def latency_stats(self) -> dict:
        """p50 / p99 / mean step latency in milliseconds over the bounded
        window; ``None`` for each when there is no sample (JSON null, not
        NaN)."""
        lat = np.asarray(self._latencies, dtype=np.float64) * 1e3
        if lat.size == 0:
            return {"n": 0, "p50_ms": None, "p99_ms": None, "mean_ms": None}
        return {
            "n": int(lat.size),
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "mean_ms": float(lat.mean()),
        }
