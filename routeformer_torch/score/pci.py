"""Path Complexity Index (counterpart of ``routeformer_tpu/score/pci.py``).

A "regular" trajectory is extrapolated from the last ``lookback_length``
input points (linear, quadratic or constrained-quadratic fit), and the PCI
is its Fréchet (or MSE) distance to the real future.

- ``estimate_regular_trajectory``, ``estimate_pci`` and ``pci`` are the
  host paths, numpy in f64 (the Fréchet DP in f32, as in the JAX package);
  ``fit_quadratic_with_constraints`` is the scipy SLSQP fit.
- ``estimate_pci_batch`` is the index-build path: the closed-form
  least-squares fit in the mapped variable ``s`` in [-1, 1] and the batched
  Fréchet DP, in f32, as the JAX package's jitted batch computes them.
"""

from typing import Literal, Optional

import numpy as np

from routeformer_torch.score.frechet import frechet_distance, frechet_distance_batch


def fit_quadratic_with_constraints(t, y, max_speed, max_accel, domain=None):
    """Least-squares quadratic fit subject to ``max |2 a t + b| <= max_speed``
    over the domain and ``|2 a| <= max_accel``. Returns ``[a, b, c]``."""
    from scipy.optimize import minimize

    t = np.asarray(t, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if domain is None:
        domain = [t.min(), t.max()]
    probe = np.linspace(domain[0], domain[1], 10)

    def objective(params):
        a, b, c = params
        return np.sum((y - (a * t**2 + b * t + c)) ** 2)

    constraints = (
        {"type": "ineq",
         "fun": lambda p: max_speed - np.max(np.abs(2 * p[0] * probe + p[1]))},
        {"type": "ineq", "fun": lambda p: max_accel - np.abs(2 * p[0])},
    )
    return minimize(objective, [0.0, 0.0, 0.0], constraints=constraints).x


def pci(real_trajectory, regular_trajectory,
        measure: Literal["mse", "frechet"] = "frechet") -> float:
    """PCI of a regular trajectory against the real one."""
    if measure == "mse":
        return float(np.mean((np.asarray(real_trajectory)
                              - np.asarray(regular_trajectory)) ** 2))
    if measure == "frechet":
        return float(frechet_distance(real_trajectory, regular_trajectory))
    raise ValueError("Invalid pci measure.")


def estimate_regular_trajectory(
    input_trajectory: np.ndarray,
    time_steps: int,
    curve_type: Literal["linear", "quadratic", "constrained_quadratic"] = "linear",
    lookback_length: int = 6,
    constraints: Optional[dict] = None,
    frequency: float = 30,
) -> np.ndarray:
    """Fit x(t), y(t) over the last ``lookback_length`` points
    (``Polynomial.fit`` on the domain [t0, t_last]) and evaluate them at the
    next ``time_steps`` points: ``(time_steps, 2)``."""
    input_trajectory = np.asarray(input_trajectory)
    if input_trajectory.shape[0] < lookback_length:
        raise ValueError(
            "Lookback length is greater than the number of points in the trajectory."
        )
    lookback_points = input_trajectory[-lookback_length:]
    time = np.arange(lookback_length + time_steps) / frequency
    input_time = time[:lookback_length]
    target_time = time[lookback_length:]
    x = lookback_points[:, 0]
    y = lookback_points[:, 1]

    if curve_type == "constrained_quadratic":
        if constraints is None:
            raise ValueError(
                "Constraints must be provided if curve_type is constrained_quadratic."
            )
        coeffs = [
            fit_quadratic_with_constraints(
                input_time, v, constraints["max_speed"], constraints["max_accel"],
                domain=[time[0], time[-1]])
            for v in (x, y)
        ]
        new_x, new_y = (f[0] * target_time**2 + f[1] * target_time + f[2]
                        for f in coeffs)
    else:
        degree = {"linear": 1, "quadratic": 2}.get(curve_type)
        if degree is None:
            raise ValueError(
                "Invalid curve_type. Choose from 'linear', 'quadratic', "
                "'constrained_quadratic'."
            )
        new_x, new_y = (
            np.polynomial.Polynomial.fit(input_time, v, degree,
                                         domain=[input_time[0], input_time[-1]])(target_time)
            for v in (x, y)
        )
    return np.stack((new_x, new_y), axis=-1)


def estimate_pci(
    input_trajectory,
    target_trajectory,
    curve_type: Literal["linear", "quadratic", "constrained_quadratic"] = "linear",
    lookback_length: int = 6,
    constraints: Optional[dict] = None,
    frequency: float = 30,
    measure: Literal["mse", "frechet"] = "frechet",
    return_regular_trajectory: bool = False,
):
    """The PCI of a target trajectory given its input trajectory (and the
    regular trajectory with ``return_regular_trajectory``)."""
    regular = estimate_regular_trajectory(
        input_trajectory, len(target_trajectory), curve_type, lookback_length,
        constraints, frequency,
    )
    value = pci(np.asarray(target_trajectory), regular, measure)
    if return_regular_trajectory:
        return value, regular
    return value


def _lu_solve(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``a x = b`` for one small f32 matrix ``a`` and a batch of right-hand
    sides ``b (B, n, c)``: LU with partial pivoting, then forward and back
    substitution with the reciprocal of each pivot, as the LAPACK getrf and
    trsm calls behind ``jnp.linalg.solve`` on the CPU round."""
    a = a.astype(np.float32).copy()
    n = a.shape[0]
    perm = list(range(n))
    for k in range(n):
        p = k + int(np.argmax(np.abs(a[k:, k])))
        if p != k:
            a[[k, p]] = a[[p, k]]
            perm[k], perm[p] = perm[p], perm[k]
        a[k + 1:, k] = a[k + 1:, k] / a[k, k]
        a[k + 1:, k + 1:] -= np.outer(a[k + 1:, k], a[k, k + 1:])
    x = b[:, perm, :].astype(np.float32)
    for i in range(n):
        for j in range(i):
            x[:, i] -= a[i, j] * x[:, j]
    for i in reversed(range(n)):
        for j in range(i + 1, n):
            x[:, i] -= a[i, j] * x[:, j]
        x[:, i] *= np.float32(1.0) / a[i, i]
    return x


def _polyfit_extrapolate(lookback: np.ndarray, input_time: np.ndarray,
                         target_time: np.ndarray, degree: int) -> np.ndarray:
    """Closed-form least-squares fit in f32, batched: ``lookback (B, L, 2)
    -> (B, T, 2)``, in the mapped variable s in [-1, 1] over [t0, t_last]
    (``Polynomial.fit``'s conditioning), by the normal equations."""
    t0, t1 = input_time[0], input_time[-1]
    scale = np.float32(2.0) / (t1 - t0)

    def mapped(t):  # (t - t0) * scale - 1 with one rounding, as XLA's fused multiply-add
        return ((t - t0).astype(np.float64) * np.float64(scale) - 1.0).astype(np.float32)

    s_in, s_out = mapped(input_time), mapped(target_time)
    powers = np.arange(degree + 1)
    v_in = (s_in[:, None] ** powers[None, :]).astype(np.float32)   # (L, deg+1)
    v_out = (s_out[:, None] ** powers[None, :]).astype(np.float32)  # (T, deg+1)
    coeffs = _lu_solve(v_in.T @ v_in, np.matmul(v_in.T[None], lookback))
    return np.matmul(v_out[None], coeffs)


def estimate_pci_batch(
    inputs,
    targets,
    curve_type: Literal["linear", "quadratic"] = "linear",
    lookback_length: int = 6,
    frequency: float = 30,
) -> np.ndarray:
    """Batched PCI for index builds: ``(B, Lin, 2) x (B, T, 2) -> (B,)`` f32,
    Fréchet measure."""
    degree = {"linear": 1, "quadratic": 2}[curve_type]
    inputs = np.asarray(inputs, dtype=np.float32)
    targets = np.asarray(targets, dtype=np.float32)
    n_target = targets.shape[1]
    time = np.arange(lookback_length + n_target, dtype=np.float32) / np.float32(frequency)
    regular = _polyfit_extrapolate(inputs[:, -lookback_length:], time[:lookback_length],
                                   time[lookback_length:], degree)
    return frechet_distance_batch(targets, regular)
