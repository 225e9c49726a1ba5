"""The port's Fréchet distance and PCI against the JAX package on the CPU.

Tolerances: the numpy f64 host paths (``estimate_regular_trajectory``)
1e-9 relative; the Fréchet DP computes its distances in f32 in both
packages, and its min/max steps round nothing, so its result and
``estimate_pci``'s are one f32 distance: 1e-6 relative (a few f32 ulps,
from the norm's sum order); the f32 batch path ``estimate_pci_batch``
1e-5 relative."""

import sys

import numpy as np
import pytest

import routeformer_tpu.score.pci  # noqa: F401  (the module, not the function)
import routeformer_torch.score.pci  # noqa: F401
from routeformer_tpu.score.frechet import frechet_distance as jax_frechet
from routeformer_tpu.score.frechet import frechet_distance_batch as jax_frechet_batch
from routeformer_torch.score import frechet_distance, frechet_distance_batch

jp = sys.modules["routeformer_tpu.score.pci"]
tp = sys.modules["routeformer_torch.score.pci"]


def _tracks(rng, n, lin=40, lout=30, offset=1e4):
    """Random-walk GPS tracks in meters far from the origin, as the
    synthetic data's (where f32 rounding of the fit matters most)."""
    inp = np.cumsum(rng.normal(size=(n, lin, 2)) * 3, axis=1)
    inp += rng.uniform(-offset, offset, size=(n, 1, 2))
    tgt = inp[:, -1:] + np.cumsum(rng.normal(size=(n, lout, 2)) * 3, axis=1)
    return inp, tgt


@pytest.mark.parametrize("n_p,n_q", [(1, 1), (1, 5), (6, 1), (5, 7), (30, 30), (12, 4)])
def test_frechet_matches_jax(rng, n_p, n_q):
    p = rng.normal(size=(4, n_p, 2)) * 10
    q = rng.normal(size=(4, n_q, 2)) * 10
    got = frechet_distance_batch(p, q)
    want = np.asarray(jax_frechet_batch(p, q))
    assert got.dtype == np.float32 and got.shape == (4,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    single = frechet_distance(p[0], q[0])
    assert single == pytest.approx(float(jax_frechet(p[0], q[0])), rel=1e-6)


def test_frechet_known_values():
    """Identical polylines are 0 apart; a shifted copy by the shift; the
    DP takes the bottleneck, not the sum."""
    p = np.array([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0]])
    assert frechet_distance(p, p) == 0.0
    assert frechet_distance(p, p + [0.0, 3.0]) == pytest.approx(3.0)
    assert frechet_distance(p, np.array([[0.0, 0.0], [2.0, 0.0]])) == pytest.approx(1.0)


@pytest.mark.parametrize("curve_type", ["linear", "quadratic"])
def test_host_pci_matches_jax(rng, curve_type):
    inp, tgt = _tracks(rng, 3)
    for i in range(3):
        got = tp.estimate_regular_trajectory(inp[i], 30, curve_type, frequency=5)
        want = jp.estimate_regular_trajectory(inp[i], 30, curve_type, frequency=5)
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
        value, regular = tp.estimate_pci(inp[i], tgt[i], curve_type, frequency=5,
                                         return_regular_trajectory=True)
        assert value == pytest.approx(jp.estimate_pci(inp[i], tgt[i], curve_type,
                                                      frequency=5), rel=1e-6)
        np.testing.assert_array_equal(regular, got)
        mse = tp.estimate_pci(inp[i], tgt[i], curve_type, frequency=5, measure="mse")
        assert mse == pytest.approx(jp.estimate_pci(inp[i], tgt[i], curve_type,
                                                    frequency=5, measure="mse"), rel=1e-9)


def test_constrained_quadratic_matches_jax(rng):
    """The scipy SLSQP fit: the same problem and start give the same
    iterates in f64."""
    inp, _ = _tracks(rng, 2, offset=10.0)
    constraints = {"max_speed": 5.0, "max_accel": 2.0}
    for i in range(2):
        got = tp.estimate_regular_trajectory(inp[i], 30, "constrained_quadratic",
                                             constraints=constraints, frequency=5)
        want = jp.estimate_regular_trajectory(inp[i], 30, "constrained_quadratic",
                                              constraints=constraints, frequency=5)
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_pci_rejects_bad_arguments(rng):
    inp, tgt = _tracks(rng, 1)
    with pytest.raises(ValueError):
        tp.estimate_regular_trajectory(inp[0][:3], 30, lookback_length=6)
    with pytest.raises(ValueError):
        tp.estimate_regular_trajectory(inp[0], 30, "constrained_quadratic")
    with pytest.raises(ValueError):
        tp.estimate_regular_trajectory(inp[0], 30, "cubic")
    with pytest.raises(ValueError):
        tp.pci(tgt[0], tgt[0], measure="l1")


@pytest.mark.parametrize("curve_type,lookback,offset", [
    ("linear", 6, 1e4), ("quadratic", 6, 1e4), ("linear", 6, 10.0),
    ("quadratic", 6, 10.0), ("linear", 10, 10.0)])
def test_pci_batch_matches_jax(rng, curve_type, lookback, offset):
    """The data path's lookback (6) on tracks 1e4 m from the origin, as the
    synthetic data's; a longer lookback near the origin. Both programs fit
    in f32, so a track far from the origin makes each differ from the f64
    fit: at lookback 6 the port rounds as XLA does (same products and sum
    order, the mapped time by one fused multiply-add, LU with reciprocal
    pivots), at lookback 10 and 1e4 m XLA fuses differently and the two
    f32 results part by up to 2e-3, as far as JAX's is from the f64 path
    (and the quadratic fit at lookback 10 by ~1e-5 even near the origin)."""
    inp, tgt = _tracks(rng, 128, offset=offset)
    got = tp.estimate_pci_batch(inp, tgt, curve_type, lookback_length=lookback, frequency=5)
    want = jp.estimate_pci_batch(inp, tgt, curve_type, lookback_length=lookback, frequency=5)
    assert got.dtype == np.float32 and got.shape == (128,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
