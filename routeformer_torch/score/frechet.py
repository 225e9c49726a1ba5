"""Discrete Fréchet distance (counterpart of
``routeformer_tpu/score/frechet.py``).

The dynamic program

    ca[i, j] = max(d(p_i, q_j), min(ca[i-1, j], ca[i-1, j-1], ca[i, j-1]))

runs over anti-diagonals ``i + j = k``: every cell of one diagonal depends
only on the two diagonals before it, so each step is one vectorised numpy
operation over the diagonal and the batch. The distances are computed in
f32, as the JAX package's jitted DP computes them; the max/min steps round
nothing, so the result is one of those f32 distances.
"""

import numpy as np


def _pairwise(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """``(B, P, D) x (B, Q, D) -> (B, P, Q)`` f32 Euclidean distances."""
    diff = p[:, :, None, :] - q[:, None, :, :]
    return np.sqrt(np.sum(diff * diff, axis=-1))


def frechet_distance_batch(p, q) -> np.ndarray:
    """Batched discrete Fréchet distance: ``(B, P, D) x (B, Q, D) -> (B,)``
    f32 (``frechetdist.frdist`` semantics, Euclidean ground metric)."""
    p = np.asarray(p, dtype=np.float32)
    q = np.asarray(q, dtype=np.float32)
    d = _pairwise(p, q)
    b, n_p, n_q = d.shape
    inf = np.float32(np.inf)
    ca = np.full((b, n_p, n_q), inf, dtype=np.float32)
    for k in range(n_p + n_q - 1):
        i = np.arange(max(0, k - n_q + 1), min(k, n_p - 1) + 1)
        j = k - i
        if k == 0:
            ca[:, 0, 0] = d[:, 0, 0]
            continue
        up = np.where(i > 0, ca[:, np.maximum(i - 1, 0), j], inf)
        diag = np.where((i > 0) & (j > 0), ca[:, np.maximum(i - 1, 0), np.maximum(j - 1, 0)], inf)
        left = np.where(j > 0, ca[:, i, np.maximum(j - 1, 0)], inf)
        ca[:, i, j] = np.maximum(d[:, i, j], np.minimum(np.minimum(up, diag), left))
    return ca[:, -1, -1]


def frechet_distance(p, q) -> np.float32:
    """Discrete Fréchet distance between polylines ``p`` (P, D) and ``q``
    (Q, D)."""
    return frechet_distance_batch(np.asarray(p)[None], np.asarray(q)[None])[0]
