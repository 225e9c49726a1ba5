"""The eval-mode ProbSparse key sample, worked out on the host: a numpy
copy of ``jax.random.randint(jax.random.PRNGKey(0), (l_q, u_part), 0, l_k)``
(threefry2x32 with 20 rounds, the partitionable counter layout, the
two-draw modulus of ``randint``). Every eval-mode ProbSparse layer of the
model samples its keys with it, so the reference needs it too."""

import functools

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as uint32[2] key data, for the 32-bit
    seeds that JAX takes without x64."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} is not a 32-bit unsigned integer")
    return np.array([0, seed], dtype=np.uint32)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 block cipher on counter words ``(x0, x1)``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = np.asarray(x0, np.uint32).copy()
    x1 = np.asarray(x1, np.uint32).copy()
    with np.errstate(over="ignore"):
        x0 += ks[0]
        x1 += ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 += x1
                x1 = _rotl(x1, r)
                x1 ^= x0
            x0 += ks[(i + 1) % 3]
            x1 += ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _iota_2x32(n: int):
    counts = np.arange(n, dtype=np.uint64)
    return (counts >> np.uint64(32)).astype(np.uint32), (
        counts & np.uint64(0xFFFFFFFF)
    ).astype(np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split`` (fold-like, partitionable): (num, 2) uint32."""
    hi, lo = _iota_2x32(num)
    b1, b2 = threefry2x32(key, hi, lo)
    return np.stack([b1, b2], axis=-1)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """32-bit random bits of ``shape`` (partitionable layout)."""
    n = int(np.prod(shape))
    hi, lo = _iota_2x32(n)
    b1, b2 = threefry2x32(key, hi, lo)
    return (b1 ^ b2).reshape(shape)


def randint(key: np.ndarray, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` for int32."""
    k1, k2 = split(key)
    higher = random_bits(k1, shape)
    lower = random_bits(k2, shape)
    span = np.uint32(maxval - minval) if maxval > minval else np.uint32(1)
    with np.errstate(over="ignore"):
        multiplier = np.uint32((1 << 16) % int(span))
        multiplier = np.uint32((int(multiplier) * int(multiplier)) % int(span))
        offset = (higher % span) * multiplier + (lower % span)
        offset = offset % span
    return (np.int64(minval) + offset.astype(np.int64)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _cached_sample(l_q: int, u_part: int, l_k: int) -> np.ndarray:
    out = randint(prng_key(0), (l_q, u_part), 0, l_k)
    out.setflags(write=False)
    return out


def prob_sparse_index_sample(l_q: int, u_part: int, l_k: int) -> np.ndarray:
    """The eval-mode ProbSparse key sample ``(l_q, u_part)`` int32."""
    return _cached_sample(int(l_q), int(u_part), int(l_k))
