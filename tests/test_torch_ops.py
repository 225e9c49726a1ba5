"""The port's small modules against the JAX package on the CPU: the
ProbSparse key sample (bit-exact), vector/filter utilities, uint8
dequantisation (bit-exact), the synthetic batch (bit-exact), the
attention functions and the bilinear resize. Inputs are made from a
seed with numpy and fed to both."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from routeformer_tpu.io.synthetic import SyntheticDataset as JaxSyntheticDataset
from routeformer_tpu.io.synthetic import synthetic_batch as jax_synthetic_batch
from routeformer_tpu.ops.attention import dot_product_attention as jax_dense
from routeformer_tpu.ops.attention import prob_sparse_attention as jax_prob
from routeformer_tpu.ops.image import to_float16 as jax_to_float16
from routeformer_tpu.utils.filter import median_downsampler as jax_median
from routeformer_tpu.utils.vector import estimate_angle as jax_estimate_angle
from routeformer_tpu.utils.vector import estimate_angle_and_norm as jax_angle_norm
from routeformer_tpu.utils.vector import rotate as jax_rotate
from routeformer_torch.io.synthetic import SyntheticDataset, synthetic_batch_numpy
from routeformer_torch.ops.image import resize_bilinear
from routeformer_torch.ops.attention import (
    dot_product_attention,
    prob_sparse_attention,
    prob_sparse_sizes,
)
from routeformer_torch.ops.image import dequantize_videos, to_float16
from routeformer_torch.utils import prng
from routeformer_torch.utils.filter import median_downsampler
from routeformer_torch.utils.vector import estimate_angle, estimate_angle_and_norm, rotate


def _sample_shapes():
    """Every (l_q, u_part, l_k) the flagship eval forward draws."""
    shapes = set()
    for l in (65, 160, 40):  # Perceive, factor 5: frame, video, gaze/decoder
        shapes.add((l, prob_sparse_sizes(l, l, 5)[1], l))
    for l in (40, 21, 12, 7, 5, 4, 70):  # Informer encoder (distilled), decoder
        shapes.add((l, prob_sparse_sizes(l, l, 4)[1], l))
    shapes.add((70, prob_sparse_sizes(70, 4, 4)[1], 4))  # cross-attention
    return sorted(shapes)


@pytest.mark.parametrize("l_q,u_part,l_k", _sample_shapes())
def test_prng_index_sample_bit_exact(l_q, u_part, l_k):
    assert u_part <= l_k
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (l_q, u_part), 0, l_k))
    got = prng.prob_sparse_index_sample(l_q, u_part, l_k)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 7, 123456789])
def test_prng_split_and_randint_other_seeds(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng.split(prng.prng_key(seed)),
                                  np.asarray(jax.random.split(key)))
    np.testing.assert_array_equal(
        prng.randint(prng.prng_key(seed), (13, 9), 3, 1000),
        np.asarray(jax.random.randint(key, (13, 9), 3, 1000)),
    )


def test_vector_and_filter(rng):
    x = rng.normal(size=(3, 17, 2)).astype(np.float32)
    ang = rng.normal(size=(3, 1)).astype(np.float32)
    np.testing.assert_allclose(
        rotate(torch.from_numpy(x), torch.from_numpy(ang)).numpy(),
        np.asarray(jax_rotate(jnp.asarray(x), jnp.asarray(ang))), atol=1e-6)
    a, n = estimate_angle_and_norm(torch.from_numpy(x))
    ja, jn = jax_angle_norm(jnp.asarray(x))
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=1e-6)
    np.testing.assert_allclose(n.numpy(), np.asarray(jn), atol=1e-6)
    g = rng.normal(size=(2, 200, 2)).astype(np.float32)
    for target in (40, 30, 7):  # even and odd windows: the lower median
        np.testing.assert_array_equal(
            median_downsampler(torch.from_numpy(g), target).numpy(),
            np.asarray(jax_median(jnp.asarray(g), target)))


@pytest.mark.parametrize("shape,dtype", [((3, 17, 2), np.float32), ((5, 2), np.float64),
                                         ((2,), np.float32)])
def test_estimate_angle_matches_jax(rng, shape, dtype):
    """``(*, 2)`` in, ``(*, 1)`` f32 out; f32 atan2 at 1e-6."""
    x = rng.normal(size=shape).astype(dtype)
    got = estimate_angle(torch.from_numpy(x))
    want = np.asarray(jax_estimate_angle(jnp.asarray(x)))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[:-1] + (1,) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_dequantize_bit_exact_all_uint8():
    u8 = np.arange(256, dtype=np.uint8).reshape(1, 1, 16, 16, 1)
    got = to_float16(torch.from_numpy(u8)).numpy()
    np.testing.assert_array_equal(got.view(np.uint16),
                                  np.asarray(jax_to_float16(u8)).view(np.uint16))
    batch = dequantize_videos({"left_video": torch.from_numpy(u8),
                               "gps": torch.zeros(1, 2)})
    assert batch["left_video"].dtype == torch.float16
    assert batch["gps"].dtype == torch.float32


@pytest.mark.parametrize("causal", [False, True])
def test_dense_attention(rng, causal):
    q, k, v = (rng.normal(size=(2, 12, 4, 8)).astype(np.float32) for _ in range(3))
    got = dot_product_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    want, _ = jax_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal, impl="jax")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


@pytest.mark.parametrize("causal,l_k", [(False, 40), (True, 40), (False, 4)])
def test_prob_sparse_non_exhaustive(rng, causal, l_k):
    """Factor 1 keeps u < L, so the measure, the threshold and the context
    rows all matter; the port draws the eval key sample itself."""
    l_q = 40
    q = rng.normal(size=(2, l_q, 4, 8)).astype(np.float32)
    k, v = (rng.normal(size=(2, l_k, 4, 8)).astype(np.float32) for _ in range(2))
    if causal:
        assert prob_sparse_sizes(l_q, l_k, 1)[0] < l_q
    got = prob_sparse_attention(*map(torch.from_numpy, (q, k, v)),
                                factor=1, causal=causal)
    want, _ = jax_prob(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       factor=1, causal=causal, sample_rng=jax.random.PRNGKey(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


def test_prob_sparse_explicit_index_sample(rng):
    q, k, v = (rng.normal(size=(1, 20, 2, 8)).astype(np.float32) for _ in range(3))
    u, u_part = prob_sparse_sizes(20, 20, 2)
    idx = rng.integers(0, 20, size=(20, u_part))
    a = prob_sparse_attention(*map(torch.from_numpy, (q, k, v)), factor=2,
                              index_sample=idx)
    b = prob_sparse_attention(*map(torch.from_numpy, (q, k, v)), factor=2,
                              index_sample=torch.from_numpy(idx))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert a.shape == (1, 20, 2, 8) and math.isfinite(float(a.abs().max()))


def test_synthetic_batch_matches_jax_package():
    """The port's copy gives the same arrays from the same seed, bit for bit
    (GEM geometry, video and gaze), and each sample's PCI (the f32 batch
    path) within 1e-5 relative."""
    kw = dict(seq_len=40, pred_len=30, fps=5, with_video=True, with_gaze=True,
              frame_hw=(54, 96))
    want = jax_synthetic_batch(3, 2, **kw)
    got = synthetic_batch_numpy(3, 2, **kw)
    assert set(got) == set(want)
    for split in ("train", "target"):
        assert set(got[split]) == set(want[split])
        for k, v in want[split].items():
            np.testing.assert_array_equal(got[split][k], v)
    assert got["pci"].dtype == np.float32 and got["pci"].shape == (2,)
    np.testing.assert_allclose(got["pci"], want["pci"], rtol=1e-5, atol=0)


@pytest.mark.parametrize("with_video", [False, True])
def test_synthetic_dataset_matches_jax_package(with_video):
    """``SyntheticDataset`` items equal the JAX package's: the arrays
    exactly, ``pci`` within 1e-5 relative; out-of-range indices raise."""
    kw = dict(n_batches=3, batch_size=4, fps=5, with_video=with_video,
              with_gaze=with_video, seed=2)
    port, ref = SyntheticDataset(**kw), JaxSyntheticDataset(**kw)
    assert len(port) == len(ref) == 3
    for i in (0, 2):
        got, want = port[i], ref[i]
        for split in ("train", "target"):
            assert set(got[split]) == set(want[split])
            for k, v in want[split].items():
                np.testing.assert_array_equal(got[split][k], v)
        np.testing.assert_allclose(got["pci"], want["pci"], rtol=1e-5, atol=0)
    with pytest.raises(IndexError):
        port[3]


@pytest.mark.parametrize("hw,size", [((24, 24), 64), ((96, 96), 40), ((96, 96), 256)])
def test_resize_matches_jax_image_resize(rng, hw, size):
    """Upsampling and antialiased downsampling against jax.image.resize."""
    x = rng.uniform(size=(2, *hw, 3)).astype(np.float32)
    got = resize_bilinear(torch.from_numpy(x), size).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, size, size, 3), "bilinear"))
    np.testing.assert_allclose(got, want, atol=2e-6)
