"""Public names of the JAX package that the port gained with the gaze
heatmaps, held against JAX on the CPU: ``ops.augment.random_erase`` (its
rectangle and its erase) and ``utils.device.init_on_cpu``. The mesh's
``shard_params``/``batch_spec`` are held in ``test_torch_mesh_train.py``,
the GPMF arrays in ``test_torch_gpmf_native.py``, the K1 names in
``test_torch_kernels.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from routeformer_torch.ops import augment
from routeformer_torch.utils import init_on_cpu

H, W = 24, 40


def _jax_rectangle(key, scale, ratio):
    """The rectangle JAX's ``random_erase`` draws from ``key`` (its own
    draws, repeated)."""
    k_area, k_aspect, k_i, k_j = jax.random.split(key, 4)
    area = H * W * jax.random.uniform(k_area, minval=scale[0], maxval=scale[1])
    aspect = jnp.exp(jax.random.uniform(k_aspect, minval=jnp.log(ratio[0]),
                                        maxval=jnp.log(ratio[1])))
    eh = int(jnp.clip(jnp.round(jnp.sqrt(area * aspect)), 1, H))
    ew = int(jnp.clip(jnp.round(jnp.sqrt(area / aspect)), 1, W))
    i = min(int(jax.random.randint(k_i, (), 0, H)), H - eh)
    j = min(int(jax.random.randint(k_j, (), 0, W)), W - ew)
    return i, j, eh, ew


@pytest.mark.parametrize("seed", range(4))
def test_random_erase_applies_jax_rectangle(seed):
    """On the rectangle JAX's draws give, the port's erase gives JAX's
    image exactly (value 0 and 0.5)."""
    from routeformer_tpu.ops.augment import random_erase as jax_erase

    img = np.random.default_rng(seed).uniform(size=(H, W, 3)).astype(np.float32)
    scale, ratio = ((0.02, 0.2), (0.3, 3.3)) if seed % 2 else ((0.1, 0.5), (0.5, 2.0))
    for value in (0.0, 0.5):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax_erase(jnp.asarray(img), key, scale=scale, ratio=ratio,
                                    value=value))
        i, j, eh, ew = _jax_rectangle(key, scale, ratio)
        draws = {k: torch.tensor([v]) for k, v in
                 (("erase_top", i), ("erase_left", j), ("erase_h", eh), ("erase_w", ew))}
        got = augment.erase_rectangle(torch.from_numpy(img)[None], draws, value)[0]
        np.testing.assert_array_equal(got.numpy(), want)


def test_random_erase_draws_a_rectangle_in_bounds():
    """The port's draw: one rectangle a frame, inside the frame, its area
    within ``scale`` of the frame's up to the rounding of its sides, the
    same from the same generator seed, and ``draw_augment``'s draws."""
    frames = torch.ones(64, H, W, 3)
    out = augment.random_erase(frames, torch.Generator().manual_seed(3))
    again = augment.random_erase(frames, torch.Generator().manual_seed(3))
    assert torch.equal(out, again)
    for f in out:
        rows = (f == 0).all(-1).any(1).nonzero().flatten()
        cols = (f == 0).all(-1).any(0).nonzero().flatten()
        eh, ew = len(rows), len(cols)
        assert (f == 0).all(-1).sum() == eh * ew  # one rectangle
        assert rows.max() - rows.min() + 1 == eh and cols.max() - cols.min() + 1 == ew
        assert 0.5 * 0.02 * H * W <= eh * ew <= 1.5 * 0.2 * H * W
    one = augment.random_erase(torch.ones(H, W, 3), torch.Generator().manual_seed(3),
                               value=0.25)
    assert one.shape == (H, W, 3) and (one == 0.25).any()


def test_init_on_cpu_builds_modules_on_the_cpu():
    from routeformer_tpu.utils.device import init_on_cpu as jax_init_on_cpu

    with init_on_cpu():
        layer = torch.nn.Linear(3, 4)
        t = torch.zeros(2)
    assert layer.weight.device.type == "cpu" and t.device.type == "cpu"
    with jax_init_on_cpu():  # the JAX context: the host CPU device as well
        assert jnp.zeros(2).devices().pop().platform == "cpu"
