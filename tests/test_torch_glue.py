"""The forward's glue that keeps host constants off the stream: frames
sampled and features scattered back onto the timeline through strided
slices, the image statistics made once per device, and the loss's discount
base filled on the device. Each against the index tensors and host copies
it replaced, bit for bit, on the CPU. (That the train step and a request
then never synchronise is held on the card, in ``test_torch_cuda.py``.)"""

import numpy as np
import pytest
import torch

from routeformer_torch.losses import future_discounted_loss
from routeformer_torch.models.routeformer import (Routeformer, fps_subsample_indices,
                                                  fps_subsample_slice)
from routeformer_torch.ops import image


@pytest.mark.parametrize("relative_fps", range(1, 9))
def test_subsample_slice_picks_the_indices(relative_fps):
    lengths = range(1, 65)
    for length in lengths:
        got = np.arange(length)[fps_subsample_slice(length, relative_fps)]
        np.testing.assert_array_equal(got, fps_subsample_indices(length, relative_fps))
    # the two edges of the slice's start: a last frame on the stride, and one frame
    assert any((n - 1) % relative_fps == 0 and n > 1 for n in lengths)
    assert fps_subsample_slice(1, relative_fps).start == relative_fps


@pytest.mark.parametrize("length,relative_fps", [(40, 5), (30, 5), (9, 4), (7, 1)])
def test_scatter_timeline_is_the_index_assignment(length, relative_fps):
    batch, emb = 3, 6
    idx = fps_subsample_indices(length, relative_fps)
    gen = torch.Generator().manual_seed(length)
    feats = torch.randn(batch * len(idx), emb, generator=gen)
    probe = torch.randn(batch, length, emb, generator=gen)

    def old(f):  # the index assignment the slice replaced
        f = f.reshape(batch, -1, emb)
        full = f.new_zeros(batch, length, emb)
        full[:, torch.as_tensor(idx)] = f
        return full

    def new(f):
        return Routeformer._scatter_timeline(f, batch, length,
                                             fps_subsample_slice(length, relative_fps))

    grads = []
    for scatter in (old, new):
        f = feats.clone().requires_grad_(True)
        out = scatter(f)
        (out * probe).sum().backward()
        grads.append((out.detach(), f.grad))
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
def test_condition_frames_keeps_its_bits_and_reuses_the_statistics(dtype):
    gen = torch.Generator().manual_seed(1)
    frames = torch.rand(2, 12, 10, 3, generator=gen).to(dtype)
    mean, std = (0.5, 0.25, 0.125), (0.3, 0.2, 0.1)  # a key no other test makes
    image._statistics_cache.pop((mean, std, dtype, frames.device), None)

    got = image.condition_frames(frames, 8, mean, std)
    x = image.resize_bilinear(torch.nn.functional.pad(frames, (0, 0, 0, 2)), 8)
    want = ((x - torch.tensor(mean, dtype=dtype)) / torch.tensor(std, dtype=dtype))
    assert got.dtype == dtype and torch.equal(got, want)

    stats = image._statistics_cache[(mean, std, dtype, frames.device)]
    with torch.inference_mode():  # a second call, here from a served forward
        again = image.condition_frames(frames, 8, list(mean), list(std))
    assert torch.equal(again, got)
    assert image._statistics_cache[(mean, std, dtype, frames.device)] is stats
    assert not any(t.is_inference() for t in stats)  # usable under autograd


def test_condition_frames_caches_nothing_while_exporting(monkeypatch):
    mean, std = (0.25, 0.5, 0.75), (1.0, 2.0, 4.0)
    monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    image.condition_frames(torch.rand(1, 4, 4, 3), 4, mean, std)
    assert not any(key[:2] == (mean, std) for key in image._statistics_cache)


@pytest.mark.parametrize("loss_function", ["mae", "mse", "smooth_l1"])
@pytest.mark.parametrize("gamma", [0.97, 0.99, 1.0])
def test_future_discounted_loss_is_the_host_base_formula(loss_function, gamma):
    gen = torch.Generator().manual_seed(2)
    pred, true = torch.randn(2, 2, 30, 5, generator=gen).unbind(0)
    pred.requires_grad_(True)
    got = future_discounted_loss(pred, true, gamma, 0.3, loss_function)
    (g_got,) = torch.autograd.grad(got, pred)

    # the formula with the base copied from the host, as it was
    factors = torch.pow(torch.tensor(gamma, dtype=torch.float32),
                        torch.arange(30, dtype=torch.float32)).reshape(1, -1, 1)
    error = pred - true
    error = torch.where(error.abs() < 0.3, torch.zeros_like(error), error)
    if loss_function == "mae":
        want = (error.abs() * factors).mean()
    elif loss_function == "mse":
        want = (error.square() * factors).mean()
    else:
        diff = (pred - true).abs()
        want = (torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5) * factors).mean()
    (g_want,) = torch.autograd.grad(want, pred)
    assert torch.equal(got, want) and torch.equal(g_got, g_want)
