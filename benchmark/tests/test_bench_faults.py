"""``correct`` comes out false when the timed path is broken underneath the
rest of a run (at a tiny size on the CPU, the card's look skipped), and
for the control: the reference in the precision below the configuration's,
put in the program's place."""

import time

import pytest
import torch

from benchmark import check, control, loops
from benchmark.tests import tiny


def _train(build):
    return loops.train_step(tiny.config("swinv2"), tiny.mix("train_b16"), 2 ** 31 + 5, 0.2,
                            False, "cpu", time.perf_counter(), build=build)


def test_a_step_that_leaves_its_state_unchanged_fails(monkeypatch):
    monkeypatch.setenv("ROUTEFORMER_FUSION_KERNEL", "1")

    def build(cfg, seed, device):
        model, optimizer, step = tiny.build_train_f32(cfg, seed, device)

        def unchanged(*args):
            params = {n: p.detach().clone() for n, p in model.named_parameters()}
            state = optimizer.opt.state_dict()
            metrics = step(*args)
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(params[n])
            optimizer.opt.state.clear()
            optimizer.opt.load_state_dict(state)
            return metrics

        return model, optimizer, unchanged

    out = _train(build)
    assert not check.judge(out.numbers, check.limits("swinv2_train_b16")), out.numbers
    assert out.numbers["change_gap_median"] == 1.0


def test_a_step_on_half_the_batch_fails(monkeypatch):
    """The forward on the whole batch, the loss over its first half."""
    monkeypatch.setenv("ROUTEFORMER_FUSION_KERNEL", "1")
    from routeformer_torch.losses import FutureDiscountedLoss

    whole = FutureDiscountedLoss.__call__

    def half(self, y_pred, y_true, epoch=0):
        n = y_pred.shape[0] // 2
        return whole(self, y_pred[:n], y_true[:n], epoch)

    monkeypatch.setattr(FutureDiscountedLoss, "__call__", half)
    out = _train(tiny.build_train_f32)
    assert out.numbers["frame_gap"] < 1e-5  # the forward is whole
    assert not check.judge(out.numbers, check.limits("swinv2_train_b16")), out.numbers


class _Altered:
    """The serving model with its answer altered where it is produced."""

    def __init__(self, serving, alter):
        self.serving, self.model, self.alter = serving, serving.model, alter

    def __call__(self, batch):
        gps, dense = self.serving(batch)
        return self.alter(gps), dense


@pytest.mark.parametrize("alter", [
    lambda gps: gps + 0.5 * torch.arange(gps.shape[1])[None, :, None],  # every later step
    lambda gps: torch.cat([gps[:, :1] + 1.0, gps[:, 1:]], dim=1),  # the first step, 1 m
], ids=["drift", "first_step"])
def test_an_answer_altered_where_it_is_produced_fails(monkeypatch, alter):
    monkeypatch.setenv("ROUTEFORMER_FUSION_KERNEL", "1")
    out = loops.closed_loop(tiny.config("vit"), tiny.mix("serve_b1"), 12345, 0.5, False, "cpu",
                            time.perf_counter(),
                            build=lambda *a: _Altered(tiny.build_serve_f32(*a), alter))
    assert not check.judge(out.numbers, check.limits("dinov2_serve_b1")), out.numbers


def test_the_control_comes_out_not_correct(monkeypatch):
    monkeypatch.setenv("ROUTEFORMER_FUSION_KERNEL", "1")
    train = control.train_readings(tiny.config("swinv2"), tiny.mix("train_b16"), 5, "cpu",
                                   ["control"])
    assert not check.judge(train["control"], check.limits("swinv2_train_b16")), train
    serve = control.serve_readings(tiny.config("vit"), tiny.mix("serve_b1"), 5, "cpu",
                                   ["control"])
    assert not check.judge(serve["control"], check.limits("dinov2_serve_b1")), serve
