"""Several ranks of the ``(data, model)`` mesh on the CPU over gloo
(counterpart of ``__graft_entry__.dryrun_multichip``).

``launch("module:function", n, arg)`` runs ``function(rank, n, arg)`` in
``n`` subprocesses joined in a gloo process group (a ``file://``
rendezvous in a fresh directory, one torch thread each, every collective
limited to ``pg_timeout_s``) and returns each rank's return value; a rank
that fails, or a launch that outlives ``timeout_s``, stops every rank and
raises with the ranks' output. ``dryrun_multichip(n)`` runs the JAX
dryrun's four phases on the tiny flagship (``min_shard_dim=32``):

1. a train step on the ``(n / 2, 2)`` mesh (``(n, 1)`` for odd ``n``) and
   an FSDP step;
2. the trainer's step and MC eval under the mesh;
3. a snapshot saved, restored into a fresh trainer, and its next step;
4. on the pure data-parallel ``(n, 1)`` mesh, the frame store (a warm
   batch ships 0 frames) and the device memo (a warm batch encodes 0).

    python -c "from routeformer_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(4)"
"""

import importlib
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
_CHILD = "import sys; from routeformer_torch.parallel.dryrun import _rank_main; _rank_main(*sys.argv[1:])"


def _rank_main(target: str, rank: str, n: str, workdir: str, pg_timeout_s: str) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, n, work = int(rank), int(n), Path(workdir)
    dist.init_process_group("gloo", init_method=f"file://{work / 'rendezvous'}", rank=rank,
                            world_size=n,
                            timeout=datetime.timedelta(seconds=float(pg_timeout_s)))
    try:
        module, name = target.split(":")
        with open(work / "arg.pkl", "rb") as fh:
            arg = pickle.load(fh)
        result = getattr(importlib.import_module(module), name)(rank, n, arg)
        with open(work / f"rank{rank}.pkl.tmp", "wb") as fh:
            pickle.dump(result, fh)
        os.rename(work / f"rank{rank}.pkl.tmp", work / f"rank{rank}.pkl")
    finally:
        dist.destroy_process_group()


def _tail(path: Path, n: int = 4000) -> str:
    try:
        return path.read_text(errors="replace")[-n:]
    except OSError:
        return ""


def launch(target: str, n: int, arg=None, timeout_s: float = 300.0,
           pg_timeout_s: float = 60.0, pythonpath=()) -> list:
    """``[function(rank, n, arg) for each rank]`` from ``n`` gloo CPU ranks
    (``target`` is ``"module:function"``, importable with ``pythonpath``
    added; ``arg`` and the results are pickled)."""
    work = Path(tempfile.mkdtemp(prefix="routeformer_mesh_"))
    try:
        with open(work / "arg.pkl", "wb") as fh:
            pickle.dump(arg, fh)
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT), *map(str, pythonpath), os.environ.get("PYTHONPATH", "")]))
        env.pop("LOCAL_RANK", None)
        procs = []
        for rank in range(n):
            log = open(work / f"rank{rank}.log", "wb")
            procs.append((subprocess.Popen(
                [sys.executable, "-c", _CHILD, target, str(rank), str(n), str(work),
                 str(pg_timeout_s)], env=dict(env, RANK=str(rank), WORLD_SIZE=str(n)),
                stdout=log, stderr=subprocess.STDOUT, cwd=str(ROOT)), log))
        deadline = time.monotonic() + timeout_s
        failed = None
        try:
            while any(p.poll() is None for p, _ in procs):
                failed = next((r for r, (p, _) in enumerate(procs)
                               if p.poll() not in (None, 0)), None)
                if failed is not None or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            failed = next((r for r, (p, _) in enumerate(procs) if p.poll() not in (None, 0)),
                          failed)
        finally:
            timed_out = any(p.poll() is None for p, _ in procs)
            for p, log in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
                log.close()
        if failed is not None or timed_out:
            what = (f"rank {failed} exited with {procs[failed][0].returncode}"
                    if failed is not None else f"timed out after {timeout_s:.0f} s")
            logs = "\n".join(f"--- rank {r} ---\n{_tail(work / f'rank{r}.log')}"
                             for r in range(n))
            raise RuntimeError(f"launch {target} on {n} gloo ranks: {what}\n{logs}")
        results = []
        for rank in range(n):
            with open(work / f"rank{rank}.pkl", "rb") as fh:
                results.append(pickle.load(fh))
        return results
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ------------------------------------------------------------- dryrun -- #


def tiny_flagship_config():
    """The JAX dryrun's tiny flagship (``__graft_entry__._flagship_config(
    tiny=True)``)."""
    from routeformer_torch.models import RouteformerConfig
    from routeformer_torch.models.gps_backbone import GPSBackboneConfig
    from routeformer_torch.models.video_backbone import TimmBackboneConfig

    gps = GPSBackboneConfig(seq_len=8, label_len=8, pred_len=6, d_model=32, n_heads=4,
                            e_layers=2, d_layers=1, d_ff=64, factor=2, dropout=0.0,
                            activation="relu", distil=True)
    return RouteformerConfig(
        gps_backbone_config=gps,
        video_backbone_config=TimmBackboneConfig(model_type="vit_tiny_test"),
        with_video=True, with_gaze=True, dense_prediction=True, dense_loss_ratio=0.5,
        decoder_mode="smart", discount_factor={0: 0.97, 100: 0.98, 200: 0.99},
        epsilon=1.0, visual_epsilon=0.3, image_embedding_size=16, encoder_hidden_size=16,
        encoder_heads=4, encoder_layers=2, encoder_d_ff=32, cross_modal_decoder_heads=4,
        cross_modal_decoder_layers=1, view_dropout=0.6, gaze_dropout=0.2,
        feature_dropout=0.05, output_fps=2, video_fps=1, gaze_fps=1)


def _model(cfg, seed: int):
    from routeformer_torch.flagship import init_weights
    from routeformer_torch.models import Routeformer

    model = Routeformer(cfg)
    init_weights(model, seed=seed)
    return model


def _optimizer(module):
    from routeformer_torch.optimizers import build_optimizer

    return build_optimizer(module, learning_rate=1e-5, weight_decay=1e-4,
                           video_backbone_lr=1e-6, warmup_epochs=2, max_epochs=200,
                           gradient_clip_val=2.5)


def _dryrun_rank(rank: int, n: int, arg) -> list:
    """The four phases on this rank; rank 0 returns the phase lines."""
    import torch

    from routeformer_torch.io.frame_store import MeshFrameStoreRouter
    from routeformer_torch.io.synthetic import synthetic_batch_numpy
    from routeformer_torch.models.video_backbone.cache import (
        MeshDeviceVideoFeaturePrecomputer,
    )
    from routeformer_torch.parallel import make_mesh, make_train_step
    from routeformer_torch.train import CheckpointManager, ParallelTrainer
    from routeformer_torch.train.losses import TrainingLosses, routeformer_training_loss

    lines = []
    n_model = 2 if n % 2 == 0 and n >= 4 else 1
    n_data = n // n_model
    mesh = make_mesh(n_data, n_model, device="cpu")
    cfg = tiny_flagship_config()
    losses = TrainingLosses.from_config(cfg)

    def loss_fn(m, inp, tgt, epoch):
        return routeformer_training_loss(m, inp, tgt, epoch, losses)

    batch = synthetic_batch_numpy(1, 2 * n_data, seq_len=8, pred_len=6, fps=2,
                                  with_video=True, with_gaze=True, frame_hw=(16, 24))
    totals = []
    for fsdp in (False, True):
        model = _model(cfg, seed=0)
        step = make_train_step(model, _optimizer(model), loss_fn, mesh=mesh,
                               min_shard_dim=32, fsdp=fsdp)
        metrics = step(batch["train"], batch["target"], 0)
        totals.append(float(metrics["total_loss"]))
        assert np.isfinite(totals[-1]), f"non-finite loss (fsdp={fsdp}) {totals[-1]}"
    lines.append(f"dryrun phase 1 OK (train+fsdp): mesh=(data={n_data}, model={n_model}), "
                 f"loss={totals[0]:.4f}, grad_norm={float(metrics['grad_norm']):.4f}, "
                 f"fsdp_loss={totals[1]:.4f}")

    def trainer(seed):
        return ParallelTrainer({"flagship": _model(cfg, seed)}, _optimizer, cfg, mesh=mesh,
                               min_shard_dim=32, unfreeze_epoch=None, device="cpu")

    t = trainer(2)
    t.training_step(batch)
    ade = float(t.evaluate([batch], split="val")["val_flagship_ade"])
    assert np.isfinite(ade), f"non-finite mesh eval ADE {ade}"
    lines.append(f"dryrun phase 2 OK (mesh MC eval): val_ade={ade:.4f}")

    ckpt = CheckpointManager(arg["ckpt_dir"])
    t.epoch = 1
    ckpt.save_latest(t, epoch=1, next_batch=0)
    fresh = trainer(3)
    pos = ckpt.restore_latest(fresh)
    assert pos == (1, 0), f"restore_latest returned {pos}"
    post = float(fresh.training_step(batch)["train_total_loss"])
    assert np.isfinite(post), f"non-finite post-restore loss {post}"
    lines.append(f"dryrun phase 3 OK (ckpt save/restore/step): post_restore_loss={post:.4f}")

    mesh_dp = make_mesh(n, 1, device="cpu")
    pool = np.random.default_rng(0).integers(0, 255, size=(12, 16, 24, 3), dtype=np.uint8)
    windows = pool[(np.arange(2 * n)[:, None] + np.arange(4)[None, :]) % 12]
    mine = windows[2 * rank:2 * rank + 2]
    router = MeshFrameStoreRouter(mesh_dp, budget_bytes=64e6, device="cpu")
    assert np.array_equal(router.put("left", windows).numpy(), mine)
    cold = {k: v["shipped"] for k, v in router.stats().items()}
    assert np.array_equal(router.put("left", windows).numpy(), mine)
    warm = {k: v["shipped"] for k, v in router.stats().items()}
    assert warm == cold, f"warm epoch re-shipped frames: {cold} -> {warm}"
    memo_model = _model(cfg, seed=4).eval()
    memo = MeshDeviceVideoFeaturePrecomputer(memo_model, mesh_dp, device="cpu")
    vbatch = {"gps": batch["train"]["gps"], "left_video": batch["train"]["left_video"]}
    vbatch = {k: np.concatenate([v] * (n // n_data)) for k, v in vbatch.items()}
    first = memo(dict(vbatch))
    encoded = memo.stats()["encoded"]
    assert encoded > 0
    again = memo(dict(vbatch))
    assert memo.stats()["encoded"] == encoded, "warm memo pass re-encoded"
    assert torch.equal(again["left_video_features"], first["left_video_features"])
    lines.append(f"dryrun phase 4 OK (mesh transfer tier): shipped={cold}, "
                 f"memo_encoded={encoded}")
    lines.append(f"dryrun_multichip OK: mesh=(data={n_data}, model={n_model}), "
                 f"loss={totals[0]:.4f}, fsdp_loss={totals[1]:.4f}, val_ade={ade:.4f}, "
                 f"post_restore_loss={post:.4f}")
    return lines if rank == 0 else []


def dryrun_multichip(n_devices: int, timeout_s: float = 240.0) -> None:
    """The four phases on ``n_devices`` gloo CPU ranks; prints one line per
    phase, raises if a phase fails or the ranks outlive ``timeout_s``."""
    with tempfile.TemporaryDirectory(prefix="dryrun_ckpt_") as ckpt_dir:
        lines = launch("routeformer_torch.parallel.dryrun:_dryrun_rank", n_devices,
                       {"ckpt_dir": ckpt_dir}, timeout_s=timeout_s)[0]
    for line in lines:
        print(line, flush=True)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
