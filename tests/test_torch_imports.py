"""The port stands alone: no module of ``routeformer_torch`` (nor
``chip_smoke.py``) imports jax, flax or routeformer_tpu; entry points
default to CUDA and raise without it; ``chip_smoke.py`` fails without a
card and without the package."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import routeformer_torch
from routeformer_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]

_BLOCKER = r"""
import importlib.abc, importlib.util, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flax", "routeformer_tpu")
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import routeformer_torch
names = [m.name for m in pkgutil.walk_packages(routeformer_torch.__path__,
                                                "routeformer_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(len(names), "modules")
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_and_chip_smoke_import_no_jax():
    out = subprocess.run([sys.executable, "-c", _BLOCKER], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[0]) >= 25


_HOST_BLOCKER = _BLOCKER.replace(
    'BLOCKED = ("jax", "jaxlib", "flax", "routeformer_tpu")',
    'BLOCKED = ("jax", "jaxlib", "flax", "routeformer_tpu", "cv2", "msgpack", "zstandard", '
    '"pandas")') + r"""
import tempfile
from pathlib import Path
from routeformer_torch.io.dataset import GEMDataset
from routeformer_torch.io.gem_fixture import build_gem_fixture
from routeformer_torch.io.loader import DataLoader
root = Path(tempfile.mkdtemp())
build_gem_fixture(root, duration_s=16.0, subject="002", turn=1.0)
ds = GEMDataset(root=root, split="val", min_pci=None, gopro_scaling_factor=0.5,
                front_scaling_factor=0.5, use_cache=True, cache_dir=root / "cache")
item = ds[0]
shapes = {k: v.shape for k, v in item["train"].items()}
assert shapes == {"left_video": (40, 24, 12, 3), "right_video": (40, 24, 12, 3),
                  "front_video": (40, 24, 32, 3), "gps": (40, 2), "gaze": (1600, 2)}, shapes
batch = next(iter(DataLoader(ds, batch_size=1, to_device=True, h2d_dedup=True,
                             device="cpu")))
assert tuple(batch["target"]["front_video"].shape) == (1, 30, 24, 32, 3)
leaked = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("item read")
"""


def test_gem_data_path_needs_no_host_package():
    """With jax, cv2, msgpack, zstandard and pandas all blocked (the card's
    machine has none of the last four), the port builds a ``GEMDataset``
    over its raw recording (sample cache on), reads a multimodal item and
    places a deduplicated batch."""
    out = subprocess.run([sys.executable, "-c", _HOST_BLOCKER], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-2:] == ["item", "read"]


_DREYEVE_BLOCKER = _HOST_BLOCKER.split("import tempfile")[0] + r"""
import tempfile
from pathlib import Path
from routeformer_torch.experiments import full_comparison as fc
from routeformer_torch.io.dreyeve_fixture import build_dreyeve_fixture
root = build_dreyeve_fixture(Path(tempfile.mkdtemp()), session_ids=(1, 45), duration_s=16.0,
                             sparse=True)
s = fc.Settings.from_env({"DATASET": "DREYEVE", "DEBUG": "1", "BATCH_SIZE": "1",
                          "MODEL_SET": "flagship", "DREYEVE_DATASET_DIR": str(root)})
train, val = fc.build_data(s, device="cpu")
fc.attach_prepare(s, (train, val), fc.make_prepare(None, split_video=s.split_video),
                  device_memo=False, host_stage=False)
train.set_epoch(0)
batch = next(iter(train))
shapes = {k: tuple(v.shape) for k, v in batch["train"].items()}
assert shapes == {"left_video": (1, 40, 7, 12, 3), "right_video": (1, 40, 7, 13, 3),
                  "front_video": (1, 40, 12, 21, 3), "gps": (1, 40, 2),
                  "gaze": (1, 80, 2)}, shapes
try:
    from routeformer_torch.io.stitcher import ImageStitcher
    ImageStitcher(device="cpu")
    raise AssertionError("the stitcher built without cv2")
except ImportError as e:
    assert "cv2" in str(e), e
leaked = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("batch placed")
"""


def test_dreyeve_data_path_needs_no_host_package():
    """With jax, cv2, msgpack, zstandard and pandas all blocked: the driver
    builds the DR(eye)VE splits over BMP frames, and a loader places a
    batch with the left-video split; the stitcher refuses, naming cv2."""
    out = subprocess.run([sys.executable, "-c", _DREYEVE_BLOCKER], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-2:] == ["batch", "placed"]


# torch.export asks importlib whether pandas and others exist: the host
# packages are made absent (None in sys.modules), not refused.
_AUDIO_BLOCKER = _BLOCKER + r"""
HOST = ("cv2", "msgpack", "zstandard", "pandas", "av")
for name in list(sys.modules):
    if name.split(".")[0] in HOST:
        del sys.modules[name]
sys.modules.update({name: None for name in HOST})
opened = []


def audit(event, args):
    if event == "open":
        opened.append(str(args[0]))
    elif event == "ctypes.dlopen":
        opened.append(str(args[0]))
    elif event == "subprocess.Popen":
        opened.extend(str(a) for a in args[1])


sys.addaudithook(audit)
import tempfile
from pathlib import Path
import numpy as np
from routeformer_torch import ExportedModel, export_model
from routeformer_torch.io import gpmf
from routeformer_torch.io.dataset import GEMDataset
from routeformer_torch.io.gem_fixture import build_gem_fixture, gpmf_stream, make_trajectory
from routeformer_torch.io.mp4 import read_gpmf_data
from routeformer_torch.models import Routeformer, RouteformerConfig
from routeformer_torch.models.gps_backbone import GPSBackboneConfig
from routeformer_torch.serve import _eval_forward
root = Path(tempfile.mkdtemp())
build_gem_fixture(root, duration_s=16.0, subject="002", turn=1.0, with_audio=True)
ds = GEMDataset(root=root, split="val", min_pci=None, with_video=False, with_audio=True)
item = ds[0]["train"]
assert item["front_audio"].shape == (ds.input_audio_frame_count, 1), item["front_audio"].shape
data = read_gpmf_data(root / "01GoPro/002/left/GH010008.MP4")
assert gpmf.build_gps_points(data) == gpmf.build_gps_points(data, prefer_native=False)
model = Routeformer(RouteformerConfig(gps_backbone_config=GPSBackboneConfig(
    seq_len=8, label_len=8, pred_len=4, d_model=16, n_heads=2, e_layers=1, d_layers=1,
    d_ff=16, factor=4)))
batch = {"gps": np.zeros((1, 8, 2), np.float32)}
assert ExportedModel(export_model(model, batch), _eval_forward(model)[1])(batch).shape == (1, 4, 2)
native_dir = str(Path("native").resolve())
touched = sorted({p for p in opened if p.startswith(native_dir) or "/native/" in p})
assert not touched, touched
assert any("csrc/gpmf.cpp" in p or "librfgpmf_" in p for p in opened), opened[-20:]
leaked = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED
                or (n.split(".")[0] in HOST and sys.modules[n] is not None))
assert not leaked, leaked
print("audio read")
"""


def test_audio_gpmf_and_export_need_no_host_package():
    """With jax, cv2, msgpack, zstandard, pandas and PyAV blocked:
    ``io/audio.py`` reads a recording's PCM tracks through the dataset,
    ``io/gpmf_native.py`` walks its GPMF (the same points as the Python
    walker), ``serve.py`` exports and serves a model; no path under
    ``native/`` is opened, loaded or compiled (the host libraries come
    from ``routeformer_torch/csrc/``)."""
    out = subprocess.run([sys.executable, "-c", _AUDIO_BLOCKER], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-2:] == ["audio", "read"]


# torch's optimizers import torch._dynamo, which probes for pandas with
# find_spec when it is first imported: it is imported before the blocker
# (the card's machine has no pandas, and the probe then finds none).
_MESH_BLOCKER = "import torch._dynamo\n" + _HOST_BLOCKER.split("import tempfile")[0] + r"""
import datetime
import tempfile
from pathlib import Path
import numpy as np
import torch
import torch.distributed as dist
from routeformer_torch.io.frame_store import MeshFrameStoreRouter
from routeformer_torch.io.synthetic import synthetic_batch_numpy
from routeformer_torch.models.video_backbone.cache import MeshDeviceVideoFeaturePrecomputer
from routeformer_torch.parallel import make_mesh
from routeformer_torch.parallel.dryrun import _model, _optimizer, tiny_flagship_config
from routeformer_torch.train import CheckpointManager, ParallelTrainer
work = Path(tempfile.mkdtemp())
dist.init_process_group("gloo", init_method=f"file://{work / 'rdv'}", rank=0, world_size=1,
                        timeout=datetime.timedelta(seconds=60))
mesh = make_mesh(1, 1, device="cpu")
cfg = tiny_flagship_config()
batch = synthetic_batch_numpy(1, 2, seq_len=8, pred_len=6, fps=2, with_video=True,
                              with_gaze=True, frame_hw=(16, 24))
memo = MeshDeviceVideoFeaturePrecomputer(_model(cfg, 1).eval(), mesh, device="cpu")
assert memo(dict(batch["train"]))["left_video_features"].shape[0] == 2
router = MeshFrameStoreRouter(mesh, budget_bytes=1e6, device="cpu")
assert router.put("left", np.zeros((2, 3, 4, 4, 3), np.uint8)).shape == (2, 3, 4, 4, 3)
trainer = ParallelTrainer({"flagship": _model(cfg, 0)}, _optimizer, cfg, mesh=mesh,
                          min_shard_dim=32, fsdp=True, unfreeze_epoch=None, device="cpu")
assert np.isfinite(float(trainer.training_step(batch)["train_total_loss"]))
CheckpointManager(work / "ckpt").save_latest(trainer, 0, 1)
dist.destroy_process_group()
leaked = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("mesh stepped")
"""


def test_mesh_needs_no_host_package():
    """With jax, cv2, msgpack, zstandard and pandas all blocked: a mesh of
    one gloo rank, its memo and frame store, an FSDP trainer's step and a
    snapshot (the multi-rank mesh: ``test_torch_mesh_train.py``)."""
    out = subprocess.run([sys.executable, "-c", _MESH_BLOCKER], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-2:] == ["mesh", "stepped"]


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    for entry in (lambda: resolve_device(None), lambda: resolve_device("cuda"),
                  lambda: routeformer_torch.build_flagship(),
                  lambda: routeformer_torch.build_dinov2(),
                  lambda: routeformer_torch.build_flagship_training(),
                  lambda: routeformer_torch.synthetic_batch(0, 1),
                  lambda: routeformer_torch.load_serving_bundle("missing"),
                  lambda: routeformer_torch.ParallelTrainer({}, None, None),
                  lambda: routeformer_torch.full_comparison.main(
                      {"MODEL_SET": "flagship", "DEBUG": "1"})):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_fails_without_card_or_package(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: chip_smoke.py would run")
    for cwd in (ROOT, tmp_path):
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


# Here a blocked package is absent as it is on the card's machine:
# ``sys.modules[name] = None`` makes an import raise and ``find_spec``
# answer None (``torch.utils.checkpoint`` imports dynamo, which probes
# for optional packages such as pandas with ``find_spec``).
_ZOO_BLOCKER = r"""
import sys
BLOCKED = ("jax", "jaxlib", "flax", "routeformer_tpu", "cv2", "msgpack", "zstandard", "pandas")
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
for name in BLOCKED:
    sys.modules[name] = None
import torch
from routeformer_torch.models.gps_backbone import (Autoformer, FEDformer,
                                                   FEDFormerBackboneConfig, GPSBackboneConfig)
from routeformer_torch.models.video_backbone import (InverseForm, InverseFormBackboneConfig,
                                                     SwinV2Backbone, TimmBackboneConfig)
from routeformer_torch.models.video_backbone import convert
from routeformer_torch.ops.augment import photometric_augment
gps = dict(seq_len=16, label_len=16, pred_len=8, d_model=32, n_heads=4, e_layers=1,
           d_layers=1, d_ff=32, dropout=0.0, factor=2, moving_avg=5, _enc_in=5, _c_out=2)
x = torch.randn(2, 16, 5)
for model in (Autoformer(GPSBackboneConfig(**gps)),
              FEDformer(FEDFormerBackboneConfig(version="Fourier", modes=4, **gps))):
    assert model.train()(x).shape == (2, 8, 2)
frames = torch.rand(2, 32, 32, 3)
assert InverseForm(InverseFormBackboneConfig(train_backbone=True)).train()(frames).shape == (
    2, 8, 8, 240)
swin = SwinV2Backbone(TimmBackboneConfig(model_type="swinv2_tiny_test", compute_dtype="float32",
                                         gelu="tanh", train_backbone=True, remat=True)).train()
swin(frames).sum().backward()
assert photometric_augment(frames.half()).dtype == torch.float16
assert convert.load_torch_state_dict(swin, swin.state_dict())[0] > 0
leaked = sorted(n for n, m in sys.modules.items() if n.split(".")[0] in BLOCKED and m)
assert not leaked, leaked
print("zoo ran")
"""


def test_model_zoo_and_backbone_training_need_no_jax():
    """With jax, flax, routeformer_tpu, cv2, msgpack, zstandard and pandas
    blocked: Autoformer and FEDformer train forwards, a training
    InverseForm, a SwinV2 with ``train_backbone`` and remat through a
    backward, the augment and the checkpoint loaders."""
    out = subprocess.run([sys.executable, "-c", _ZOO_BLOCKER], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-2:] == ["zoo", "ran"]


# Names bound at the top level of a JAX-package module that the port, by
# design, does not carry:
JAX_ONLY = {
    # the JAX, flax, Pallas and optax modules themselves
    "jax", "jnp", "nnx", "optax", "pl", "pltpu",
    # jax.sharding's placement types (the port's mesh takes a DeviceMesh
    # and spec tuples)
    "Mesh", "NamedSharding", "P",
    # typing names
    "Any", "Callable", "Dict", "Iterable", "Iterator", "List", "Literal", "NamedTuple",
    "Optional", "Sequence", "Tuple", "Type", "Union",
    # a checkpoint helper that builds a uint32 JAX array from raw bytes
    "jnp_asarray_u32",
}


def _public_names(module) -> list:
    """A JAX-package module's public top-level names: its ``__all__`` where
    it has one, else every name without a leading underscore that the
    module defines (a function or class whose ``__module__`` is the
    module's), that is an UPPER_CASE constant, or that is bound to a JAX,
    flax, optax or typing object."""
    import inspect
    import types

    if hasattr(module, "__all__"):
        return list(module.__all__)
    out = []
    for name, value in vars(module).items():
        if name.startswith("_"):
            continue
        origin = value.__name__ if isinstance(value, types.ModuleType) else getattr(
            value, "__module__", None)
        foreign = isinstance(origin, str) and origin.split(".")[0] in (
            "jax", "jaxlib", "flax", "optax", "typing")
        defined = ((inspect.isclass(value) or callable(value))
                   and not isinstance(value, types.ModuleType) and origin == module.__name__)
        constant = name.isupper() and not isinstance(value, types.ModuleType)
        if foreign or defined or constant:
            out.append(name)
    return out


def test_every_public_jax_name_has_a_port_counterpart():
    """Every module of ``routeformer_tpu`` that has a counterpart in the
    port (the same path under ``routeformer_torch``) and every public
    top-level name of it resolve in the port, but for ``JAX_ONLY``."""
    import importlib
    import importlib.util
    import pkgutil

    import routeformer_tpu

    names = ["routeformer_tpu"] + [m.name for m in pkgutil.walk_packages(
        routeformer_tpu.__path__, "routeformer_tpu.")]
    missing, modules = [], 0
    for name in names:
        port_name = "routeformer_torch" + name[len("routeformer_tpu"):]
        if importlib.util.find_spec(port_name) is None:
            continue
        modules += 1
        jax_module, port_module = importlib.import_module(name), importlib.import_module(port_name)
        missing += [f"{name}.{n}" for n in _public_names(jax_module)
                    if n not in JAX_ONLY and not hasattr(port_module, n)]
    assert not missing, missing
    assert modules >= 80, modules
    for name in ("ops.heatmap", "visualize", "visualize.gaze", "visualize.plot",
                 "visualize.basemap"):
        assert importlib.util.find_spec(f"routeformer_torch.{name}") is not None, name


_VISUALIZE_BLOCKER = _ZOO_BLOCKER.split("import torch\n")[0].replace(
    '"pandas")', '"pandas", "matplotlib")') + r"""
import numpy as np
import torch
import routeformer_torch.visualize as vis
from routeformer_torch.ops import augment, heatmap
from routeformer_torch.utils.device import init_on_cpu
heat = heatmap.rasterize_gaze_heatmap(np.array([[[3.0, 4.0], [np.nan, 1.0]]]), 8, 12,
                                      device="cpu")
assert heat.shape == (1, 8, 12) and torch.isnan(heat).all()
frame = np.zeros((16, 20, 3), np.uint8)
assert vis.overlay_heatmap_on_frame(frame, [[0.5, 0.5]], sigma=3.0, device="cpu").any()
try:
    vis.plot_gps_data_on_map({"x": np.zeros(2), "y": np.zeros(2)})
    raise AssertionError("plotted without matplotlib")
except ImportError as e:
    assert "matplotlib" in str(e), e
with init_on_cpu():
    assert torch.nn.Linear(2, 2).weight.device.type == "cpu"
assert augment.random_erase(torch.ones(8, 8, 3), torch.Generator().manual_seed(0)).min() == 0
leaked = sorted(n for n, m in sys.modules.items() if n.split(".")[0] in BLOCKED and m)
assert not leaked, leaked
print("visualize ran")
"""


def test_heatmaps_and_visualize_need_no_host_package():
    """With jax, flax, routeformer_tpu, cv2, msgpack, zstandard, pandas and
    matplotlib blocked: a NaN-poisoned heatmap, the gaze overlay, the
    plot's ``ImportError`` naming matplotlib, ``init_on_cpu`` and
    ``random_erase``."""
    out = subprocess.run([sys.executable, "-c", _VISUALIZE_BLOCKER], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-2:] == ["visualize", "ran"]
