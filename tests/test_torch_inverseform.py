"""HRNet-16 and InverseForm against the JAX package on the CPU: the trunk in
eval and train mode (its BatchNorm running statistics after a train-mode
forward), InverseForm's two pool branches (the exact cell mean and the
antialiased resize), the stage-4-only gradient of a training backbone, the
``convert`` loaders on state dicts written from seeds (a torch twin with
the hrnetv2 names, timm ViT and SwinV2 layouts, a Lightning checkpoint
file) with the loaded and total counts equal to JAX's, and a Routeformer
over InverseForm end to end. f32; the tolerances are stated per test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F
from flax import nnx

from routeformer_tpu.models import RouteformerConfig as JaxConfig
from routeformer_tpu.models.gps_backbone import GPSBackboneConfig as JaxGPSConfig
from routeformer_tpu.models.gps_backbone.autoformer import Autoformer as JaxAutoformer
from routeformer_tpu.models.routeformer import Routeformer as JaxRouteformer
from routeformer_tpu.models.video_backbone import SwinV2Backbone as JaxSwin
from routeformer_tpu.models.video_backbone import TimmBackbone as JaxViT
from routeformer_tpu.models.video_backbone import TimmBackboneConfig as JaxTimmConfig
from routeformer_tpu.models.video_backbone import convert as jax_convert
from routeformer_tpu.models.video_backbone.config import (
    InverseFormBackboneConfig as JaxInverseFormConfig,
)
from routeformer_tpu.models.video_backbone.inverseform import InverseForm as JaxInverseForm
from routeformer_torch.convert import flax_to_torch_names, load_flax_params
from routeformer_torch.models import Routeformer, RouteformerConfig
from routeformer_torch.models.gps_backbone import Autoformer, GPSBackboneConfig
from routeformer_torch.models.video_backbone import (
    InverseForm,
    InverseFormBackboneConfig,
    SwinV2Backbone,
    TimmBackbone,
    TimmBackboneConfig,
)
from routeformer_torch.models.video_backbone import convert
from routeformer_torch.models.video_backbone.hrnet import (
    HR16_CHANNELS,
    HR16_MODULES,
    HighResolutionNet16,
)
from test_torch_models import export_params
from test_torch_trainer import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=2e-4, rtol=1e-3)  # a 40-conv trunk in f32, two implementations


# --------------------------------------------------------------------- #
# The torch twin with the hrnetv2 state-dict names (a copy of the JAX
# package's tests/test_hrnet_parity.py twin).
# --------------------------------------------------------------------- #


def conv3x3(c_in, c_out, stride=1):
    return nn.Conv2d(c_in, c_out, 3, stride, 1, bias=False)


class TorchBasic(nn.Module):
    def __init__(self, c_in, c, stride=1, downsample=None):
        super().__init__()
        self.conv1 = conv3x3(c_in, c, stride)
        self.bn1 = nn.BatchNorm2d(c)
        self.conv2 = conv3x3(c, c)
        self.bn2 = nn.BatchNorm2d(c)
        self.downsample = downsample

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + r)


class TorchBottleneck(nn.Module):
    def __init__(self, c_in, c, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, c, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(c)
        self.conv2 = conv3x3(c, c)
        self.bn2 = nn.BatchNorm2d(c)
        self.conv3 = nn.Conv2d(c, 4 * c, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(4 * c)
        self.downsample = downsample

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + r)


class TorchHRModule(nn.Module):
    def __init__(self, channels):
        super().__init__()
        n = len(channels)
        self.branches = nn.ModuleList(
            [nn.Sequential(TorchBasic(c, c), TorchBasic(c, c)) for c in channels])
        fuse_layers = []
        for i in range(n):
            row = []
            for j in range(n):
                if j > i:
                    row.append(nn.Sequential(nn.Conv2d(channels[j], channels[i], 1, bias=False),
                                             nn.BatchNorm2d(channels[i])))
                elif j == i:
                    row.append(None)
                else:
                    chain = []
                    for k in range(i - j):
                        last = k == i - j - 1
                        out_c = channels[i] if last else channels[j]
                        mods = [conv3x3(channels[j], out_c, 2), nn.BatchNorm2d(out_c)]
                        if not last:
                            mods.append(nn.ReLU())
                        chain.append(nn.Sequential(*mods))
                    row.append(nn.Sequential(*chain))
            fuse_layers.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse_layers)

    def forward(self, xs):
        xs = [b(x) for b, x in zip(self.branches, xs)]
        out = []
        for i in range(len(xs)):
            y = xs[i]
            for j in range(len(xs)):
                if i == j:
                    continue
                z = self.fuse_layers[i][j](xs[j])
                if j > i:
                    z = F.interpolate(z, size=y.shape[-2:], mode="bilinear", align_corners=False)
                y = y + z
            out.append(F.relu(y))
        return out


def make_transition(pre, cur):
    mods = []
    for i in range(len(cur)):
        if i < len(pre):
            if cur[i] != pre[i]:
                mods.append(nn.Sequential(conv3x3(pre[i], cur[i]), nn.BatchNorm2d(cur[i]),
                                          nn.ReLU()))
            else:
                mods.append(None)
        else:
            chain = []
            for j in range(i + 1 - len(pre)):
                out_c = cur[i] if j == i - len(pre) else pre[-1]
                chain.append(nn.Sequential(conv3x3(pre[-1], out_c, 2), nn.BatchNorm2d(out_c),
                                           nn.ReLU()))
            mods.append(nn.Sequential(*chain))
    return nn.ModuleList(mods)


class TorchHRNet16(nn.Module):
    def __init__(self):
        super().__init__()
        ch = HR16_CHANNELS
        self.conv1 = conv3x3(3, 64, 2)
        self.bn1 = nn.BatchNorm2d(64)
        self.conv2 = conv3x3(64, 64, 2)
        self.bn2 = nn.BatchNorm2d(64)
        down = nn.Sequential(nn.Conv2d(64, 256, 1, bias=False), nn.BatchNorm2d(256))
        self.layer1 = nn.Sequential(TorchBottleneck(64, 64, down), TorchBottleneck(256, 64))
        self.transition1 = make_transition((256,), ch[:2])
        self.stage2 = nn.Sequential(*[TorchHRModule(ch[:2]) for _ in range(HR16_MODULES[0])])
        self.transition2 = make_transition(ch[:2], ch[:3])
        self.stage3 = nn.Sequential(*[TorchHRModule(ch[:3]) for _ in range(HR16_MODULES[1])])
        self.transition3 = make_transition(ch[:3], ch)
        self.stage4 = nn.Sequential(*[TorchHRModule(ch) for _ in range(HR16_MODULES[2])])

    @staticmethod
    def _apply_transition(transition, xs):
        return [xs[i] if mod is None else mod(xs[i] if i < len(xs) else xs[-1])
                for i, mod in enumerate(transition)]

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = self.layer1(x)
        xs = self._apply_transition(self.transition1, [x])
        for m in self.stage2:
            xs = m(xs)
        xs = self._apply_transition(self.transition2, xs)
        for m in self.stage3:
            xs = m(xs)
        xs = self._apply_transition(self.transition3, xs)
        for m in self.stage4:
            xs = m(xs)
        size = xs[0].shape[-2:]
        ups = [xs[0]] + [F.interpolate(f, size=size, mode="bilinear", align_corners=False)
                         for f in xs[1:]]
        return torch.cat(ups, 1)


def seeded_twin():
    torch.manual_seed(0)
    twin = TorchHRNet16().eval()
    with torch.no_grad():
        for m in twin.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.2)
                m.running_var.uniform_(0.5, 2.0)
                m.weight.normal_(1.0, 0.1)
                m.bias.normal_(0, 0.1)
    return twin


def _frames(seed, n=4, h=32, w=48):
    """Frames at the Routeformer test's stream shape, (4, 32, 48): the JAX
    trunk's eager ops compile once per shape."""
    return np.random.RandomState(seed).rand(n, h, w, 3).astype(np.float32)


def routeformer_kwargs():
    gps = dict(seq_len=8, label_len=8, pred_len=6, d_model=32, n_heads=4, e_layers=2,
               d_layers=1, d_ff=64, factor=2, moving_avg=5, dropout=0.0, activation="relu",
               embed="timeF", freq="m")
    top = dict(with_video=True, with_gaze=True, dense_prediction=True,
               image_embedding_size=16, encoder_hidden_size=16, encoder_heads=4,
               encoder_layers=2, encoder_d_ff=32, cross_modal_decoder_heads=4,
               cross_modal_decoder_layers=2, feature_dropout=0.0, view_dropout=0.0,
               gaze_dropout=0.0, output_fps=5, video_fps=1, gaze_fps=1)
    return gps, top


@pytest.fixture(scope="module")
def jax_routeformer():
    """One JAX Routeformer over InverseForm and Autoformer for the whole
    file (building a JAX HRNet-16 takes ~20 s here): its
    ``video_backbone`` is the JAX InverseForm, whose ``backbone`` the
    trunk. Each test loads the weights it compares into it."""
    gps, top = routeformer_kwargs()
    return JaxRouteformer(
        JaxConfig(gps_backbone_config=JaxGPSConfig(**gps),
                  video_backbone_config=JaxInverseFormConfig(cache_enabled=False), **top),
        gps_backbone=JaxAutoformer, video_backbone=JaxInverseForm, rngs=nnx.Rngs(0, dropout=1))


# --------------------------------------------------------------------- #


def test_hrnet_loader_matches_the_twin_and_jax(jax_routeformer):
    """``load_hrnet_torch`` of the twin's ``state_dict``: every entry
    loaded, the same counts as JAX's loader, the output the twin's."""
    twin = seeded_twin()
    sd = twin.state_dict()
    port = HighResolutionNet16().eval()
    jax_model = jax_routeformer.video_backbone.backbone
    jax_model.eval()
    counts = convert.load_hrnet_torch(port, sd)
    assert counts == jax_convert.load_hrnet_torch(jax_model, sd)
    assert counts[0] == counts[1]
    x = _frames(0)
    with torch.no_grad():
        want = twin(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (4, 8, 12, 240)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, np.asarray(jax_model(jnp.asarray(x))), **TOL)


def test_fuzzy_state_dict_loader_counts_match_jax(jax_routeformer):
    """``load_torch_state_dict`` (fuzzy) with prefixed keys, a missing
    entry and a foreign one: the same (loaded, total) as JAX's."""
    sd = {convert._translate_hrnet_key(k): v for k, v in seeded_twin().state_dict().items()
          if "num_batches_tracked" not in k}
    sd = {f"net.{k}": v for k, v in sd.items() if k != "conv1.weight"}
    sd["head.classifier.weight"] = torch.zeros(3, 3)
    port, jax_model = HighResolutionNet16(), jax_routeformer.video_backbone.backbone
    counts = convert.load_torch_state_dict(port, sd)
    assert counts == jax_convert.load_torch_state_dict(jax_model, sd)
    assert counts[0] == counts[1] - 1


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_hrnet_matches_jax(rng, jax_routeformer, train):
    """Carried by ``load_flax_params``; in train mode the batch statistics
    normalise and the running ones move (momentum 0.9, the biased
    variance), as flax's (there at atol/rtol 1e-3: two frames' statistics
    amplify f32 differences)."""
    jax_model = jax_routeformer.video_backbone.backbone
    port = HighResolutionNet16()
    load_flax_params(port, export_params(jax_model, rng))
    jax_model.train() if train else jax_model.eval()
    port.train(train)
    x = _frames(1)
    want = np.asarray(jax_model(jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **(dict(atol=1e-3, rtol=1e-3) if train else TOL))
    stats = flax_to_torch_names({".".join(map(str, p)): np.asarray(v[...]) for p, v in
                                 nnx.to_flat_state(nnx.state(jax_model, nnx.BatchStat))})
    state = port.state_dict()
    assert len(stats) == 2 * sum(1 for k in state if k.endswith("running_mean"))
    for name, value in stats.items():
        np.testing.assert_allclose(state[name].numpy(), value, atol=1e-4, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("hw", [(32, 64), (32, 48)], ids=["divisible", "resized"])
def test_inverseform_pool_branches_match_jax(rng, jax_routeformer, hw):
    """(32, 64) frames give an 8x16 map, pooled as 1x2 cell means; (32,
    48) an 8x12 map, resized to 8x8 with the antialiased bilinear kernel.
    uint8 frames, fed raw."""
    jax_model = jax_routeformer.video_backbone
    port = InverseForm(InverseFormBackboneConfig())
    load_flax_params(port, export_params(jax_model, rng))
    jax_model.eval()
    port.eval()
    x = np.random.RandomState(2).randint(0, 256, (4, *hw, 3)).astype(np.uint8)
    want = np.asarray(jax_model(jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (4, 8, 8, 240)
    np.testing.assert_allclose(got, want, **TOL)


def test_training_inverseform_trains_stage4_only(rng, jax_routeformer):
    """``train_backbone``: the gradient reaches stage 4's parameters only
    (the branches are detached before it), and equals JAX's there."""
    jax_model = jax_routeformer.video_backbone
    port = InverseForm(InverseFormBackboneConfig(train_backbone=True))
    load_flax_params(port, export_params(jax_model, rng))
    jax_model.eval()
    port.eval()
    x = _frames(3)
    jax_model.train_backbone = True
    try:
        graphdef, params, rest = nnx.split(jax_model, nnx.Param, ...)

        def loss(p):
            return (nnx.merge(graphdef, p, rest)(jnp.asarray(x)) ** 2).sum()

        want = flax_to_torch_names({".".join(map(str, k)): np.asarray(v[...]) for k, v in
                                    nnx.to_flat_state(jax.grad(loss)(params))})
    finally:
        jax_model.train_backbone = False
    (port(torch.from_numpy(x)) ** 2).sum().backward()
    scale = max(np.abs(g).max() for g in want.values())
    for name, p in port.named_parameters():
        if name.startswith("backbone.stage4."):
            assert p.grad is not None and p.grad.abs().max() > 0, name
            np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=0,
                                       atol=1e-4 * scale, err_msg=name)
        else:
            assert p.grad is None, name
            assert not np.any(want[name]), name


def _timm_vit_state(backbone, seed):
    gen = torch.Generator().manual_seed(seed)
    p = backbone.preset
    sd = {"patch_embed.proj.weight": torch.randn(p.width, 3, p.patch_size, p.patch_size,
                                                 generator=gen) * 0.05,
          "patch_embed.proj.bias": torch.randn(p.width, generator=gen) * 0.05,
          "pos_embed": torch.randn(1, (p.img_size // p.patch_size) ** 2 + 1, p.width,
                                   generator=gen) * 0.02,
          "norm.weight": 1 + 0.1 * torch.randn(p.width, generator=gen),
          "norm.bias": 0.1 * torch.randn(p.width, generator=gen)}
    for i, block in enumerate(backbone.blocks):
        for ours, theirs in (("norm1", "norm1"), ("norm2", "norm2"), ("qkv", "attn.qkv"),
                             ("proj", "attn.proj"), ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            for leaf in ("weight", "bias"):
                t = getattr(getattr(block, ours), leaf)
                sd[f"blocks.{i}.{theirs}.{leaf}"] = (
                    1 + 0.1 * torch.randn(t.shape, generator=gen) if "norm" in ours
                    and leaf == "weight" else torch.randn(t.shape, generator=gen) * 0.1)
    return sd


def _timm_swin_state(backbone, seed):
    gen = torch.Generator().manual_seed(seed)
    sd = {}

    def put(name, shape, center=0.0, scale=0.1):
        sd[name] = center + scale * torch.randn(shape, generator=gen)

    put("patch_embed.proj.weight", backbone.patch_embed.weight.shape)
    put("patch_embed.proj.bias", backbone.patch_embed.bias.shape)
    for name, norm in (("patch_embed.norm", backbone.patch_norm), ("norm", backbone.final_norm)):
        put(f"{name}.weight", norm.weight.shape, 1.0)
        put(f"{name}.bias", norm.bias.shape)
    for si, stage in enumerate(backbone.stages):
        for p, pair in enumerate(stage.pairs):
            for offset, block in ((0, pair.block_a), (1, pair.block_b)):
                for ours, theirs in convert._SWIN_BLOCK:
                    shape = block.get_parameter(ours).shape
                    put(f"layers.{si}.blocks.{2 * p + offset}.{theirs}", shape,
                        1.0 if ours.startswith("norm") and ours.endswith("weight") else 0.0)
        if str(si) in backbone.merges:
            merge = backbone.merges[str(si)]
            put(f"layers.{si}.downsample.reduction.weight", merge.reduction.weight.shape)
            put(f"layers.{si}.downsample.norm.weight", merge.norm.weight.shape, 1.0)
            put(f"layers.{si}.downsample.norm.bias", merge.norm.bias.shape)
    return sd


@pytest.mark.parametrize("kind", ["vit", "swin"])
def test_timm_loaders_match_jax(kind):
    """A timm state dict written from a seed into both packages: the same
    count, and the same features (f32, 1e-4)."""
    if kind == "vit":
        cfg = dict(model_type="vit_tiny_test", compute_dtype="float32")
        jax_model = JaxViT(JaxTimmConfig(cache_enabled=False, **cfg), rngs=nnx.Rngs(0))
        port = TimmBackbone(TimmBackboneConfig(**cfg))
        sd = _timm_vit_state(port, 5)
        counts = convert.load_timm_vit(port, sd), jax_convert.load_timm_vit(jax_model, sd)
    else:
        cfg = dict(model_type="swinv2_parity_test", compute_dtype="float32")
        jax_model = JaxSwin(JaxTimmConfig(cache_enabled=False, **cfg), rngs=nnx.Rngs(0))
        port = SwinV2Backbone(TimmBackboneConfig(**cfg))
        sd = _timm_swin_state(port, 6)
        counts = convert.load_timm_swin(port, sd), jax_convert.load_timm_swin(jax_model, sd)
    assert counts[0] == counts[1] > 0
    jax_model.eval()
    port.eval()
    x = _frames(4, h=32, w=32)
    want = np.asarray(jax_model(jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_checkpoint_file_loads_as_jax(tmp_path, jax_routeformer):
    """``load_torch_checkpoint`` of a Lightning-style file (the state dict
    under ``state_dict``, ``model.`` prefixes): JAX's counts, the twin's
    output. Read with ``weights_only=True``."""
    twin = seeded_twin()
    path = tmp_path / "trunk.ckpt"
    sd = {f"model.{convert._translate_hrnet_key(k)}": v for k, v in twin.state_dict().items()
          if "num_batches_tracked" not in k}
    torch.save({"state_dict": sd, "epoch": 3}, path)
    port, jax_model = HighResolutionNet16().eval(), jax_routeformer.video_backbone.backbone
    counts = convert.load_torch_checkpoint(port, path)
    assert counts == jax_convert.load_torch_checkpoint(jax_model, path)
    assert counts[0] == counts[1]
    x = _frames(6)
    with torch.no_grad():
        want = twin(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(), want, **TOL)


def test_routeformer_over_inverseform_matches_jax(rng, jax_routeformer):
    """A Routeformer with InverseForm as its video backbone (run once per
    pixel stream, uint8) and Autoformer as its
    GPS backbone, eval forward, against JAX (5e-4 of the max)."""
    gps, top = routeformer_kwargs()
    jax_model = jax_routeformer
    port = Routeformer(RouteformerConfig(gps_backbone_config=GPSBackboneConfig(**gps),
                                         video_backbone_config=InverseFormBackboneConfig(),
                                         **top),
                       gps_backbone=Autoformer, video_backbone=InverseForm)
    load_flax_params(port, export_params(jax_model, rng))
    jax_model.eval()
    port.eval()
    r = np.random.RandomState(8)
    batch = {"gps": np.cumsum(r.randn(2, 8, 2) * 0.5, axis=1).astype(np.float32),
             "left_video": r.randint(0, 256, (2, 8, 32, 48, 3)).astype(np.uint8),
             "right_video": r.randint(0, 256, (2, 8, 32, 48, 3)).astype(np.uint8),
             "front_video": r.randint(0, 256, (2, 8, 32, 48, 3)).astype(np.uint8),
             "gaze": r.uniform(size=(2, 40, 2)).astype(np.float32)}
    # one compiled program: quicker here than eager dispatch, which compiles
    # each op of the model on its own
    want = nnx.jit(lambda m, b: m(b))(jax_model, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = port({k: torch.from_numpy(v) for k, v in batch.items()})
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=5e-4 * np.abs(w).max(), rtol=0)


def test_export_takes_inverseform_and_autoformer_and_refuses_fedformer():
    """``export_model`` of a Routeformer over InverseForm (the front view
    only: tracing a trunk call costs ~15 s here) and Autoformer (CPU, the
    plain versions) serves the live forward's bits; a FEDformer model is no
    longer refused: it exports and serves its live forward's prediction
    within 1e-5 of the max (``test_torch_fedformer.py`` holds both
    versions)."""
    from routeformer_torch.flagship import init_weights
    from routeformer_torch.models.gps_backbone import FEDformer, FEDFormerBackboneConfig
    from routeformer_torch.serve import ExportedModel, _eval_forward, export_model

    gps, top = routeformer_kwargs()
    model = Routeformer(RouteformerConfig(gps_backbone_config=GPSBackboneConfig(**gps),
                                          video_backbone_config=InverseFormBackboneConfig(),
                                          **dict(top, with_scene=False)),
                        gps_backbone=Autoformer, video_backbone=InverseForm)
    init_weights(model, 4)
    model.eval()
    r = np.random.RandomState(9)
    batch = {"gps": np.cumsum(r.randn(1, 8, 2), axis=1).astype(np.float32),
             "front_video": r.randint(0, 256, (1, 8, 32, 48, 3)).astype(np.uint8),
             "gaze": r.uniform(size=(1, 40, 2)).astype(np.float32)}
    with torch.no_grad():
        want = model({k: torch.from_numpy(v) for k, v in batch.items()})[0]
    got = ExportedModel(export_model(model, batch), _eval_forward(model)[1])(batch)
    assert torch.equal(got, want)

    fed = Routeformer(RouteformerConfig(
        gps_backbone_config=FEDFormerBackboneConfig(**dict(gps, version="Fourier", modes=2)),
        discount_factor={0: 0.97}, epsilon=1.0), gps_backbone=FEDformer)
    fed.eval()
    with torch.no_grad():
        want = fed({"gps": torch.from_numpy(batch["gps"])})[0]
    got = ExportedModel(export_model(fed, {"gps": batch["gps"]}), _eval_forward(fed)[1])(
        {"gps": batch["gps"]})
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
