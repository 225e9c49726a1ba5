"""FEDformer against the JAX package on the CPU: the Legendre and
Chebyshev filter banks bit for bit; the Fourier version, its mode indices
asserted equal to the JAX module's lists before any output is compared;
the multiwavelet version; train and eval mode; the tied encoder block,
one module object whose parameters ``load_flax_params`` carries once as
flax lists it. f32 at atol/rtol 1e-4 (the wavelet version's outputs at
1e-4 of their max: its spectral weights make values of ~1e2)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from routeformer_tpu.models.gps_backbone.config import FEDFormerBackboneConfig as JaxFEDConfig
from routeformer_tpu.models.gps_backbone.fedformer import FEDformer as JaxFEDformer
from routeformer_tpu.models.layers import multiwavelet as jax_mw
from routeformer_torch.convert import flax_state, load_flax_params
from routeformer_torch.models.gps_backbone import FEDformer, FEDFormerBackboneConfig
from routeformer_torch.models.layers import multiwavelet as port_mw
from test_torch_autoformer import B, ENC_IN, PRED_LEN, SEQ_LEN, TOL, gps_kwargs
from test_torch_models import export_params
from test_torch_trainer import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("base", ["legendre", "chebyshev"])
@pytest.mark.parametrize("k", [3, 8])
def test_filter_banks_are_the_same_bits(base, k):
    for got, want in zip(port_mw.get_filter(base, k), jax_mw.get_filter(base, k)):
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    for got, want in zip(port_mw._reconstruction_filters(base, k),
                         jax_mw._reconstruction_filters(base, k)):
        np.testing.assert_array_equal(got, want)


def fed_pair(rng, version, seed=7, **kw):
    """The JAX model built with numpy's global generator seeded at
    ``seed``, the port's with a RandomState of that seed."""
    cfg = gps_kwargs(version=version, modes=4, **kw)
    np.random.seed(seed)
    jax_model = JaxFEDformer(JaxFEDConfig(**cfg), rngs=nnx.Rngs(0, dropout=1))
    port = FEDformer(FEDFormerBackboneConfig(**cfg), mode_rng=np.random.RandomState(seed))
    flat = export_params(jax_model, rng)
    assert load_flax_params(port, flat) == len(flat) == len(flax_state(port))
    return jax_model, port


@pytest.fixture(scope="module")
def pairs():
    """One JAX/port pair per version, built once: the multiwavelet blocks
    hold ~200M spectral weights whatever d_model is (c 128, k 8)."""
    built = {}

    def get(version):
        if version not in built:
            built[version] = fed_pair(np.random.default_rng(0), version)
        return built[version]

    return get


def _modes(model):
    """(encoder block, decoder block, cross q, cross kv) mode lists."""
    enc = model.encoder.attn_layers[0].attention.inner
    dec = model.decoder.layers[0]
    cross = dec.cross_attention.inner
    return [list(map(int, enc.index)), list(map(int, dec.self_attention.inner.index)),
            list(map(int, cross.index_q)), list(map(int, cross.index_kv))]


def test_fourier_modes_are_jax_lists(pairs):
    jax_model, port = pairs("Fourier")
    want = _modes(jax_model)
    assert _modes(port) == want
    assert want[0] != list(range(4))  # a random choice, not the lowest modes
    assert "encoder.attn_layers.0.attention.inner.index" in port.state_dict()


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("version", ["Fourier", "Wavelets"])
def test_fedformer_matches_jax(pairs, version, train):
    jax_model, port = pairs(version)
    if version == "Fourier":
        assert _modes(port) == _modes(jax_model)
    jax_model.train() if train else jax_model.eval()
    port.train(train)
    x = np.random.RandomState(3).randn(B, SEQ_LEN, ENC_IN).astype(np.float32)
    want = np.asarray(jax_model(jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (B, PRED_LEN, 3)
    np.testing.assert_allclose(got, want, atol=1e-4 * max(1.0, np.abs(want).max()), rtol=1e-4)


@pytest.mark.parametrize("version", ["Fourier", "Wavelets"])
def test_encoder_block_is_tied(pairs, version):
    """One frequency block serves both encoder layers: the same module,
    its parameters listed once (under layer 0, as flax lists it), and (the
    Fourier version, whose backward is cheap here) a gradient reaching it."""
    jax_model, port = pairs(version)
    layers = port.encoder.attn_layers
    assert layers[0].attention.inner is layers[1].attention.inner
    assert layers[0].attention.query_projection is not layers[1].attention.query_projection
    flax_names = {".".join(map(str, p)) for p, _ in
                  nnx.to_flat_state(nnx.state(jax_model, nnx.Param))}
    inner = {n for n in flax_names if ".attention.inner." in n and n.startswith("encoder.")}
    assert inner and all(n.startswith("encoder.attn_layers.0.") for n in inner)
    names = dict(port.named_parameters())
    assert not any(n.startswith("encoder.attn_layers.1.attention.inner.") for n in names)
    if version == "Wavelets":
        return
    w = next(p for n, p in names.items() if n.startswith("encoder.attn_layers.0.attention.inner"))
    port.train()
    x = torch.from_numpy(np.random.RandomState(4).randn(B, SEQ_LEN, ENC_IN).astype(np.float32))
    port.zero_grad()
    port(x).sum().backward()
    assert w.grad is not None and torch.isfinite(w.grad).all() and w.grad.abs().max() > 0


def test_routeformer_over_fedformer_matches_jax_and_its_bundle_keeps_the_modes(rng, tmp_path):
    """A (GPS-only) Routeformer over the Fourier FEDformer against JAX's,
    eval (1e-4); its serving bundle rebuilds the FEDformer with the mode
    buffers it holds (here changed from what its build draws), the same
    bits."""
    from routeformer_tpu.models import RouteformerConfig as JaxConfig
    from routeformer_tpu.models.routeformer import Routeformer as JaxRouteformer
    from routeformer_torch import load_serving_bundle, save_serving_bundle
    from routeformer_torch.models import Routeformer, RouteformerConfig

    gps = gps_kwargs(version="Fourier", modes=4, _enc_in=None, _c_out=None)
    top = dict(discount_factor={0: 0.97}, epsilon=1.0)
    np.random.seed(3)
    jax_model = JaxRouteformer(JaxConfig(gps_backbone_config=JaxFEDConfig(**gps), **top),
                               gps_backbone=JaxFEDformer, rngs=nnx.Rngs(0, dropout=1))
    port = Routeformer(RouteformerConfig(gps_backbone_config=FEDFormerBackboneConfig(**gps),
                                         **top), gps_backbone=FEDformer)
    port.gps_backbone = FEDformer(port.configs.gps_backbone_config,
                                  mode_rng=np.random.RandomState(3))
    assert _modes(port.gps_backbone) == _modes(jax_model.gps_backbone)
    load_flax_params(port, export_params(jax_model, rng))
    jax_model.eval()
    port.eval()
    batch = {"gps": np.cumsum(np.random.RandomState(4).randn(B, SEQ_LEN, 2), axis=1)
             .astype(np.float32)}
    want = np.asarray(jax_model({"gps": jnp.asarray(batch["gps"])}))
    with torch.no_grad():
        got = port({"gps": torch.from_numpy(batch["gps"])})
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    modes = _modes(port.gps_backbone)
    assert _modes(FEDformer(port.configs.gps_backbone_config)) != modes  # a fresh build's
    save_serving_bundle(tmp_path / "bundle", port)
    served = load_serving_bundle(tmp_path / "bundle", device="cpu")
    assert type(served.model.gps_backbone) is FEDformer
    assert _modes(served.model.gps_backbone) == modes
    assert torch.equal(served(batch), got)


def _first_difference(model, exported, batch) -> str:
    """The first module of the live model whose output no value of the
    exported graph reproduces bit for bit, with the closest graph node."""
    from torch.fx import Interpreter

    outs, nodes = [], []

    def hook(name):
        def record(_module, _inp, out):
            out = out[0] if isinstance(out, tuple) else out
            if isinstance(out, torch.Tensor) and out.is_floating_point():
                outs.append((name, out.detach().clone()))
        return record

    class Record(Interpreter):
        def run_node(self, n):
            out = super().run_node(n)
            if isinstance(out, torch.Tensor) and out.is_floating_point():
                nodes.append((n.name, str(n.target), out.clone()))
            return out

    hooks = [m.register_forward_hook(hook(n)) for n, m in model.named_modules() if n]
    tensors = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.inference_mode():
        model(tensors)
        Record(exported._program).run(exported._leaves, tensors)
    for h in hooks:
        h.remove()
    for name, out in outs:
        shaped = [(n, t, v) for n, t, v in nodes if v.shape == out.shape]
        if shaped and not any(torch.equal(v, out) for _, _, v in shaped):
            n, t, v = min(shaped, key=lambda x: float((x[2] - out).abs().max()))
            return f"module {name}: closest graph node {n} = {t}, max|diff| " \
                   f"{float((v - out).abs().max()):.3e}"
    return "no module output differs"


@pytest.mark.parametrize("version", ["Fourier", "Wavelets"])
def test_fedformer_exports(version):
    """``export_model`` of a GPS-only Routeformer over FEDformer at small
    widths (the wavelet blocks at their fixed c 128, k 8), reloaded from its
    bytes (``ExportedModel``), serves the live ``ServingModel``'s batch-1
    prediction: the same bits, else within 1e-5 of its max, the first
    differing op named."""
    from routeformer_torch.models import Routeformer, RouteformerConfig
    from routeformer_torch.serve import ExportedModel, ServingModel, _eval_forward, export_model

    gps = gps_kwargs(version=version, modes=4, d_model=16, d_ff=32, _enc_in=None, _c_out=None)
    torch.manual_seed(5)
    model = Routeformer(RouteformerConfig(gps_backbone_config=FEDFormerBackboneConfig(**gps),
                                          discount_factor={0: 0.97}, epsilon=1.0),
                        gps_backbone=FEDformer)
    batch = {"gps": np.cumsum(np.random.RandomState(6).randn(1, SEQ_LEN, 2), axis=1)
             .astype(np.float32)}
    want = ServingModel(model, torch.device("cpu"))(batch)  # GPS-only: the prediction
    exported = ExportedModel(export_model(model, batch), _eval_forward(model)[1])
    got = exported(batch)
    assert got.shape == want.shape == (1, PRED_LEN, 2) and torch.isfinite(got).all()
    if not torch.equal(got, want):
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= 1e-5, (err, _first_difference(model, exported, batch))
