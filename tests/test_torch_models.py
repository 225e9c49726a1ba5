"""The port's Informer and SwinV2 backbone against the JAX package on the
CPU, with the JAX modules' parameters carried over by
``routeformer_torch.convert.load_flax_params`` (every parameter matched).
Biases and BatchNorm statistics are perturbed first so that none is a
trivial zero or one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from routeformer_tpu.models.gps_backbone import GPSBackboneConfig as JaxGPSConfig
from routeformer_tpu.models.gps_backbone import Informer as JaxInformer
from routeformer_tpu.models.video_backbone import SwinV2Backbone as JaxSwin
from routeformer_tpu.models.video_backbone import TimmBackboneConfig as JaxTimmConfig
from routeformer_tpu.models.layers import embed as jax_embed
from routeformer_torch.convert import load_flax_params
from routeformer_torch.models.gps_backbone import GPSBackboneConfig, Informer
from routeformer_torch.models.layers import embed
from routeformer_torch.models.video_backbone import SwinV2Backbone, TimmBackboneConfig


def export_params(model, rng, noise=0.05) -> dict:
    """Perturb a JAX module's 1-D parameters and batch statistics in place
    and return all its parameters as numpy, keyed by flat-state path."""
    state = nnx.state(model, (nnx.Param, nnx.BatchStat))
    out = {}
    for path, var in nnx.to_flat_state(state):
        name = ".".join(str(p) for p in path)
        arr = np.asarray(var[...], dtype=np.float32)
        if name.endswith(".var"):
            arr = 1.0 + rng.uniform(0.0, 0.5, arr.shape)
        elif arr.ndim == 1 or name.endswith(("q_bias", "v_bias")):
            arr = arr + noise * rng.normal(size=arr.shape)
        arr = arr.astype(np.float32)
        var[...] = jnp.asarray(arr)
        out[name] = arr
    nnx.update(model, state)
    return out


def import_params(model, flat: dict) -> None:
    """Set a JAX module's parameters from an ``export_params`` dict."""
    state = nnx.state(model, (nnx.Param, nnx.BatchStat))
    for path, var in nnx.to_flat_state(state):
        var[...] = jnp.asarray(flat[".".join(str(p) for p in path)])
    nnx.update(model, state)


def _informer_pair(rng, **kw):
    jcfg = JaxGPSConfig(**kw)
    jcfg.smart_decoder = True
    jax_model = JaxInformer(jcfg, rngs=nnx.Rngs(0))
    jax_model.eval()
    flat = export_params(jax_model, rng)
    cfg = GPSBackboneConfig(**kw)
    cfg.smart_decoder = True
    port = Informer(cfg).eval()
    assert load_flax_params(port, flat) == len(
        [k for k in port.state_dict() if not k.endswith("num_batches_tracked")])
    return jax_model, port


@pytest.mark.parametrize("width", ["tiny", "flagship"])
def test_informer_matches_jax(rng, width):
    """Real (non-exhaustive) ProbSparse factors: tiny d32 at factor 1 and
    the flagship width d832/d_ff 3328/8 heads at factor 4 with two
    distilling convs (encoder L = 40, 21, 12). f32 at 2e-4."""
    if width == "tiny":
        kw = dict(seq_len=20, label_len=20, pred_len=10, d_model=32, n_heads=4,
                  e_layers=2, d_layers=1, d_ff=64, factor=1)
    else:
        kw = dict(seq_len=40, label_len=40, pred_len=30, d_model=832, n_heads=8,
                  e_layers=3, d_layers=1, d_ff=3328, factor=4)
    kw.update(dropout=0.0, activation="relu", distil=True, _enc_in=69, _c_out=66)
    jax_model, port = _informer_pair(rng, **kw)
    x = rng.normal(size=(2, kw["seq_len"], 69)).astype(np.float32)
    want = np.asarray(jax_model(jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (2, kw["pred_len"], 66)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("gelu,dtype,hw", [
    ("exact", "float32", (64, 64)),   # K2 path, no resize
    ("exact", "float32", (96, 96)),   # antialiased downsampling to 64
    ("tanh", "float32", (40, 64)),    # K1 path, pad to square
    ("tanh", "bfloat16", (64, 64)),   # K1 path, bf16 rounding points
])
def test_swin_backbone_matches_jax(rng, monkeypatch, gelu, dtype, hw):
    """SwinV2 on ``swinv2_parity_test`` (two stages, shifted windows, one
    merge). tanh blocks run the JAX fused-block kernel in interpret mode
    against the port's K1 plain version; exact blocks run the JAX einsum
    window path against K2's plain version. f32 at 2e-4.

    In bf16 the block itself matches the Pallas kernel to a bf16
    rounding (``test_torch_kernels``), but LayerNorm statistics summed in another
    order flip single bf16 roundings, which the random-weight stages
    amplify. So bf16 is held to the noise floor of bf16 itself: the port's
    mean error against JAX bf16 is at most twice JAX bf16's mean error
    against JAX f32 on the same weights."""
    if gelu == "tanh":
        monkeypatch.setenv("ROUTEFORMER_SWIN_BLOCK_FUSION", "interpret")
    kw = dict(model_type="swinv2_parity_test", compute_dtype=dtype, gelu=gelu,
              pad_to_square=True)
    jax_model = JaxSwin(JaxTimmConfig(cache_enabled=False, **kw), rngs=nnx.Rngs(0))
    jax_model.eval()
    flat = export_params(jax_model, rng)
    port = SwinV2Backbone(TimmBackboneConfig(**kw)).eval()
    load_flax_params(port, flat)
    x = rng.uniform(size=(3, *hw, 3)).astype(np.float32)
    want = np.asarray(jax_model(jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 8, 8, 32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
        return
    jax_f32 = JaxSwin(JaxTimmConfig(cache_enabled=False,
                                    **dict(kw, compute_dtype="float32")),
                      rngs=nnx.Rngs(0))
    jax_f32.eval()
    import_params(jax_f32, flat)
    floor = np.abs(want - np.asarray(jax_f32(jnp.asarray(x)))).mean()
    assert 0 < np.abs(got - want).mean() <= 2 * floor


def test_load_flax_params_rejects_unmatched(rng):
    kw = dict(seq_len=8, label_len=8, pred_len=4, d_model=16, n_heads=2,
              e_layers=2, d_layers=1, d_ff=32, factor=1, dropout=0.0,
              _enc_in=5, _c_out=2)
    jcfg = JaxGPSConfig(**kw)
    flat = export_params(JaxInformer(jcfg, rngs=nnx.Rngs(0)), rng)
    port = Informer(GPSBackboneConfig(**kw))
    extra = dict(flat, **{"encoder.extra.kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="flax-only"):
        load_flax_params(port, extra)
    missing = {k: v for k, v in flat.items() if "norm" not in k}
    with pytest.raises(KeyError, match="port-only"):
        load_flax_params(port, missing)


def test_informer_output_attention_matches_jax(rng):
    """``output_attention``: the prediction and, as in JAX, one attention
    entry per encoder layer, None where the layer is ProbSparse (every
    Informer encoder layer). f32 at 2e-4."""
    kw = dict(seq_len=20, label_len=20, pred_len=10, d_model=32, n_heads=4, e_layers=2,
              d_layers=1, d_ff=64, factor=1, dropout=0.0, activation="relu", distil=True,
              _enc_in=69, _c_out=66)
    jcfg, cfg = JaxGPSConfig(**kw), GPSBackboneConfig(**kw)
    jcfg.output_attention = cfg.output_attention = True
    jax_model = JaxInformer(jcfg, rngs=nnx.Rngs(0))
    jax_model.eval()
    port = Informer(cfg).eval()
    load_flax_params(port, export_params(jax_model, rng))
    x = rng.normal(size=(2, 20, 69)).astype(np.float32)
    want, want_attn = jax_model(jnp.asarray(x))
    with torch.no_grad():
        got, attn = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-3)
    assert attn == list(want_attn) == [None, None]


def _marks(rng, b, l, freq):
    """Integer calendar marks (month, day, weekday, hour[, minute]) as
    floats, as the reference's data loaders give them."""
    sizes = [13, 32, 7, 24] + ([4] if freq == "t" else [])
    return np.stack([rng.integers(0, s, (b, l)) for s in sizes], -1).astype(np.float32)


EMBEDDINGS = [(name, embed_type, freq) for name in ("DataEmbedding", "DataEmbedding_wo_pos")
              for embed_type in ("fixed", "learned") for freq in ("h", "t")]
EMBEDDINGS.append(("DataEmbedding_onlypos", None, "h"))


@pytest.mark.parametrize("name,embed_type,freq", EMBEDDINGS)
def test_embeddings_match_jax(rng, name, embed_type, freq):
    """The ``fixed`` (sinusoidal tables, a non-persistent buffer, so
    ``load_flax_params`` carries exactly the JAX parameters) and ``learned``
    (trained ``embedding`` tables) calendar embeddings, with and without the
    minute, inside the three data embeddings. f32 at 1e-5."""
    c_in, d_model, b, l = 5, 16, 2, 12
    if name == "DataEmbedding_onlypos":  # no temporal embedding
        jax_mod = jax_embed.DataEmbedding_onlypos(c_in, d_model, 0.0, rngs=nnx.Rngs(0))
        port = embed.DataEmbedding_onlypos(c_in, d_model, 0.0)
    else:
        jax_mod = getattr(jax_embed, name)(c_in, d_model, embed_type, freq, 0.0,
                                           rngs=nnx.Rngs(0))
        port = getattr(embed, name)(c_in, d_model, embed_type, freq, 0.0)
    flat = export_params(jax_mod, rng)
    assert load_flax_params(port, flat) == len(port.state_dict()) == len(flat)
    port.eval()
    x = rng.normal(size=(b, l, c_in)).astype(np.float32)
    marks = _marks(rng, b, l, freq)
    want = np.asarray(jax_mod(jnp.asarray(x), jnp.asarray(marks)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(marks)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_fixed_embedding_table_matches_jax():
    """The sinusoidal table: f32 sin and cos of XLA and of torch, a few
    ulps apart (6e-8 measured), so 1e-6; an unknown ``embed`` refused."""
    np.testing.assert_allclose(embed.FixedEmbedding(24, 16).weight.numpy(),
                               np.asarray(jax_embed.FixedEmbedding(24, 16).weight), atol=1e-6)
    with pytest.raises(ValueError, match="embed must be"):
        embed.DataEmbedding(5, 16, "monthly")
