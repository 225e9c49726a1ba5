"""The serving export of the port (``routeformer_torch/serve.py``:
``export_model``/``ExportedModel``) against the JAX package's on the CPU,
and the kernels as registered ops (``routeformer::*``).

Limits: the exported prediction against JAX's exported prediction at the
same weights, 1e-5 absolute (JAX's own limit, ``tests/test_serve.py``);
the exported forward against the live one, 1e-5 absolute (the graph may
take other CPU matmul paths: 1.2e-6 measured), every kernel op call the
same bits; uint8 video against float16 video, 1e-3 absolute and 1e-4
relative (JAX's limit). ``torch.library.opcheck`` on each op with CPU
inputs (its fake implementation's shapes, dtypes and strides against the
plain version's)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from flax import nnx
from torch.utils._python_dispatch import TorchDispatchMode

from routeformer_tpu.models import RouteformerConfig as JaxConfig
from routeformer_tpu.models.gps_backbone import GPSBackboneConfig as JaxGPSConfig
from routeformer_tpu.models.gps_backbone import Informer as JaxInformer
from routeformer_tpu.models.routeformer import Routeformer as JaxRouteformer
from routeformer_tpu.serve import ExportedModel as JaxExportedModel
from routeformer_tpu.serve import _eval_forward as jax_eval_forward
from routeformer_tpu.serve import export_model as jax_export_model
from routeformer_torch import ExportedModel, export_model
from routeformer_torch.convert import load_flax_params
from routeformer_torch.flagship import init_weights
from routeformer_torch.models import Routeformer, RouteformerConfig
from routeformer_torch.models.gps_backbone import GPSBackboneConfig
from routeformer_torch.models.video_backbone import TimmBackbone, TimmBackboneConfig
from routeformer_torch.ops import flash_attention as fa
from routeformer_torch.ops import fusion_stack as fs
from routeformer_torch.ops import swin_block_fusion as sbf
from routeformer_torch.serve import _eval_forward
from test_torch_models import export_params
from test_torch_routeformer import _inputs, _kwargs
from test_torch_trainer import one_torch_thread  # noqa: F401  (autouse)

SEQ_LEN, PRED_LEN = 40, 30
GPS = dict(seq_len=SEQ_LEN, label_len=SEQ_LEN, pred_len=PRED_LEN, d_model=16, n_heads=4,
           e_layers=1, d_layers=1, d_ff=32, factor=4, dropout=0.1, activation="relu")
TOP = dict(discount_factor={0: 0.97}, epsilon=1.0)


def _gps_batch(rng, b=2):
    return {"gps": rng.normal(size=(b, SEQ_LEN, 2)).astype(np.float32)}


def _served(model, batch):
    data = export_model(model, batch)
    assert isinstance(data, bytes)
    return ExportedModel(data, _eval_forward(model)[1])


def test_export_matches_jax_export(rng):
    """JAX ``tests/test_serve.py``'s model (Informer d16): the port's
    exported program against JAX's exported program at the same weights."""
    jax_model = JaxRouteformer(JaxConfig(gps_backbone_config=JaxGPSConfig(**GPS), **TOP),
                               gps_backbone=JaxInformer, rngs=nnx.Rngs(0, dropout=1))
    port = Routeformer(RouteformerConfig(gps_backbone_config=GPSBackboneConfig(**GPS), **TOP))
    load_flax_params(port, export_params(jax_model, rng))
    batch = _gps_batch(rng)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jax_served = JaxExportedModel(jax_export_model(jax_model, jbatch),
                                  jax_eval_forward(jax_model)[1])
    got = _served(port, batch)(batch)
    want = np.asarray(jax_served(jbatch))
    assert got.shape == want.shape == (2, PRED_LEN, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_round_trip_refuses_a_wrong_shape(rng):
    """The bytes carry the program and no weights: reloaded with another
    model's leaves it serves that model's prediction; a batch of another
    shape is refused."""
    model = Routeformer(RouteformerConfig(gps_backbone_config=GPSBackboneConfig(**GPS), **TOP))
    init_weights(model, 3)
    other = Routeformer(RouteformerConfig(gps_backbone_config=GPSBackboneConfig(**GPS), **TOP))
    init_weights(other, 4)
    batch = _gps_batch(rng)
    data = export_model(model, batch)
    biggest = max(_eval_forward(model)[1], key=torch.Tensor.numel)
    assert biggest.numpy().tobytes() not in data
    for m in (model, other):
        with torch.no_grad():
            want = m.eval()({k: torch.from_numpy(v) for k, v in batch.items()})
        got = ExportedModel(data, _eval_forward(m)[1])(batch)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    with pytest.raises(Exception):
        ExportedModel(data, _eval_forward(model)[1])(_gps_batch(rng, b=3))
    with pytest.raises(ValueError, match="platforms"):
        export_model(model, batch, platforms=("cuda",))


def test_uint8_video_batch_exports(rng, monkeypatch):
    """JAX ``tests/test_serve.py:80``'s uint8 wire format: a ViT backbone
    (its attention through K4's op, ``ROUTEFORMER_FLASH=1``) exported at a
    uint8 video batch dequantizes in the program; against the float16
    batch of the same frames."""
    monkeypatch.setenv("ROUTEFORMER_FLASH", "1")
    gps = dict(GPS, dropout=0.0)
    cfg = RouteformerConfig(
        gps_backbone_config=GPSBackboneConfig(**gps),
        video_backbone_config=TimmBackboneConfig(model_type="vit_tiny_test",
                                                 cache_enabled=False,
                                                 compute_dtype="float32"),
        decoder_mode="smart", with_video=True, with_gaze=False, image_embedding_size=16,
        encoder_hidden_size=16, encoder_heads=4, encoder_layers=1, encoder_d_ff=32,
        cross_modal_decoder_heads=4, cross_modal_decoder_layers=1, output_fps=5,
        video_fps=1, gaze_fps=1, **TOP)
    model = Routeformer(cfg, video_backbone=TimmBackbone)
    init_weights(model, 0)
    model.eval()
    u8 = rng.integers(0, 256, (2, SEQ_LEN, 8, 12, 3)).astype(np.uint8)
    batch_u8 = dict(_gps_batch(rng), left_video=u8)
    batch_f16 = dict(batch_u8, left_video=u8.astype(np.float16) / np.float16(255.0))
    with torch.no_grad():
        want = model({k: torch.from_numpy(v) for k, v in batch_f16.items()})
    served = _served(model, batch_u8)
    assert "routeformer.dense_attention.default" in _op_names(served)
    np.testing.assert_allclose(served(batch_u8).numpy(), want.numpy(), atol=1e-3, rtol=1e-4)
    with pytest.raises(Exception):
        served(batch_f16)  # exported at uint8


def _op_names(served):
    return {str(n.target) for n in served._program.graph.nodes
            if str(n.target).startswith("routeformer.")}


class _Tape(TorchDispatchMode):
    """Every registered kernel op call's outputs, in order."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "routeformer":
            outs = out if isinstance(out, tuple) else (out,)
            self.calls.append((str(func), [o.clone() for o in outs]))
        return out


def test_exported_forward_runs_the_kernel_ops(monkeypatch):
    """The flagship's layout at test widths (tanh-gelu SwinV2 in bf16, so
    K1's three ops with K2's inside; the fused Perceive stack, K3a): the
    exported program holds the ops and calls them as the live forward
    does, with the same bits in every call; the prediction within 1e-5."""
    monkeypatch.setenv("ROUTEFORMER_FUSION_KERNEL", "1")
    gps, video, top = _kwargs(4)
    cfg = RouteformerConfig(gps_backbone_config=GPSBackboneConfig(**gps),
                            video_backbone_config=TimmBackboneConfig(
                                **dict(video, gelu="tanh", compute_dtype="bfloat16")),
                            **top)
    model = Routeformer(cfg)
    init_weights(model, 3)
    model.eval()
    batch = _inputs(1)
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad(), _Tape() as live:
        want = model(tensors)[0]
    served = _served(model, batch)
    assert _op_names(served) == {"routeformer.gemm_bias_act.default",
                                 "routeformer.window_attention.default",
                                 "routeformer.swin_block_tail.default",
                                 "routeformer.perceive_stack.default"}
    with _Tape() as exported:
        got = served(batch)
    assert [c[0] for c in exported.calls] == [c[0] for c in live.calls]
    assert len(live.calls) == 4 * 3 + 3  # 4 blocks x 3 ops, 3 Perceive stacks
    for (name, a), (_, b) in zip(live.calls, exported.calls):
        assert all(torch.equal(x, y) for x, y in zip(a, b)), name
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def _opcheck_cases(rng):
    def t(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)

    qkv = t(4, 16, 3, 2, 16)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # K1's strided views
    bias, scale = t(2, 2, 16, 16), t(2).abs() + 1
    qd, kd, vd = t(2, 3, 20, 12), t(2, 3, 24, 12), t(2, 3, 24, 12)
    c = 16
    tail = [t(c, c, dtype=torch.bfloat16), t(c), t(c) + 1, t(c), t(4 * c, c, dtype=torch.bfloat16),
            t(4 * c), t(c, 4 * c, dtype=torch.bfloat16), t(c), t(c) + 1, t(c)]
    n, d, f, r, l = 2, 16, 32, 3, 10
    w = fs.StackWeights(t(n, d, d), t(n, d), t(n, d, d), t(n, d), t(n, d, d), t(n, d),
                        t(n, d, d), t(n, d), t(n, d) + 1, t(n, d), t(n, d, f), t(n, f),
                        t(n, f, d), t(n, d), t(n, d) + 1, t(n, d))
    cnt = fs.sample_count_matrices(n, l, l, fs.prob_sparse_u(l, 5))
    masks = list(fs.make_dropout_masks(n, r, l, d, f, 0.1, generator=torch.Generator()
                                       .manual_seed(0)))
    return {
        "window_attention": [(fa.window_attention, (q, k, v, bias, scale, cosine, inner))
                             for cosine in (True, False) for inner in (True, False)]
        + [(fa.window_attention, (q.bfloat16(), k.bfloat16(), v.bfloat16(), bias, scale,
                                  True, False))],
        "dense_attention": [(fa.dense_attention, (x, y, z, causal, 0.3, inner))
                            for x, y, z in ((qd, kd, vd), (qd.bfloat16(), kd.bfloat16(),
                                                           vd.bfloat16()))
                            for causal in (True, False) for inner in (True, False)],
        "gemm_bias_act": [(sbf.gemm_bias_act_op, (t(10, 16, dtype=torch.bfloat16),
                                                  t(24, 16, dtype=torch.bfloat16), t(24),
                                                  act, dtype))
                          for act in (0, 1) for dtype in (torch.float32, torch.bfloat16)],
        "swin_block_tail": [(sbf.swin_block_tail, (t(12, c, dtype=dtype),
                                                   t(12, c, dtype=torch.bfloat16), *tail))
                            for dtype in (torch.float32, torch.bfloat16)],
        "perceive_stack": [(fs.perceive_stack, (t(r, l, d), list(w), [], cnt, m, 2,
                                                fs.prob_sparse_u(l, 5), p, "gelu", bf16,
                                                keep))
                           for m, p in (([], 0.0), (masks, 0.1))
                           for bf16 in (True, False) for keep in (True, False)],
    }


@pytest.mark.parametrize("op", ["window_attention", "dense_attention", "gemm_bias_act",
                                "swin_block_tail", "perceive_stack"])
def test_registered_ops_pass_opcheck(rng, op):
    """Each op with CPU inputs (K1's strided qkv views, both K2 and K4
    output layouts, K3a with and without dropout masks, keeping its inputs
    or not): schema, fake implementation, dispatch."""
    for fn, args in _opcheck_cases(rng)[op]:
        torch.library.opcheck(fn, args)
