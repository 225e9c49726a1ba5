"""The port's mesh rule and placement against the JAX package's, on the CPU.

- ``param_spec`` against JAX's on random shapes, and the layout of every
  parameter of the real flagship Informer (d832, d_ff 3328) and SwinV2-base
  (built on the meta device; JAX's with ``nnx.eval_shape``) at
  ``n_model=2``, with and without FSDP over ``n_data=4``, at
  ``min_shard_dim=512``: the port decides each kernel on its flax layout
  (``layout_spec``), so the specs equal JAX's mapped through
  ``convert.load_flax_params``' renames, unstacking and transposes.
- The batch placement helpers.
- A mesh of one rank (a world-1 gloo group in this process): the trainer's
  steps, with and without FSDP, and its MC eval give the same bits as the
  trainer without a mesh.

The multi-rank mesh is held in ``test_torch_mesh_train.py``."""

import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist

from routeformer_torch.convert import _SCANNED, flax_to_torch_names
from routeformer_torch.parallel import mesh as meshlib

MIN_SHARD, N_MODEL, N_DATA = 512, 2, 4
PRIMES = (101, 103, 107, 109, 113)  # distinct from every stack length


def _jax_flat(build):
    from flax import nnx

    model = nnx.eval_shape(build)
    return {".".join(str(p) for p in path): tuple(var.get_value().shape)
            for path, var in nnx.to_flat_state(nnx.state(model, nnx.Param))}


def _jax_specs_in_torch_layout(flat_shapes: dict, n_data_fsdp: int, n_model: int = N_MODEL,
                               min_shard: int = MIN_SHARD) -> dict:
    """JAX's ``param_spec`` of each flax parameter, carried to the port's
    name and layout by ``flax_to_torch_names``: each parameter goes through
    it as a stand-in of distinct prime dims (the stacked axis at its real
    length), and the stand-in's dims say where each spec entry lands."""
    from routeformer_tpu.parallel.mesh import param_spec as jax_param_spec

    out = {}
    for name, shape in flat_shapes.items():
        spec = tuple(jax_param_spec(_Shape(shape), n_model, min_shard,
                                    n_data_fsdp=n_data_fsdp))
        spec = spec + (None,) * (len(shape) - len(spec))
        stacked = bool(_SCANNED.search(name))
        probe = np.empty(((shape[0],) if stacked else ()) + PRIMES[:len(shape) - stacked],
                         np.int8)
        for torch_name, arr in flax_to_torch_names({name: probe}).items():
            src = probe.shape[1:] if stacked else probe.shape
            src_spec = spec[1:] if stacked else spec
            dims = [src.index(d) for d in arr.shape]
            got = tuple(src_spec[j] for j in dims)
            out[torch_name] = got if any(got) else ()
    return out


class _Shape:
    """A shape-only stand-in for ``param_spec`` (no allocation)."""

    def __init__(self, shape):
        self.shape = tuple(shape)
        self.ndim = len(shape)


def _flagship_cfg():
    import sys

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parents[1]))
    from __graft_entry__ import _flagship_config

    return _flagship_config()


def _informer_pair():
    from flax import nnx

    from routeformer_torch.flagship import flagship_config
    from routeformer_torch.models import Routeformer
    from routeformer_tpu.models.gps_backbone import Informer
    from routeformer_tpu.models.routeformer import Routeformer as JaxRouteformer

    off = dict(with_video=False, with_gaze=False, with_scene=False, dense_prediction=False)
    jcfg = _flagship_cfg().override(**off)
    flat = _jax_flat(lambda: JaxRouteformer(jcfg, gps_backbone=Informer,
                                            rngs=nnx.Rngs(0, dropout=1)))
    with torch.device("meta"):
        port = Routeformer(flagship_config().override(**off))
    return flat, port


def _swin_pair():
    from flax import nnx

    from routeformer_torch.models.video_backbone import SwinV2Backbone
    from routeformer_torch.models.video_backbone import TimmBackboneConfig
    from routeformer_tpu.models.video_backbone import SwinV2Backbone as JaxSwin
    from routeformer_tpu.models.video_backbone import TimmBackboneConfig as JaxTimm

    kind = "swinv2_base_window12to16_192to256.ms_in22k_ft_in1k"
    flat = _jax_flat(lambda: JaxSwin(JaxTimm(model_type=kind, cache_enabled=False),
                                     rngs=nnx.Rngs(0, dropout=1)))
    with torch.device("meta"):
        port = SwinV2Backbone(TimmBackboneConfig(model_type=kind))
    return flat, port


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "tp+fsdp"])
@pytest.mark.parametrize("model", ["informer_d832", "swinv2_base"])
def test_flagship_layout_matches_jax(model, fsdp):
    """Every parameter's spec equals JAX's (``n_model=2``, FSDP
    ``n_data=4``, ``min_shard_dim=512``), and the big matrices shard."""
    flat, port = (_informer_pair if model == "informer_d832" else _swin_pair)()
    n_data_fsdp = N_DATA if fsdp else 1
    want = _jax_specs_in_torch_layout(flat, n_data_fsdp)
    got = meshlib.module_specs(port, N_MODEL, MIN_SHARD, n_data_fsdp)
    assert set(got) == set(want)
    diff = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not diff, list(diff.items())[:5]
    sharded = [k for k, s in got.items() if meshlib.MODEL_AXIS in s]
    assert len(sharded) >= (40 if model == "informer_d832" else 60), len(sharded)
    if fsdp:
        assert any(meshlib.DATA_AXIS in s for s in got.values())
    if model == "informer_d832":
        ff1 = got["gps_backbone.encoder.attn_layers.0.ff1.weight"]
        assert ff1 == (meshlib.MODEL_AXIS, meshlib.DATA_AXIS if fsdp else None)  # (3328, 832)
    for name, p in port.named_parameters():
        for size, axis in zip(p.shape, got[name]):
            if axis is not None:
                assert size % (N_MODEL if axis == meshlib.MODEL_AXIS else N_DATA) == 0
                assert size >= MIN_SHARD


def _zoo_gps_pair(name):
    """A GPS backbone of the zoo at the flagship's GPS widths: the JAX
    package's flat parameter shapes (``nnx.eval_shape``) and the port's on
    the meta device (``layout.gps_backbones``)."""
    import dataclasses

    from flax import nnx

    from routeformer_torch.parallel.layout import gps_backbones
    from routeformer_tpu.models.gps_backbone.autoformer import Autoformer as JaxAutoformer
    from routeformer_tpu.models.gps_backbone.config import FEDFormerBackboneConfig as JaxFED
    from routeformer_tpu.models.gps_backbone.config import GPSBackboneConfig as JaxGPS
    from routeformer_tpu.models.gps_backbone.fedformer import FEDformer as JaxFEDformer

    port, cfg = gps_backbones()[name]
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.init}
    fields.update(_enc_in=cfg.enc_in, _c_out=cfg.c_out)
    if name == "Autoformer":
        build = lambda: JaxAutoformer(JaxGPS(**fields), rngs=nnx.Rngs(0, dropout=1))  # noqa: E731
    else:
        build = lambda: JaxFEDformer(JaxFED(**fields), rngs=nnx.Rngs(0, dropout=1))  # noqa: E731
    return _jax_flat(build), port


# The split of the zoo's layers at the flagship's GPS widths (d832, d_ff
# 3328; the Wavelets blocks' c k = 1024): layer -> kind.
ZOO_KINDS = {
    "encoder.attn_layers.0.attention.query_projection": "row",  # square: the tie-break
    "encoder.attn_layers.0.attention.out_projection": "row",
    "encoder.attn_layers.0.ff1": "column",
    "encoder.attn_layers.0.ff2": "row",
    "decoder.layers.0.cross_attention.value_projection": "row",
    "decoder.layers.0.projection": "row",  # the circular trend convolution, over d_model
}
WAVELET_KINDS = {
    "encoder.attn_layers.0.attention.inner.Lk0": "column",
    "encoder.attn_layers.0.attention.inner.Lk1": "row",
    "encoder.attn_layers.0.attention.inner.mwt_cz.0.A": "row",  # SparseKernelFT1d
    # the cross block's c k = 512 < 832: the model dim is the larger
    "decoder.layers.0.cross_attention.inner.Lq": "row",
    "decoder.layers.0.cross_attention.inner.out": "column",
}


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "tp+fsdp"])
@pytest.mark.parametrize("model", ["Autoformer", "FEDformer-Wavelets"])
def test_zoo_gps_layout_matches_jax(model, fsdp):
    """Autoformer and FEDformer Wavelets at the flagship's GPS widths: every
    parameter's spec equals JAX's (``n_model=2``, FSDP ``n_data=4``), and
    the layers split as GSPMD partitions them (``split_layers``): the square
    projections and ff2 by rows, ff1 by columns, the trend convolution by
    its input channels; the Wavelets transform's Lk0 (832 -> c k = 1024)
    by columns, its Lk1 and spectral weights by rows, the cross block's Lq
    (832 -> 512) by rows and its out by columns."""
    flat, port = _zoo_gps_pair(model)
    n_data_fsdp = N_DATA if fsdp else 1
    want = _jax_specs_in_torch_layout(flat, n_data_fsdp)
    got = meshlib.module_specs(port, N_MODEL, MIN_SHARD, n_data_fsdp)
    assert set(got) == set(want)
    diff = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not diff, list(diff.items())[:5]
    kinds = meshlib.split_layers(port, got)
    want_kinds = dict(ZOO_KINDS, **(WAVELET_KINDS if model == "FEDformer-Wavelets" else {}))
    assert {k: kinds.get(k) for k in want_kinds} == want_kinds


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [2, 4])
def test_split_dropout_is_one_process_dropout(dtype, n):
    """A kept column split's dropout (``split_dropout``) from one generator
    state on each of ``n`` column blocks, put back together, is the very
    output of one process's ``F.dropout`` on the whole activation: the
    same kept positions and the same bits (the CPU's draw and product)."""
    x = torch.randn(3, 5, 8 * n, generator=torch.Generator().manual_seed(1)).to(dtype)
    state = torch.get_rng_state()
    want = torch.nn.functional.dropout(x, 0.1, True)
    blocks = []
    for rank in range(n):
        torch.set_rng_state(state)
        blocks.append(meshlib.split_dropout(x.chunk(n, dim=-1)[rank], 0.1, -1, n, rank))
    got = torch.cat(blocks, dim=-1)
    assert got.dtype == dtype and torch.equal(got, want)
    assert 0 < int((want == 0).sum()) < want.numel()


def test_param_spec_is_jax_rule():
    """The rule itself, on random shapes (ties, small dims, 1-D, FSDP with
    and without a second eligible dim), at two ``min_shard_dim``."""
    from routeformer_tpu.parallel.mesh import param_spec as jax_param_spec

    rng = np.random.default_rng(0)
    sizes = (1, 2, 3, 8, 12, 16, 32, 48, 64, 96)
    for _ in range(400):
        shape = tuple(int(rng.choice(sizes)) for _ in range(int(rng.integers(1, 5))))
        x = _Shape(shape)
        for n_model, n_data, min_dim in ((2, 1, 16), (2, 4, 16), (1, 4, 32), (4, 2, 8)):
            want = tuple(jax_param_spec(x, n_model, min_dim, n_data_fsdp=n_data))
            assert meshlib.param_spec(x, n_model, min_dim, n_data) == want, (shape, n_model)


def test_batch_placement_helpers():
    """Rows in blocks: row ``r`` to shard ``r // (B / n_data)``; rank-0
    leaves replicated; an indivisible batch raises."""

    class Mesh:
        def __init__(self, n_data, d):
            self.n_data, self.d = n_data, d

        def size(self, i):
            return self.n_data if i == 0 else 1

        def get_local_rank(self, axis):
            return self.d

    assert meshlib.leaf_batch_spec(np.zeros((4, 3))) == (meshlib.DATA_AXIS, None)
    assert meshlib.leaf_batch_spec(np.float32(1.0)) == ()
    x = np.arange(24, dtype=np.float64).reshape(8, 3)
    blocks = [meshlib.place_batch_leaf(x, Mesh(4, d), torch.device("cpu")) for d in range(4)]
    assert all(b.dtype == torch.float32 for b in blocks)
    np.testing.assert_array_equal(torch.cat(blocks).numpy(), x.astype(np.float32))
    np.testing.assert_array_equal(blocks[2].numpy(), x[4:6])
    scalar = meshlib.place_batch_leaf(np.float32(3.0), Mesh(4, 1), torch.device("cpu"))
    assert scalar.item() == 3.0
    mine = torch.ones(2, 3)
    assert meshlib.place_batch_leaf(mine, Mesh(4, 1), torch.device("cpu")) is mine
    with pytest.raises(ValueError, match="not divisible"):
        meshlib.row_block(6, Mesh(4, 0))


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo process group of this process alone, torn down after."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield meshlib.make_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


def test_world_one_mesh_gives_the_same_bits(world_of_one):
    """On a mesh of one rank the trainer's two steps (plain and FSDP) and
    its MC eval give the bits of the trainer without a mesh: one data shard
    keeps the default streams, and nothing is sharded."""
    from test_torch_trainer import EPOCHS, TRAIN, VAL, port_trainer
    from test_torch_trainer import port_models as models

    torch.set_num_threads(1)
    ref_models = models()
    state = {n: {k: v.clone() for k, v in m.state_dict().items()}
             for n, m in ref_models.items()}
    ref = port_trainer(ref_models, unfreeze_epoch=None)
    want = []
    for epoch, batch in zip(EPOCHS, TRAIN):
        ref.epoch = epoch
        want.append(ref.training_step(batch))
    want_eval = ref.evaluate(VAL)
    for fsdp in (False, True):
        mine = models()
        for n, m in mine.items():
            m.load_state_dict(state[n])
        trainer = port_trainer(mine, unfreeze_epoch=None, mesh=world_of_one, fsdp=fsdp,
                               min_shard_dim=32)
        assert not any(hasattr(p, "mesh_spec") for p in mine["routeformer"].parameters())
        for i, (epoch, batch) in enumerate(zip(EPOCHS, TRAIN)):
            trainer.epoch = epoch
            got = trainer.training_step(batch)
            assert set(got) == set(want[i])
            for k in got:
                assert torch.equal(got[k], want[i][k]), (fsdp, i, k)
        for (k, a), b in zip(mine["routeformer"].named_parameters(),
                             ref_models["routeformer"].parameters()):
            assert torch.equal(a, b), (fsdp, k)
        got_eval = trainer.evaluate(VAL)
        for k in want_eval:
            assert torch.equal(got_eval[k], want_eval[k]), (fsdp, k)


def test_dryrun_multichip_four_ranks(capsys):
    """``dryrun_multichip(4)``: the four phases on 4 gloo CPU ranks, one
    line each, within its own 120 s limit (about 12 s on an 8-core host)."""
    from routeformer_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(4, timeout_s=120)
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(" OK")[0] for ln in lines[:4]] == [f"dryrun phase {k}" for k in range(1, 5)]
    assert "mesh=(data=2, model=2)" in lines[0] and "memo_encoded=" in lines[3]
    assert lines[4].startswith("dryrun_multichip OK")
