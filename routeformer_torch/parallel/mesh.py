"""The ``(data, model)`` mesh over several cards (counterpart of
``routeformer_tpu/parallel/mesh.py``).

One process per card (``torchrun``, or the driver spawning one rank per
visible card) joins a process group, NCCL on CUDA and gloo only when the
caller asks for the CPU, and the ranks form a
``torch.distributed.device_mesh.DeviceMesh`` with dims ``("data",
"model")``; rank ``d * n_model + m`` sits at ``(d, m)``.

- ``data``: batch row ``r`` of a global batch of ``B`` goes to data shard
  ``r // (B / n_data)``; each rank reads, places and computes only its own
  row block, and the gradients are the global-batch mean (GSPMD's psum,
  DDP's all-reduce).
- ``model``: the structural rule ``param_spec`` (copied from the JAX
  package: same tie-break, same ``min_shard_dim``) lays out each parameter
  and its AdamW moments: its largest dim splits over ``model`` when it is
  at least ``min_shard_dim`` and divisible by ``n_model``; with FSDP the
  largest remaining eligible dim also splits over ``data``; the rest is
  replicated. A rank stores its block of each parameter (``MeshParams``).
  The ``model`` axis is tensor parallelism, as GSPMD partitions the JAX
  package's sharded matmuls: an ``nn.Linear`` or ``nn.Conv1d`` whose weight
  splits over ``model`` along a channel dim (``split_layers``) computes on
  this rank's block and is never gathered whole; so does FEDformer's
  ``SparseKernelFT1d``, whose spectral weights split over their input
  channels (``split_weights``: a class's ``mesh_split_forward``). A
  *column* split (the output channels) computes this rank's output
  columns, all-gathered along the feature dim unless the layer's output
  reaches a row-split layer through elementwise ops only
  (``mesh_split_pairs``: an FFN's ``ff1 -> activation -> dropout ->
  ff2``, the Informer's, PatchTST's and the Autoformer layers'); a *row*
  split (the input channels) computes a partial product on this rank's
  input channels, summed over ``model``, its bias added once after the
  sum. The conjugate autograd functions (identity one way, a sum over
  ``model`` the other) keep every rank's gradients those of one process.
  Every other sharded weight is gathered whole one *unit* at a time: the
  module a kernel or a layer consumes whole (a SwinV2 block pair, a ViT
  block, a whole Perceive stack, an encoder or decoder layer: classes
  with ``mesh_gather_unit``; otherwise the module that owns the
  parameter), just before the unit runs, released when it returns, and
  gathered again when the backward needs them (``MeshParams.gathered``).
  A unit that hands its whole weights to a kernel (``mesh_whole_weights``:
  K1's tanh SwinV2 pairs, K3a/K3b's fused Perceive stacks) gathers its
  split layers' weights too, as GSPMD cannot partition a ``pallas_call``.
  A module with children that owns a sharded parameter itself (a ViT's
  positional embedding, the Routeformer's stream embeddings) is read
  outside its own call too, so its weights stay gathered for the whole
  step; a read of a block outside its unit raises.
  A gathered weight's gradient is cut to the rank's ``model`` block, a
  split weight's is that block from the start; both are then reduced over
  ``data`` (a reduce-scatter along the dim FSDP split, else an all-reduce
  of the block), and the replicated gradients in buckets, each reduction
  launched during the backward once its gradient is complete, in one
  order on every rank, as GSPMD places each reduction in the backward
  (``MeshParams.gathered``). Under FSDP a split weight is gathered over
  ``data`` only, up to this rank's ``model`` block, just before its layer
  runs.

FSDP2's ``fully_shard`` places one sharded dim per parameter over one mesh
(HSDP: replicate over one dim, shard over the other), while the rule under
FSDP splits two dims over two axes; so the port stores the rule's blocks
itself, with plain collectives and its own per-unit gathers.

A batch under the mesh: a numpy leaf is the global batch (this rank takes
its row block, as JAX's ``device_put`` shards a host array), a tensor is
this rank's rows already (a mesh ``DataLoader``'s, the mesh memo's) and
passes unchanged.
"""

import contextlib
import datetime
import math
import os
import re
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.utils import _pytree

from routeformer_torch.ops.weight_cache import derived
from routeformer_torch.utils.device import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
DEFAULT_TIMEOUT_S = 1800.0
BUCKET_BYTES = 25 * 2 ** 20  # a bucket of replicated gradients, as DDP's default


def init_distributed(device: DeviceLike = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group of a ``torchrun``-style launch (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; ``LOCAL_RANK`` picks
    the card) unless one is initialised already: NCCL when this rank runs
    on CUDA (the default), gloo when ``device`` is the CPU. Every
    collective gives up after ``timeout_s``. Returns this rank's device."""
    cpu = device is not None and torch.device(device).type == "cpu"
    if not dist.is_initialized():
        for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
            if var not in os.environ:
                raise RuntimeError(
                    f"init_distributed: {var} is not set; launch with torchrun "
                    "(or set RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT)")
        timeout = datetime.timedelta(seconds=timeout_s)
        if cpu:
            dist.init_process_group("gloo", init_method="env://", timeout=timeout)
        else:
            resolve_device("cuda")  # raises without CUDA
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
            torch.cuda.set_device(dev)
            dist.init_process_group("nccl", init_method="env://", timeout=timeout,
                                    device_id=dev)
    return resolve_device(device)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device: DeviceLike = None):
    """The ``(data, model)`` ``DeviceMesh`` over every rank of the process
    group (``n_data * n_model`` must be the world size; ``n_data`` defaults
    to ``world // n_model``), on ``device``'s type (CUDA by default). Its
    groups take the process group's backend: a gloo group carries CUDA
    tensors too (gloo stages them through the host), which is how several
    ranks share one card, as NCCL refuses two ranks on one device."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call init_distributed first")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} needs {n_data * n_model} ranks, "
                         f"the process group has {world}")
    # The mesh's groups carry plain collectives only (no DTensor), so a gloo
    # group is laid out as a CPU mesh whatever device its tensors are on.
    kind = "cpu" if dist.get_backend() == "gloo" else resolve_device(device).type
    return init_device_mesh(kind, (n_data, n_model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def check_mesh(mesh) -> None:
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) or mesh.mesh_dim_names != (DATA_AXIS, MODEL_AXIS):
        raise TypeError(f"mesh= takes the DeviceMesh of make_mesh (dims {DATA_AXIS!r}, "
                        f"{MODEL_AXIS!r}), not {type(mesh).__name__}")


def is_main_rank() -> bool:
    """Rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


# ------------------------------------------------------------- batches -- #


def row_block(n_rows: int, mesh) -> slice:
    """This rank's rows of a global batch of ``n_rows``."""
    n_data = mesh.size(0)
    if n_rows % n_data:
        raise ValueError(f"batch {n_rows} not divisible by data-parallel degree {n_data}")
    rows = n_rows // n_data
    d = mesh.get_local_rank(DATA_AXIS)
    return slice(d * rows, (d + 1) * rows)


def batch_spec() -> tuple:
    """The placement of a batch's leading dim: over ``data``."""
    return (DATA_AXIS,)


def leaf_batch_spec(x) -> tuple:
    """The placement of one batch leaf: the leading dim over ``data``,
    rank-0 leaves replicated."""
    ndim = getattr(x, "ndim", 0)
    return (DATA_AXIS,) + (None,) * (ndim - 1) if ndim >= 1 else ()


def place_batch_leaf(x, mesh, device: torch.device) -> torch.Tensor:
    """This rank's block of one batch leaf, on ``device``: a numpy leaf is
    global (its row block is taken; float64 as float32, as JAX places it),
    a tensor is this rank's already."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    x = np.asarray(x)
    if leaf_batch_spec(x):
        x = x[row_block(x.shape[0], mesh)]
    if x.dtype == np.float64:
        x = x.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def shard_batch(batch: dict, mesh, device: torch.device) -> dict:
    """``place_batch_leaf`` over a nested batch dict."""
    return {k: shard_batch(v, mesh, device) if isinstance(v, dict)
            else place_batch_leaf(v, mesh, device) for k, v in batch.items()}


def gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """The data shards' row blocks of ``t`` concatenated in global row
    order (every rank gets the whole)."""
    n_data = mesh.size(0)
    if n_data == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n_data)]
    dist.all_gather(parts, t, group=mesh.get_group(DATA_AXIS))
    return torch.cat(parts)


def mean_over_data(values: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """Per-shard means of equal row blocks -> the global-batch means."""
    n_data = mesh.size(0)
    if n_data == 1 or not values:
        return values
    stacked = torch.stack([v.float() for v in values.values()])
    dist.all_reduce(stacked, group=mesh.get_group(DATA_AXIS))
    stacked = stacked / n_data
    return dict(zip(values, stacked.unbind()))


def sum_over_world(counts: Dict, device: torch.device) -> Dict:
    """Integer counters summed over every rank (nested dicts)."""
    flat = []

    def walk(d):
        for v in d.values():
            walk(v) if isinstance(v, dict) else flat.append(int(v))

    walk(counts)
    if not dist.is_initialized() or not flat:
        return counts
    t = torch.tensor(flat, dtype=torch.int64, device=device)
    dist.all_reduce(t)
    it = iter(t.tolist())

    def rebuild(d):
        return {k: rebuild(v) if isinstance(v, dict) else next(it) for k, v in d.items()}

    return rebuild(counts)


# -------------------------------------------------------------- streams -- #


def share_streams(models, mesh, device: torch.device) -> Optional[torch.Generator]:
    """Split the random streams of ``models`` on a mesh with several data
    shards: per-batch draws (``Routeformer``'s decisions, ``ProbAttention``'s
    training key samples: modules with a ``shared_generator`` attribute)
    from one generator that every rank seeds alike, so every rank runs the
    same modules; per-row draws (noise, dropout masks) from the default
    generators, reseeded per data shard (a model-axis replica draws what its
    shard's other ranks draw). Modules with a ``data_group`` attribute
    (PatchTST's BatchNorm) get the data shards' group. Returns the shared
    generator, or None with one data shard (its streams are one device's)."""
    n_data = mesh.size(0)
    if n_data == 1:
        return None
    seed = torch.randint(0, 2 ** 62, (1,), dtype=torch.int64).to(device)
    dist.broadcast(seed, src=0)
    seed = int(seed.item())
    shared = torch.Generator(device=device).manual_seed(seed)
    torch.manual_seed(seed + 1 + mesh.get_local_rank(DATA_AXIS))
    group = mesh.get_group(DATA_AXIS)
    for model in models:
        for module in model.modules():
            if hasattr(module, "shared_generator"):
                module.shared_generator = shared
            if hasattr(module, "data_group"):
                module.data_group = group
    return shared


class _AllReduceSum(torch.autograd.Function):
    """A sum over ``group`` whose gradient is the sum of the ranks'
    gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def global_moments(x: torch.Tensor, dims: tuple, group):
    """``(mean, biased variance, count)`` over ``dims`` of every data
    shard's rows: the sum, the sum of squares and the count all-reduced over
    ``group`` through autograd (the backward all-reduces their gradients),
    as a BatchNorm's statistics over the global batch under GSPMD."""
    c = x.shape[next(d for d in range(x.ndim) if d not in dims)]
    count = torch.full((1,), x.numel() // c, dtype=x.dtype, device=x.device)
    sums = _AllReduceSum.apply(torch.cat([x.sum(dim=dims), (x * x).sum(dim=dims), count]),
                               group)
    mean = sums[:c] / sums[-1]
    return mean, torch.clamp(sums[c:2 * c] / sums[-1] - mean * mean, min=0.0), sums[-1]


# ----------------------------------------------------- tensor parallel -- #


class _CopyToModel(torch.autograd.Function):
    """Identity; the backward sums the gradient over ``group``: the input
    of a column split, which every ``model`` rank holds whole and each
    differentiates through its own output columns only."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _SumOverModel(torch.autograd.Function):
    """The sum over ``group`` of a row split's partial products; the
    backward is the identity (every ``model`` rank consumes the sum alike,
    so each holds the whole gradient already)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SliceFeatures(torch.autograd.Function):
    """This rank's block of ``dim`` of a tensor every ``model`` rank holds
    whole (a row split's input channels, a column split's replicated
    bias); the backward all-gathers the blocks' gradients."""

    @staticmethod
    def forward(ctx, x, dim, group, n, rank):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        size = x.shape[dim] // n
        return x.narrow(dim, rank * size, size)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather_cat(grad, ctx.dim, ctx.group, ctx.n), None, None, None, None


class _GatherFeatures(torch.autograd.Function):
    """The ``model`` ranks' blocks of ``dim`` concatenated (a column
    split's output, gathered); the backward takes this rank's block."""

    @staticmethod
    def forward(ctx, x, dim, group, n, rank):
        ctx.dim, ctx.rank, ctx.size = dim, rank, x.shape[dim]
        return _all_gather_cat(x, dim, group, n)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None, None, None


def _all_gather_cat(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


_SPLIT_TYPES = (nn.Linear, nn.Conv1d)


def split_weights(m: nn.Module) -> Optional[tuple]:
    """``(weight names, input-channel dim, output-channel dim)`` of a layer
    the ``model`` axis can split, else None: an ``nn.Linear`` or
    ``nn.Conv1d`` (``weight``; outputs torch dim 0, inputs dim 1), or a
    class that declares ``mesh_split_weights`` and ``mesh_channel_dims``
    and computes on its blocks in ``mesh_split_forward(split, *args)``
    (``SparseKernelFT1d``; an output dim of None: no column split)."""
    if isinstance(m, _SPLIT_TYPES):
        return ("weight",), 1, 0
    names = getattr(type(m), "mesh_split_weights", None)
    return None if names is None else (names, *type(m).mesh_channel_dims)


def whole_weights(module: nn.Module) -> bool:
    """Whether ``module`` hands its whole weights to a kernel now (its
    class's ``mesh_whole_weights``, a flag or a method): a unit that does
    gathers its split layers' weights too and runs them unsplit."""
    flag = getattr(module, "mesh_whole_weights", False)
    return bool(flag() if callable(flag) else flag)


def split_layers(module: nn.Module, specs: Dict[str, tuple]) -> Dict[str, str]:
    """``{layer name: "column" | "row"}``: every layer of a module tree
    (``split_weights``) whose weight ``specs`` (``{parameter name: spec}``)
    shards over ``model`` along a channel dim (the outputs: a column split;
    the inputs: a row split). Whether a layer computes split at a call also
    depends on its unit (``whole_weights``)."""
    out = {}
    for name, m in module.named_modules():
        found = split_weights(m)
        if found is None:
            continue
        names, d_in, d_out = found
        spec = specs.get(f"{name}.{names[0]}" if name else names[0], ())
        if spec and d_out is not None and spec[d_out] == MODEL_AXIS:
            out[name] = "column"
        elif spec and spec[d_in] == MODEL_AXIS:
            out[name] = "row"
    return out


def split_params(layer: nn.Module, kind: str, specs_of) -> list:
    """The parameters a split layer computes on as blocks: its split
    weights, and a column split's bias where the rule shards it alike (a
    scan's stacked bias). ``specs_of(parameter)`` gives a parameter's spec."""
    out = [getattr(layer, n) for n in split_weights(layer)[0]]
    bias = layer.bias if isinstance(layer, _SPLIT_TYPES) else None
    if kind == "column" and bias is not None and specs_of(bias) == (MODEL_AXIS,):
        out.append(bias)
    return out


# --------------------------------------------------------- parameters -- #


def param_spec(x, n_model: int, min_shard_dim: int = 512, n_data_fsdp: int = 1) -> tuple:
    """Structural sharding rule for one parameter (the JAX package's,
    verbatim): a tuple with an axis name or None per dim, ``()`` when
    replicated.

    Tensor parallelism: the largest dim, when divisible by ``n_model`` and
    at least ``min_shard_dim``, shards over the ``model`` axis.

    FSDP (``n_data_fsdp > 1``): the data axis takes the largest eligible
    dim NOT already claimed by the model axis (divisible by
    ``n_data_fsdp`` and at least ``min_shard_dim``); with no second
    eligible dim the parameter stays replicated over ``data``.
    """
    if x.ndim < 2:
        return ()
    dims = list(x.shape)
    # stable tie-break (lowest index first)
    order = sorted(range(x.ndim), key=lambda i: (-dims[i], i))
    spec = [None] * x.ndim
    if n_model > 1:
        largest = order[0]
        if dims[largest] % n_model == 0 and dims[largest] >= min_shard_dim:
            spec[largest] = MODEL_AXIS
    if n_data_fsdp > 1:
        for d in order:
            if spec[d] is not None:
                continue
            if dims[d] % n_data_fsdp == 0 and dims[d] >= min_shard_dim:
                spec[d] = DATA_AXIS
                break
    if all(s is None for s in spec):
        return ()
    return tuple(spec)


# The torch layout of a flax kernel (``convert.py``): torch dim i holds the
# flax kernel's dim _KERNEL_DIMS[ndim][i] (Linear (in, out) -> (out, in),
# Conv1d (k, in, out) -> (out, in, k), Conv2d HWIO -> OIHW).
_KERNEL_DIMS = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}
# A layer of a flax scan (``convert.py``'s ``stacked_layers``, ``pairs``,
# ``blocks``): its parameters carry a leading layer axis in the JAX package.
_LAYER = re.compile(r"(^|\.)(stacked_layers|pairs|blocks)\.(\d+)\.")


def layout_spec(name: str, x, n_model: int, min_shard_dim: int = 512,
                n_data_fsdp: int = 1, n_layers: Optional[int] = None) -> tuple:
    """``param_spec`` of one of the port's parameters, decided on the JAX
    package's layout of it (the names follow ``convert.load_flax_params``):
    a ``.weight`` of 2-4 dims is a flax kernel stored transposed, and a
    parameter of layer ``i`` of a scan (``n_layers`` of them) is row ``i``
    of a stacked parameter with a leading layer axis. The rule runs on that
    shape and its answer is carried back, so the port's layout is GSPMD's:
    tie-breaks on square kernels and the 1-D parameters a scan stacks into
    2-D included. (A decision on the layer axis itself, which needs a layer
    of at least ``min_shard_dim`` layers, would be dropped: no scan of the
    port's models is that deep.)"""
    perm = _KERNEL_DIMS.get(x.ndim) if name.endswith("weight") else None
    perm = tuple(range(x.ndim)) if perm is None else perm
    shape = [0] * x.ndim
    for i, j in enumerate(perm):
        shape[j] = x.shape[i]
    if n_layers is not None:
        shape = [n_layers] + shape
    spec = param_spec(torch.empty(shape, device="meta"), n_model, min_shard_dim, n_data_fsdp)
    if not spec:
        return ()
    if n_layers is not None:
        spec = spec[1:]
    spec = tuple(spec[j] for j in perm)
    return spec if any(a is not None for a in spec) else ()


def module_specs(module: nn.Module, n_model: int, min_shard_dim: int = 512,
                 n_data_fsdp: int = 1) -> Dict[str, tuple]:
    """``{parameter name: layout_spec}`` of a module tree."""
    params = dict(module.named_parameters())
    layers = {}
    for name in params:
        m = _LAYER.search(name)
        if m:
            key = name[:m.start(3)] + "*" + name[m.end(3):]
            layers[key] = max(layers.get(key, 0), int(m.group(3)) + 1)

    def n_layers(name):
        m = _LAYER.search(name)
        return layers[name[:m.start(3)] + "*" + name[m.end(3):]] if m else None

    return {name: layout_spec(name, p, n_model, min_shard_dim, n_data_fsdp, n_layers(name))
            for name, p in params.items()}


def param_shardings(module: nn.Module, mesh, min_shard_dim: int = 512,
                    fsdp: bool = False) -> Dict[str, tuple]:
    """``{parameter name: spec}`` of a module on ``mesh``; the one place
    the rule meets a module tree (``MeshParams`` reads it)."""
    n_data, n_model = mesh.shape
    return module_specs(module, n_model, min_shard_dim, n_data if fsdp else 1)


def split_block_bytes(module: nn.Module, specs: Dict[str, tuple], units: Dict[str, list],
                      n_model: int) -> Dict[nn.Parameter, int]:
    """``{parameter: bytes gathered at its layer's call}`` for the split
    layers' weights and the column splits' biases the rule shards alike, in
    units that run split now (``whole_weights``): the ``model`` block where
    the spec also names ``data`` (FSDP gathers it over ``data``), else 0.
    Read before ``MeshParams`` replaces the data by the blocks."""
    modules = dict(module.named_modules())
    names = {p: n for n, p in module.named_parameters()}
    unit_of = {p: u for u, owners in units.items() for _, _, p in owners}
    out = {}
    for name, kind in split_layers(module, specs).items():
        for p in split_params(modules[name], kind, lambda q: specs.get(names.get(q))):
            if not whole_weights(modules[unit_of[p]]):
                nbytes = p.numel() * p.element_size() // n_model
                out[p] = nbytes if DATA_AXIS in specs[names[p]] else 0
    return out


def spec_block(full: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of a tensor laid out by ``spec``."""
    out = full
    for dim, axis in enumerate(spec):
        if axis is not None:
            n = mesh.size(0 if axis == DATA_AXIS else 1)
            size = out.shape[dim] // n
            out = out.narrow(dim, mesh.get_local_rank(axis) * size, size)
    return out


def spec_gather(block: torch.Tensor, spec: tuple, mesh, axes=(DATA_AXIS, MODEL_AXIS)
                ) -> torch.Tensor:
    """The whole tensor from every rank's ``spec`` block (a collective over
    the axes ``spec`` names); with ``axes``, gathered over those axes only
    (``(DATA_AXIS,)``: this rank's ``model`` block)."""
    out = block
    for dim, axis in enumerate(spec):
        if axis in axes:
            n = mesh.size(0 if axis == DATA_AXIS else 1)
            out = out.contiguous()
            parts = [torch.empty_like(out) for _ in range(n)]
            dist.all_gather(parts, out, group=mesh.get_group(axis))
            out = torch.cat(parts, dim=dim)
    return out


def _owner_params(module: nn.Module, sharded) -> list:
    """``(module name, module, attribute, parameter)`` for every attribute
    that holds a parameter of ``sharded`` (a tied parameter once per
    owner), in module order."""
    return [(name, m, k, p) for name, m in module.named_modules()
            for k, p in m._parameters.items() if p is not None and p in sharded]


def gather_units(module: nn.Module, sharded) -> Dict[str, list]:
    """``{unit name: [(owner module, attribute, parameter), ...]}``: the
    gather units of a module tree over the parameters in ``sharded``. A
    parameter's unit is its owner's outermost ancestor (the owner included)
    whose class sets ``mesh_gather_unit``, else its owner."""
    modules = dict(module.named_modules())
    units: Dict[str, list] = {}
    for name, m, k, p in _owner_params(module, sharded):
        parts = name.split(".") if name else []
        unit = name
        for i in range(len(parts) + 1):
            prefix = ".".join(parts[:i])
            if getattr(type(modules[prefix]), "mesh_gather_unit", False):
                unit = prefix
                break
        units.setdefault(unit, []).append((m, k, p))
    return units


def resident_units(module: nn.Module, units: Dict[str, list]) -> set:
    """The units ``MeshParams.gathered`` holds for the whole of its body:
    a module with children that owns a sharded parameter and is no
    ``mesh_gather_unit`` class. Such a module reads its own parameters in
    methods that its callers call directly (``TimmBackbone.encode_frames``
    the positional embedding, ``Routeformer.preprocess_batch`` the stream
    embeddings), where no hook on its call would see the read."""
    modules = dict(module.named_modules())
    return {u for u in units
            if not getattr(type(modules[u]), "mesh_gather_unit", False)
            and next(modules[u].children(), None) is not None}


def unit_gather_bytes(units: Dict[str, list], resident,
                      split: Optional[Dict[nn.Parameter, int]] = None) -> Dict[str, int]:
    """The bytes gathered at once while each unit runs: its own distinct
    parameters' whole bytes plus those of the ``resident`` units, which
    stay gathered throughout. A parameter in ``split`` (a split layer's
    weight or bias in a unit that runs split) counts the bytes given there
    instead: its ``model`` block where FSDP gathers it over ``data``, else
    0 (never gathered)."""
    split = split or {}
    own = {u: sum(split.get(p, p.numel() * p.element_size())
                  for p in {id(p): p for _, _, p in owners}.values())
           for u, owners in units.items()}
    always = sum(own[u] for u in resident)
    return {u: always + (0 if u in resident else own[u]) for u in units}


class _Block(torch.Tensor):
    """A sharded parameter's block as its module holds it inside
    ``MeshParams.gathered`` while its unit is not running. Its metadata
    (``dtype``, ``device``, ``shape``) reads as the block's; any operation
    on it raises, naming the parameter: the module would compute with a
    block where it expects the whole weight."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", None) == "__get__":  # a property
            with torch._C.DisableTorchFunctionSubclass():
                return func(*args)
        leaves = _pytree.tree_leaves((args, kwargs or {}))
        names = sorted({a.mesh_name for a in leaves if isinstance(a, _Block)})
        raise RuntimeError(
            f"sharded parameter {', '.join(names)} read outside its gather unit's call "
            "under MeshParams.gathered: only this rank's block is in place there. Read it "
            "inside a module call of its unit (parallel/mesh.py, gather_units).")


def _in_backward() -> bool:
    """Whether this thread runs a backward now (a remat's recomputation)."""
    return torch._C._current_graph_task_id() != -1


class _Slot:
    """One use of one sharded parameter under autograd (a gather, or a
    split layer's block): its gradient's arrival and the backward's
    re-gather (over ``axes``), cached from the first unpack of the weight
    to the arrival of its gradient (every consumer of the weight has run
    its backward by then). ``counted``: a use of the forward, whose arrival
    ``MeshParams`` waits for (a remat's recomputation inside the backward
    makes uses whose gradients never arrive)."""

    __slots__ = ("layout", "param", "axes", "regathered", "counted")

    def __init__(self, layout, param, axes=(DATA_AXIS, MODEL_AXIS)):
        self.layout, self.param, self.axes, self.regathered = layout, param, axes, None
        self.counted = not _in_backward()
        if self.counted:
            layout._used(param)

    def regather(self) -> torch.Tensor:
        if self.regathered is None:
            self.regathered = self.layout._gather(self.param, axes=self.axes)
        return self.regathered


class _GatherGrad(torch.autograd.Function):
    """The gathered weight (or a split layer's block) as a function of the
    parameter: its gradient goes to ``MeshParams._grad_arrived``; the
    parameter's ``.grad`` is written by ``reduce_grads``."""

    @staticmethod
    def forward(ctx, param, full, slot):
        ctx.slot = slot
        return full

    @staticmethod
    def backward(ctx, grad):
        slot = ctx.slot
        slot.regathered = None
        slot.layout._grad_arrived(slot.param, grad, slot.counted)
        return None, None, None


class _Packed:
    """A saved gathered weight (or a view of it), kept as its parameter and
    its view's geometry instead of its bytes."""

    __slots__ = ("slot", "param", "axes", "size", "stride", "offset")

    def __init__(self, slot, param, axes, t):
        self.slot, self.param, self.axes = slot, param, axes
        self.size, self.stride, self.offset = t.size(), t.stride(), t.storage_offset()


def split_dropout(x: torch.Tensor, p: float, dim: int, n: int, rank: int) -> torch.Tensor:
    """``F.dropout(whole, p)`` cut to block ``rank`` of ``n`` along ``dim``,
    where ``x`` is that block of ``whole``: the mask is drawn on the whole
    shape in ``x``'s dtype, so it is the draw one process makes (the fused
    CUDA kernel's draw order depends on the dtype it is given, through its
    vector width), and applied as that process's dropout does: on the CPU
    ``x`` times the noise, in ``x``'s dtype; on CUDA ``x`` times the kept
    mask times the f32 scale ``1 / (1 - p)``, rounded once, as the fused
    kernel computes it."""
    shape = list(x.shape)
    shape[dim] *= n
    noise = F.dropout(torch.ones(shape, dtype=x.dtype, device=x.device), p, True)
    size = x.shape[dim]
    noise = noise.narrow(dim, rank * size, size)
    if x.device.type == "cpu":
        return x * noise
    # the kernel's scale: 1 / (the keep probability as f32), in f64, to f32
    scale = 1.0 / float(np.float32(1.0 - p))
    return (x.float() * (noise != 0) * scale).to(x.dtype)


class _Split:
    """A split layer under ``MeshParams.gathered``: its ``forward`` stands
    in for the layer's own while the body runs. A column split computes
    this rank's output channels (all-gathered unless ``keep``: then a
    row-split layer takes them through elementwise ops only); a row split
    this rank's input channels' partial product, summed over ``model``,
    the bias added after the sum. A class with ``mesh_split_forward``
    computes on its blocks itself, through ``blocks``, ``take_input``,
    ``scatter_sum`` and ``gather``. In a unit gathered whole for a kernel
    (``whole_weights``) the layer runs its own forward on the whole
    weights."""

    def __init__(self, layout, layer: nn.Module, kind: str, unit: str):
        self.layout, self.layer, self.kind, self.unit = layout, layer, kind, unit
        names, d_in, _ = split_weights(layer)
        self._params = split_params(layer, kind, layout.sharded.get)
        self.weights = self._params[:len(names)]
        self.weight = self.weights[0]
        self.in_channels = self.weight.shape[d_in]  # whole: read before the blocks are cut
        self.dim = -1 if isinstance(layer, nn.Linear) else 1  # the channels of x and y
        # a column split's bias that the rule shards alike (a scan's stacked
        # bias): this rank's block, never gathered
        self.bias_block = self._params[len(names)] if len(self._params) > len(names) else None
        self.keep = False
        self.group = layout.mesh.get_group(MODEL_AXIS)
        self.n, self.rank = layout.n_model, layout.mesh.get_local_rank(MODEL_AXIS)

    def params(self) -> list:
        return list(self._params)

    def split_now(self) -> bool:
        return self.unit not in self.layout._whole

    def kept(self) -> bool:
        """Whether the layer's output is this rank's columns only now."""
        return self.keep and self.split_now()

    def forward(self, *args):
        layer, layout = self.layer, self.layout
        if not self.split_now():
            return type(layer).forward(layer, *args)
        custom = getattr(type(layer), "mesh_split_forward", None)
        if custom is not None:
            return custom(layer, self, *args)
        (x,) = args
        dt = getattr(layer, "compute_dtype", None)
        w = layout._block(self.weight, dt)
        if self.kind == "column":
            x = _CopyToModel.apply(x, self.group)
            if self.bias_block is not None:
                b = layout._block(self.bias_block)
            elif layer.bias is not None:
                b = _SliceFeatures.apply(layer.bias, 0, self.group, self.n, self.rank)
            else:
                b = None
            y = self._apply(x, w, b, dt)
            if self.keep:
                return y
            return self.gather(y, self.dim)
        x = self.take_input(x, self.dim)
        # the partial products are summed in their compute dtype, as GSPMD
        # reduces a bf16 product: a bf16 row split rounds one sum more
        y = _SumOverModel.apply(self._apply(x, w, None, dt), self.group)
        if layer.bias is not None:
            b = layer.bias
            y = y + (b if self.dim == -1 else b[:, None]).to(y.dtype)
        return y

    def _apply(self, x, w, b, dt):
        if isinstance(self.layer, nn.Conv1d):
            return self.layer._conv_forward(x, w, b)
        if dt is not None:
            x = x.to(dt)
            b = None if b is None else b.to(dt)
        return F.linear(x, w, b)

    def blocks(self) -> list:
        """This rank's blocks of the split weights, as the layer computes
        with them (``MeshParams._block``)."""
        return [self.layout._block(w) for w in self.weights]

    def take_input(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """A row split's input channels (``dim``): this rank's block of a
        whole input, or this rank's channels already."""
        size = self.in_channels // self.n
        if x.shape[dim] == self.in_channels:
            return _SliceFeatures.apply(x, dim, self.group, self.n, self.rank)
        if x.shape[dim] != size:
            raise ValueError(f"row-split {type(self.layer).__name__} takes {self.in_channels} "
                             f"input channels or this rank's {size}, got {tuple(x.shape)}")
        return x

    def scatter_sum(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of ``dim`` of the sum over ``model`` of the
        ranks' partial products, summed in their dtype (a reduce-scatter,
        written as an all-reduce and a cut; the backward all-gathers the
        blocks' gradients)."""
        return _SliceFeatures.apply(_SumOverModel.apply(x, self.group), dim, self.group,
                                    self.n, self.rank)

    def gather(self, y: torch.Tensor, dim: int) -> torch.Tensor:
        """The ``model`` ranks' blocks of ``dim`` of ``y`` concatenated."""
        return _GatherFeatures.apply(y, dim, self.group, self.n, self.rank)

    def dropout(self, module: nn.Dropout, x: torch.Tensor) -> torch.Tensor:
        """``module(x)`` on this layer's output (through elementwise ops).
        Where that output is this rank's columns only, the mask is drawn on
        the whole activation from the generator every ``model`` rank of a
        data shard shares, and cut to this rank's columns
        (``split_dropout``): the ranks agree on it, and it is the mask and
        the product one process's dropout makes."""
        if not (self.kept() and module.training and module.p > 0.0):
            return module(x)
        return split_dropout(x, module.p, self.dim, self.n, self.rank)


class MeshParams:
    """A module's parameters laid out on ``mesh`` by ``param_spec``.

    Building it broadcasts every parameter and buffer from rank 0 (the
    ranks start from the same weights, as DDP makes them) and replaces each
    sharded parameter's data by this rank's block, in place: the
    ``nn.Parameter`` objects and their names stay, so an optimizer built
    over them steps the blocks, and the AdamW moments take the blocks'
    shapes. Each sharded parameter carries ``mesh_spec``.

    The split layers (``split_layers``) compute on their blocks
    (``splits``, their weights and block biases ``split_params``); the
    other sharded parameters fall into gather units (``gather_units``).
    ``unit_bytes`` is each unit's gathered bytes (split layers' weights
    counted only where FSDP gathers their blocks over ``data``), and
    ``live_bytes`` / ``high_water`` count the gathered weights alive at
    once on this rank (``reset_high_water`` starts a new count).

    Gradients are reduced over ``data`` during the backward, as GSPMD
    places each reduction in the backward that computes its gradient
    (``gathered``; ``reduce_grads`` waits for them and flushes the rest).
    ``unit_grad_bytes`` is each unit's data-whole gradient bytes (its
    FSDP-sharded parameters' ``model`` blocks, whole over ``data`` until
    their reduce-scatter), and ``grad_live_bytes`` / ``grad_high_water``
    count those alive at once; a new one that would take the count past the
    largest unit's waits for the reductions in flight first."""

    def __init__(self, module: nn.Module, mesh, min_shard_dim: int = 512,
                 fsdp: bool = False):
        self.mesh = mesh
        self.min_shard_dim = min_shard_dim
        self.key = (id(mesh), min_shard_dim, bool(fsdp))
        self.n_data, self.n_model = mesh.shape
        self.specs = param_shardings(module, mesh, min_shard_dim, fsdp)
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0)
        sharded = {p: self.specs[n] for n, p in module.named_parameters() if self.specs[n]}
        self.sharded = sharded
        self.units = gather_units(module, sharded)
        modules = dict(module.named_modules())
        self._unit_modules = {u: modules[u] for u in self.units}
        self.resident = resident_units(module, self.units)
        unit_of = {p: u for u, owners in self.units.items() for _, _, p in owners}
        self.splits = {}
        for name, kind in split_layers(module, self.specs).items():
            layer = modules[name]
            first = getattr(layer, split_weights(layer)[0][0])
            self.splits[layer] = _Split(self, layer, kind, unit_of[first])
        for m in modules.values():
            for a, b in getattr(type(m), "mesh_split_pairs", ()):
                first, second = self.splits.get(getattr(m, a)), self.splits.get(getattr(m, b))
                if first and second and first.kind == "column" and second.kind == "row":
                    first.keep = True
        self.split_params = {p for sp in self.splits.values() for p in sp.params()}
        self._whole: set = set()  # units gathered whole for a kernel while they run
        self.unit_bytes = unit_gather_bytes(self.units, self.resident, split_block_bytes(
            module, self.specs, self.units, self.n_model))
        names = {p: n for n, p in module.named_parameters()}
        self._names = {p: names[p] for p in sharded}
        self.full_shapes = {}
        for p, spec in sharded.items():
            self.full_shapes[p] = tuple(p.shape)
            p.data = spec_block(p.data, spec, mesh).clone()
            p.mesh_spec = spec
        self.unit_grad_bytes = {u: sum(
            math.prod(self.full_shapes[p]) * p.element_size()
            // (self.n_model if MODEL_AXIS in sharded[p] else 1)
            for p in {id(p): p for _, _, p in owners}.values() if DATA_AXIS in sharded[p])
            for u, owners in self.units.items()}
        self._grad_cap = max(self.unit_grad_bytes.values(), default=0)
        # the replicated parameters, and each module's own, in module order
        self._replicated = [p for p in module.parameters() if p not in sharded]
        self._owned = {m: [p for p in m._parameters.values()
                           if p is not None and p not in sharded]
                       for m in modules.values()}
        self._owned = {m: ps for m, ps in self._owned.items() if ps}
        self.live_bytes = self.high_water = 0
        self.grad_live_bytes = self.grad_high_water = 0
        self.launched_in_backward = 0  # the last step's reductions launched under its backward
        self._new_step()
        self._storages = {}  # storage address -> (weak ref to the gathered weight, slot, param, axes)
        self._idle: Dict[nn.Parameter, torch.Tensor] = {}  # what a module holds between calls

    def reset_high_water(self) -> None:
        self.high_water = self.live_bytes
        self.grad_high_water = self.grad_live_bytes

    # -- gathers ----------------------------------------------------------- #

    def _gather(self, p: nn.Parameter, slot: Optional[_Slot] = None,
                packed: bool = True, axes=(DATA_AXIS, MODEL_AXIS)) -> torch.Tensor:
        """The whole weight of ``p`` (a collective over its spec's axes;
        with ``axes``, over those only), counted while it lives and, when
        ``packed``, recognised when autograd saves it."""
        with torch.no_grad():
            full = spec_gather(p.detach(), self.sharded[p], self.mesh, axes)
        nbytes = full.numel() * full.element_size()
        self.live_bytes += nbytes
        self.high_water = max(self.high_water, self.live_bytes)
        if packed and torch.is_grad_enabled() and not torch.is_inference_mode_enabled():
            ptr = full.untyped_storage().data_ptr()
            self._storages[ptr] = (weakref.ref(full), slot, p, axes)
        else:
            ptr = None
        weakref.finalize(full, self._freed, ptr, nbytes)
        return full

    def _freed(self, ptr, nbytes) -> None:
        self.live_bytes -= nbytes
        entry = self._storages.get(ptr)
        if entry is not None and entry[0]() is None:
            del self._storages[ptr]

    def _block(self, p: nn.Parameter, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """A split layer's parameter as its layer computes with it: this
        rank's ``model`` block (under FSDP gathered over ``data`` just now),
        cast to ``dtype``. Under autograd its gradient, this block's, goes
        to ``_grad_arrived``; otherwise the block is the parameter itself,
        so its cast is cached across calls (``weight_cache.derived``)."""
        recording = torch.is_grad_enabled() and p.requires_grad
        if DATA_AXIS in self.sharded[p]:
            slot = _Slot(self, p, (DATA_AXIS,)) if recording else None
            w = self._gather(p, slot, axes=(DATA_AXIS,))
            if recording:
                w = self._gather_grad(p, w, slot)
        elif recording:
            w = self._gather_grad(p, p.detach(), _Slot(self, p))
        else:
            w = p if dtype is None else derived("mesh_split", lambda t: t.to(dtype), p)
        return w if dtype is None else w.to(dtype)

    def _gather_grad(self, p: nn.Parameter, full: torch.Tensor, slot: _Slot) -> torch.Tensor:
        """``full`` as a function of ``p`` (``_GatherGrad``); a use of the
        forward keeps its node, so the backward can tell whether it runs."""
        out = _GatherGrad.apply(p, full, slot)
        if slot.counted:
            self._nodes.append((p, out.grad_fn))
        return out

    def _enter(self, unit: str) -> None:
        """The unit's whole weights in place of its blocks (its split
        layers' too where it hands them to a kernel now). A resident
        unit's stay for the whole body, so autograd keeps them as they are
        instead of gathering them again."""
        packed = unit not in self.resident
        whole = whole_weights(self._unit_modules[unit])
        if whole:
            self._whole.add(unit)
        fulls = {}
        for m, k, p in self.units[unit]:
            if p in self.split_params and not whole:
                continue
            if p not in fulls:
                if torch.is_grad_enabled() and p.requires_grad:
                    slot = _Slot(self, p)
                    fulls[p] = self._gather_grad(p, self._gather(p, slot, packed), slot)
                else:
                    fulls[p] = self._gather(p, packed=packed)
            m._parameters[k] = fulls[p]

    def _exit(self, unit: str) -> None:
        self._whole.discard(unit)
        for m, k, p in self.units[unit]:
            m._parameters[k] = self._idle.get(p, p)

    def _guard(self, p: nn.Parameter) -> torch.Tensor:
        g = p.detach().requires_grad_(p.requires_grad).as_subclass(_Block)
        g.mesh_name, g.mesh_spec = self._names[p], self.sharded[p]
        return g

    def _pack(self, t: torch.Tensor):
        """A saved tensor that is a gathered weight, or a view of one, is
        kept as ``_Packed``; anything else as it is."""
        try:
            entry = self._storages.get(t.untyped_storage().data_ptr())
        except (RuntimeError, NotImplementedError):  # no storage (sparse, fake)
            return t
        if entry is None:
            return t
        full = entry[0]()
        if full is None or full.device != t.device or full.dtype != t.dtype:
            return t
        return _Packed(entry[1], entry[2], entry[3], t)

    def _unpack(self, x):
        if not isinstance(x, _Packed):
            return x
        full = x.slot.regather() if x.slot is not None else self._gather(x.param, axes=x.axes)
        return full.as_strided(x.size, x.stride, x.offset)

    @contextlib.contextmanager
    def gathered(self):
        """Per-unit gathers and split layers while the body runs (a
        collective: every rank runs the same modules). Each split layer
        computes on its block (``_Split.forward`` stands in for its own,
        ``mesh_split`` names its record). Each unit's other sharded weights
        are gathered just before it runs and put in place of the blocks,
        and dropped when it returns; a gathered weight that autograd saves
        is kept as its parameter and gathered again when the backward
        unpacks it (the same order on every rank). Under remat the
        recomputed forward gathers as the first one did. The resident units
        (``resident_units``) are gathered once for the whole body. Between
        its unit's calls a module holds a ``_Block`` in place of the
        weight, so a read outside the unit raises. A gathered weight's
        gradient is cut to this rank's ``model`` block as it arrives.

        With several data shards, each gradient is reduced over them during
        the backward (``_advance``): a sharded parameter's once every use
        the forward made of it has sent its gradient, a replicated one's in
        buckets of about ``BUCKET_BYTES`` once autograd has accumulated each
        of theirs (``register_post_accumulate_grad_hook``). Every rank starts
        these collectives in one order, the reverse of the forward's first
        uses (a sharded parameter at its first use, a replicated one at its
        module's first call; a bucket takes its place where it fills), and
        launches one only when it and every one before it are ready, so
        the order is the same on every rank whatever order the backward's
        threads finish in. ``reduce_grads``, after the backward, launches
        what is left in that order and waits for all."""
        reducing = torch.is_grad_enabled() and self.n_data > 1
        if not self.sharded and not reducing:
            yield
            return
        self._new_step()
        self.launched_in_backward = 0
        handles = []
        try:
            if reducing:  # the replicated gradients' order and completion
                for m, params in self._owned.items():
                    handles.append(m.register_forward_pre_hook(
                        lambda _m, _a, params=params: self._record(params)))
                handles += [p.register_post_accumulate_grad_hook(self._accumulated)
                            for p in self._replicated if p.requires_grad]
            for layer, split in self.splits.items():
                layer.forward, layer.mesh_split = split.forward, split
            for unit, module in self._unit_modules.items():
                if unit in self.resident:
                    self._enter(unit)
                    continue
                for m, k, p in self.units[unit]:
                    self._idle[p] = m._parameters[k] = self._guard(p)
                handles.append(module.register_forward_pre_hook(
                    lambda _m, _a, unit=unit: self._enter(unit)))
                handles.append(module.register_forward_hook(
                    lambda _m, _a, _o, unit=unit: self._exit(unit), always_call=True))
            with torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack):
                yield
        finally:
            for h in handles:
                h.remove()
            self._idle = {}
            for unit in self.units:
                self._exit(unit)
            for layer in self.splits:
                layer.__dict__.pop("forward", None)
                layer.__dict__.pop("mesh_split", None)

    # -- the data reduction ------------------------------------------------- #

    def _new_step(self) -> None:
        self._pending: Dict[nn.Parameter, torch.Tensor] = {}
        self._uses: Dict[nn.Parameter, int] = {}
        self._arrived: Dict[nn.Parameter, int] = {}
        self._nodes: list = []  # (sharded parameter, its use's node) of the forward
        self._order: dict = {}  # parameters in the order of their first use (keys)
        self._accumulated_grads: set = set()  # replicated parameters autograd is done with
        self._reductions: Optional[list] = None
        self._next = 0
        self._in_flight: list = []

    def _used(self, p: nn.Parameter) -> None:
        """A use of sharded ``p`` in the forward (a ``_Slot``)."""
        self._uses[p] = self._uses.get(p, 0) + 1
        self._order.setdefault(p)

    def _record(self, params: list) -> None:
        """A module's first call in the forward places its own replicated
        parameters that take a gradient."""
        if torch.is_grad_enabled() and not _in_backward():
            for p in params:
                if p.requires_grad:
                    self._order.setdefault(p)

    def _accumulated(self, p: nn.Parameter) -> None:
        self._accumulated_grads.add(p)
        self._advance()

    def _plan(self) -> list:
        """The step's reductions in launch order: each sharded parameter
        alone, the replicated ones in buckets by dtype, placed where each
        fills (or at the end), over the reverse of the first uses. Made at
        the backward's first event, where the engine knows which nodes it
        will run: a use whose output does not reach the loss (FEDformer's
        Fourier blocks read the queries only, not the keys' and values'
        projections) sends no gradient and is not waited for, nor is a
        replicated parameter that gets none."""
        if _in_backward():
            will_run = torch._C._will_engine_execute_node
            for p, node in self._nodes:
                if not will_run(node):
                    self._uses[p] -= 1
            for p in self._order:
                if p not in self.sharded and \
                        not will_run(torch.autograd.graph.get_gradient_edge(p).node):
                    self._accumulated_grads.add(p)
        out, open_buckets = [], {}
        for p in reversed(self._order):
            if p in self.sharded:
                out.append(("sharded", [p]))
            elif self.n_data > 1:
                bucket = open_buckets.setdefault(p.dtype, ("bucket", []))
                bucket[1].append(p)
                if sum(q.numel() * q.element_size() for q in bucket[1]) >= BUCKET_BYTES:
                    out.append(open_buckets.pop(p.dtype))
        return out + list(open_buckets.values())

    def _ready(self, reduction) -> bool:
        kind, params = reduction
        if kind == "bucket":
            return all(p in self._accumulated_grads for p in params)
        p = params[0]
        return self._arrived.get(p, 0) == self._uses[p]

    def _advance(self) -> None:
        """Launch the reductions that are ready, in order, up to the first
        that is not."""
        if self._reductions is None:
            self._reductions = self._plan()
        while self._next < len(self._reductions) and self._ready(self._reductions[self._next]):
            self._launch(self._reductions[self._next])
            self._next += 1
            self.launched_in_backward += 1

    def _launch(self, reduction) -> None:
        kind, params = reduction
        if kind == "sharded":
            g = self._pending.pop(params[0], None)
            if g is not None:
                self._reduce_sharded(params[0], g)
            return
        grads = [p.grad for p in params if p.grad is not None]
        if grads:
            self._reduce_replicated(grads)

    def _grad_arrived(self, p: nn.Parameter, grad: torch.Tensor, counted: bool) -> None:
        """The gradient of one use of a sharded parameter (a gather or a
        split block): a whole weight's is cut to this rank's ``model`` block
        (a split layer's is that block already), then summed with the
        earlier ones of the step; its reduction is launched when it is
        complete (``_advance``)."""
        spec = self.sharded[p]
        if MODEL_AXIS in spec:
            d = spec.index(MODEL_AXIS)
            size = self.full_shapes[p][d] // self.n_model
            if grad.shape[d] != size:
                grad = grad.narrow(d, self.mesh.get_local_rank(MODEL_AXIS) * size, size).clone()
        have = self._pending.get(p)
        if have is None:
            if DATA_AXIS in spec:
                self._hold(grad.numel() * grad.element_size())
            self._pending[p] = grad
        else:
            self._pending[p] = have + grad
        if counted:
            self._arrived[p] = self._arrived.get(p, 0) + 1
        self._advance()

    def _hold(self, nbytes: int) -> None:
        """Count a new data-whole gradient; first wait for the reductions in
        flight where it would take the count past the largest unit's."""
        if self._in_flight and self.grad_live_bytes + nbytes > self._grad_cap:
            self._wait()
        self.grad_live_bytes += nbytes
        self.grad_high_water = max(self.grad_high_water, self.grad_live_bytes)

    def _reduce_sharded(self, p: nn.Parameter, g: torch.Tensor) -> None:
        """The mean over the data shards of ``p``'s ``model`` block: a
        reduce-scatter along the dim FSDP split over ``data``, else an
        all-reduce of the block (asynchronous), accumulated into ``.grad``
        when it is waited for."""
        spec = self.sharded[p]
        nbytes = g.numel() * g.element_size() if DATA_AXIS in spec else 0
        if self.n_data == 1:
            self._write(p, g)
            return
        group = self.mesh.get_group(DATA_AXIS)
        if DATA_AXIS in spec:
            d = spec.index(DATA_AXIS)
            whole = g.movedim(d, 0).contiguous()
            out = whole.new_empty((whole.shape[0] // self.n_data,) + whole.shape[1:])
            work = dist.reduce_scatter_tensor(out, whole, group=group, async_op=True)
            self._in_flight.append((work, lambda: self._write(p, out.movedim(0, d) / self.n_data),
                                    nbytes, whole))
        else:
            g = g.contiguous()
            work = dist.all_reduce(g, group=group, async_op=True)
            self._in_flight.append((work, lambda: self._write(p, g / self.n_data), nbytes, g))

    @staticmethod
    def _write(p: nn.Parameter, g: torch.Tensor) -> None:
        g = g.contiguous()
        p.grad = g if p.grad is None else p.grad + g

    def _reduce_replicated(self, grads: list) -> None:
        """The data-shard mean of replicated gradients, in one flat
        all-reduce (asynchronous), copied back when it is waited for."""
        flat = torch.cat([g.reshape(-1) for g in grads])
        work = dist.all_reduce(flat, group=self.mesh.get_group(DATA_AXIS), async_op=True)

        def finish():
            flat.div_(self.n_data)
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()

        self._in_flight.append((work, finish, 0, flat))

    def _wait(self) -> None:
        for work, finish, nbytes, _ in self._in_flight:
            work.wait()
            finish()
            self.grad_live_bytes -= nbytes
        self._in_flight = []

    def reduce_grads(self) -> None:
        """After the backward: launch the reductions the backward did not
        (in the step's order; then any sharded gradient left, in parameter
        order, and the replicated ones outside a bucket, one flat all-reduce
        per dtype), and wait for all. Each sharded parameter's ``.grad``
        accumulates the mean over the data shards of its ``model`` block,
        each replicated one's ``.grad`` becomes the mean. A gradient no
        rank's backward reached (the same on every rank) is left out."""
        if self._reductions is None:
            self._reductions = self._plan()
        for reduction in self._reductions[self._next:]:
            self._launch(reduction)
        for p in self.sharded:  # the same order on every rank
            g = self._pending.pop(p, None)
            if g is not None:
                self._reduce_sharded(p, g)
        if self.n_data > 1:
            bucketed = {p for kind, ps in self._reductions if kind == "bucket" for p in ps}
            by_dtype: Dict[torch.dtype, list] = {}
            for p in self._replicated:
                if p.grad is not None and p not in bucketed:
                    by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
            for grads in by_dtype.values():
                self._reduce_replicated(grads)
        self._wait()
        self._new_step()

    def full_state_dict(self, module: nn.Module) -> Dict[str, torch.Tensor]:
        """``module.state_dict()`` with every sharded parameter gathered
        whole (a collective: every rank calls it), on the CPU."""
        names = {p: n for n, p in module.named_parameters()}
        whole = {names[p]: spec_gather(p.detach(), spec, self.mesh)
                 for p, spec in self.sharded.items()}
        return {k: whole.get(k, v).detach().cpu() for k, v in module.state_dict().items()}

    def block_state_dict(self, module: nn.Module, state: dict) -> dict:
        """A whole ``state_dict`` cut to this rank's blocks (for
        ``load_state_dict``)."""
        specs = {n: self.sharded[p] for n, p in module.named_parameters() if p in self.sharded}
        return {k: spec_block(v, specs[k], self.mesh).clone() if k in specs else v
                for k, v in state.items()}


def shard_params(module: nn.Module, mesh, min_shard_dim: int = 512,
                 fsdp: bool = False) -> MeshParams:
    """Lay ``module``'s parameters out on ``mesh`` by the structural rule
    (the JAX package's ``shard_params``): its ``MeshParams``."""
    return MeshParams(module, mesh, min_shard_dim, fsdp)


def global_norm(params, norms, mesh) -> torch.Tensor:
    """The norm of the whole gradient from each local gradient's norm:
    the replicated parameters' squares once, each sharded parameter's
    squares summed over the ranks that hold its distinct blocks (the axes
    its ``mesh_spec`` names)."""
    if not any(hasattr(p, "mesh_spec") for p in params):
        return torch.linalg.vector_norm(torch.stack(norms))
    sq = torch.stack(norms) ** 2
    classes = {}
    for p, s in zip(params, sq):
        axes = frozenset(a for a in getattr(p, "mesh_spec", ()) if a is not None)
        classes.setdefault(axes, []).append(s)
    total = torch.zeros((), dtype=sq.dtype, device=sq.device)
    for axes in sorted(classes, key=sorted):  # the same order on every rank
        part = torch.stack(classes[axes]).sum()
        if axes == {DATA_AXIS, MODEL_AXIS}:
            dist.all_reduce(part)  # the mesh is the whole process group
        elif axes:
            dist.all_reduce(part, group=mesh.get_group(next(iter(axes))))
        total = total + part
    return torch.sqrt(total)
