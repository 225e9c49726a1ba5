"""PatchTST GPS backbone (counterpart of
``routeformer_tpu/models/gps_backbone/patchtst.py``): reversible instance
normalisation around channel-independent patching, a shared encoder with
residual attention scores and BatchNorm sublayers, a flatten head to
``pred_len`` per channel, then ``Linear(c_in -> c_out)``.

Two details hold the port to the JAX package's numbers:

- ``BatchNorm`` is flax's ``nnx.BatchNorm(momentum=0.9)``, not
  ``nn.BatchNorm1d``: training normalises with the biased batch variance
  (``E[x²] - E[x]²``, flax's fast variance) and the running statistics keep
  that biased variance, ``running = 0.9 running + 0.1 batch``. Eval uses the
  running statistics.
- The positional encoding ``W_pos`` is drawn at init in the JAX package, so
  it is a parameter carried by ``load_flax_params``, not a table.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from routeformer_torch.models.gps_backbone.config import PatchTSTBackboneConfig
from routeformer_torch.models.gps_backbone.linear import series_decomp
from routeformer_torch.models.layers.encdec import feature_dropout


class RevIN(nn.Module):
    """Reversible instance normalisation over time; ``norm`` returns the
    statistics that ``denorm`` takes back."""

    def __init__(self, num_features: int, eps: float = 1e-5, affine: bool = True,
                 subtract_last: bool = False):
        super().__init__()
        self.eps = eps
        self.affine = affine
        self.subtract_last = subtract_last
        if affine:
            self.affine_weight = nn.Parameter(torch.ones(num_features))
            self.affine_bias = nn.Parameter(torch.zeros(num_features))

    def norm(self, x: torch.Tensor):
        """``(B, L, C) -> (normalised, stats)``."""
        loc = x[:, -1:] if self.subtract_last else x.mean(dim=1, keepdim=True).detach()
        stdev = torch.sqrt(x.var(dim=1, keepdim=True, unbiased=False) + self.eps).detach()
        out = (x - loc) / stdev
        if self.affine:
            out = out * self.affine_weight + self.affine_bias
        return out, (loc, stdev)

    def denorm(self, x: torch.Tensor, stats) -> torch.Tensor:
        loc, stdev = stats
        if self.affine:
            x = (x - self.affine_bias) / (self.affine_weight + self.eps * self.eps)
        return x * stdev + loc


def positional_encoding(q_len: int, d_model: int,
                        generator: torch.Generator = None) -> torch.Tensor:
    """The positional encoding's initial value, PatchTST's default ``zeros``
    kind: uniform(-0.02, 0.02)."""
    return torch.rand(q_len, d_model, generator=generator) * 0.04 - 0.02


class BatchNorm(nn.Module):
    """flax's ``nnx.BatchNorm`` over the feature dimension ``axis`` (the
    last by default; see the module docstring): ``weight``/``bias`` and the ``running_mean``/``running_var``
    buffers that ``load_flax_params`` fills from ``scale``/``bias``/
    ``mean``/``var``."""

    def __init__(self, num_features: int, momentum: float = 0.9, eps: float = 1e-5,
                 axis: int = -1):
        super().__init__()
        self.axis = axis  # the feature dimension (1 for NCHW maps)
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        # the data shards' process group on a mesh with several (set by the
        # trainer): the batch statistics are then the global batch's
        self.data_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axis = self.axis % x.ndim
        if self.training:
            dims = tuple(d for d in range(x.ndim) if d != axis)
            if self.data_group is None:
                mean = x.mean(dim=dims)
                var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
            else:
                from routeformer_torch.parallel.mesh import global_moments

                mean, var, _ = global_moments(x, dims, self.data_group)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1.0 - m) * mean.detach())
                self.running_var.mul_(m).add_((1.0 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        shape = [-1] + [1] * (x.ndim - 1 - axis)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * scale.reshape(shape) + self.bias.reshape(shape)


class _BatchNormSublayer(nn.Module):
    """PatchTST's BatchNorm over the tokens' channels (flax path ``bn``)."""

    def __init__(self, d_model: int):
        super().__init__()
        self.bn = BatchNorm(d_model, momentum=0.9, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(x)


class TSTEncoderLayer(nn.Module):
    """Post-norm encoder layer with BatchNorm sublayers and an exact-gelu
    FFN, whose attention adds the previous layer's pre-softmax scores
    (residual attention) and returns its own."""

    mesh_split_pairs = (("ff1", "ff2"),)  # ff1 -> gelu -> dropout -> ff2

    def __init__(self, d_model: int, n_heads: int, d_ff: int, dropout: float = 0.0):
        super().__init__()
        d_k = d_model // n_heads
        self.n_heads, self.d_k = n_heads, d_k
        self.scale = d_k ** -0.5
        self.W_Q = nn.Linear(d_model, d_k * n_heads)
        self.W_K = nn.Linear(d_model, d_k * n_heads)
        self.W_V = nn.Linear(d_model, d_k * n_heads)
        self.to_out = nn.Linear(d_k * n_heads, d_model)
        self.dropout_attn = nn.Dropout(dropout)
        self.dropout_ffn = nn.Dropout(dropout)
        self.proj_dropout = nn.Dropout(dropout)
        self.norm_attn = _BatchNormSublayer(d_model)
        self.norm_ffn = _BatchNormSublayer(d_model)
        self.ff1 = nn.Linear(d_model, d_ff)
        self.ff2 = nn.Linear(d_ff, d_model)

    def _attention(self, src, prev):
        b, l, _ = src.shape
        h, dk = self.n_heads, self.d_k
        q = self.W_Q(src).reshape(b, l, h, dk).transpose(1, 2)
        k = self.W_K(src).reshape(b, l, h, dk).transpose(1, 2)
        v = self.W_V(src).reshape(b, l, h, dk).transpose(1, 2)
        scores = torch.einsum("bhld,bhsd->bhls", q, k) * self.scale
        if prev is not None:
            scores = scores + prev
        out = torch.einsum("bhls,bhsd->bhld", torch.softmax(scores, dim=-1), v)
        out = self.proj_dropout(self.to_out(out.transpose(1, 2).reshape(b, l, h * dk)))
        return out, scores

    def forward(self, src, prev=None):
        src2, scores = self._attention(src, prev)
        src = self.norm_attn(src + self.dropout_attn(src2))
        src2 = self.ff2(feature_dropout(self.dropout_ffn, F.gelu(self.ff1(src)), self.ff1))
        return self.norm_ffn(src + self.dropout_ffn(src2)), scores


class PatchTSTBackboneCore(nn.Module):
    """RevIN, patching, the channel-independent encoder and the flatten
    head: ``(B, C, L) -> (B, C, pred_len)``."""

    def __init__(self, cfg: PatchTSTBackboneConfig, c_in: int):
        super().__init__()
        self.patch_len, self.stride = cfg.patch_len, cfg.stride
        self.padding_patch = cfg.padding_patch
        self.revin = cfg.revin
        self.individual = cfg.individual
        patch_num = int((cfg.seq_len - cfg.patch_len) / cfg.stride + 1)
        if cfg.padding_patch == "end":
            patch_num += 1
        self.patch_num = patch_num
        if self.revin:
            self.revin_layer = RevIN(c_in, affine=cfg.affine, subtract_last=cfg.subtract_last)
        self.W_P = nn.Linear(cfg.patch_len, cfg.d_model)
        self.W_pos = nn.Parameter(positional_encoding(patch_num, cfg.d_model))
        self.enc_dropout = nn.Dropout(cfg.dropout)
        self.layers = nn.ModuleList(
            [TSTEncoderLayer(cfg.d_model, cfg.n_heads, cfg.d_ff, dropout=cfg.dropout)
             for _ in range(cfg.e_layers)])
        head_nf = cfg.d_model * patch_num
        if self.individual:
            self.head_weight = nn.Parameter(
                torch.randn(c_in, head_nf, cfg.pred_len) / math.sqrt(head_nf))
            self.head_bias = nn.Parameter(torch.zeros(c_in, cfg.pred_len))
        else:
            self.head = nn.Linear(head_nf, cfg.pred_len)
        self.head_dropout = nn.Dropout(cfg.head_dropout)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        b, c, _ = z.shape
        stats = None
        if self.revin:
            zt, stats = self.revin_layer.norm(z.transpose(1, 2))
            z = zt.transpose(1, 2)
        if self.padding_patch == "end":
            z = torch.cat([z, z[..., -1:].expand(-1, -1, self.stride)], dim=-1)
        patches = z.unfold(-1, self.patch_len, self.stride)[:, :, : self.patch_num]
        u = self.W_P(patches).reshape(b * c, self.patch_num, -1)
        out = self.enc_dropout(u + self.W_pos)
        scores = None
        for layer in self.layers:
            out, scores = layer(out, prev=scores)
        flat = out.reshape(b, c, self.patch_num, -1).transpose(2, 3).reshape(b, c, -1)
        if self.individual:
            pred = torch.einsum("bcf,cfp->bcp", flat, self.head_weight) + self.head_bias[None]
        else:
            pred = self.head(flat)
        pred = self.head_dropout(pred)
        if self.revin:
            pred = self.revin_layer.denorm(pred.transpose(1, 2), stats).transpose(1, 2)
        return pred


class PatchTST(nn.Module):
    def __init__(self, configs: PatchTSTBackboneConfig):
        super().__init__()
        self.c_out = configs.c_out
        self.pred_len = configs.pred_len
        self.decomposition = configs.get("decomposition", False)
        self.kernel_size = configs.get("kernel_size", 25)
        c_in = configs.enc_in
        if self.decomposition:
            self.model_trend = PatchTSTBackboneCore(configs, c_in)
            self.model_res = PatchTSTBackboneCore(configs, c_in)
        else:
            self.model = PatchTSTBackboneCore(configs, c_in)
        self.projection = nn.Linear(c_in, self.c_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, seq_len, C) -> (B, pred_len, c_out)``."""
        if self.decomposition:
            res, trend = series_decomp(x, self.kernel_size)
            out = (self.model_res(res.transpose(1, 2))
                   + self.model_trend(trend.transpose(1, 2))).transpose(1, 2)
        else:
            out = self.model(x.transpose(1, 2)).transpose(1, 2)
        return self.projection(out)[:, : self.pred_len]
