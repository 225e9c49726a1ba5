"""FEDformer's Fourier blocks (counterpart of
``routeformer_tpu/models/layers/fourier.py``): ``get_frequency_modes``,
``FourierBlock`` and ``FourierCrossAttention``.

The selected rFFT modes are drawn when a block is built. The JAX package
draws them from numpy's global generator and keeps them as a Python list;
here they come from an explicit ``np.random.RandomState`` (the same
``shuffle``, so a state seeded as the global one was draws the same
modes) and are a persistent buffer (``index``, ``index_q``, ``index_kv``),
so that checkpoints and serving bundles keep them. They are not flax
state: ``port_only_buffers`` tells ``convert.load_flax_params`` to leave
them. Complex weights are real/imag f32 parameters.
"""

import numpy as np
import torch
import torch.nn as nn


def get_frequency_modes(seq_len: int, modes: int, mode_select_method: str,
                        rng: np.random.RandomState) -> list:
    """Sorted rFFT mode indices: ``min(modes, seq_len // 2)`` of them, a
    random choice (``rng.shuffle``) or the lowest."""
    modes = min(modes, seq_len // 2)
    if mode_select_method == "random":
        index = list(range(0, seq_len // 2))
        rng.shuffle(index)
        index = index[:modes]
    else:
        index = list(range(0, modes))
    index.sort()
    return index


def activate(xqk: torch.Tensor, activation: str) -> torch.Tensor:
    """The cross blocks' activation of complex scores."""
    if activation == "tanh":
        return torch.complex(torch.tanh(xqk.real), torch.tanh(xqk.imag))
    if activation == "softmax":
        return torch.softmax(xqk.abs(), dim=-1).to(torch.complex64)
    raise ValueError(f"{activation} activation is not implemented")


def _complex_weight(shape, scale):
    return (nn.Parameter(scale * torch.rand(shape)), nn.Parameter(scale * torch.rand(shape)))


class FourierBlock(nn.Module):
    """Frequency-domain operator on the selected modes; returns
    head-major ``(B, H, E, L)``."""

    port_only_buffers = ("index",)

    def __init__(self, in_channels: int, out_channels: int, seq_len: int, modes: int,
                 mode_select_method: str, n_heads: int, rng: np.random.RandomState):
        super().__init__()
        index = get_frequency_modes(seq_len, modes, mode_select_method, rng)
        self.register_buffer("index", torch.tensor(index, dtype=torch.long))
        self.w_real, self.w_imag = _complex_weight(
            (n_heads, in_channels // n_heads, out_channels // n_heads, len(index)),
            1.0 / (in_channels * out_channels))

    def forward(self, q, k, v, attn_mask=None):
        b, l, h, e = q.shape
        x_ft = torch.fft.rfft(q.permute(0, 2, 3, 1).float(), dim=-1)  # (B, H, E, L//2+1)
        w = torch.complex(self.w_real, self.w_imag)
        out_sel = torch.einsum("bhim,hiom->bhom", x_ft[..., self.index], w)
        out_ft = out_sel.new_zeros(b, h, out_sel.shape[2], l // 2 + 1)
        out_ft[..., self.index] = out_sel
        return torch.fft.irfft(out_ft, n=l, dim=-1), None


class FourierCrossAttention(nn.Module):
    """Frequency-domain cross attention on the selected modes; returns
    ``(B, H, E, L)``."""

    port_only_buffers = ("index_q", "index_kv")

    def __init__(self, in_channels: int, out_channels: int, seq_len_q: int, seq_len_kv: int,
                 modes: int, mode_select_method: str, n_heads: int,
                 rng: np.random.RandomState, activation: str = "tanh"):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.activation = activation
        index_q = get_frequency_modes(seq_len_q, modes, mode_select_method, rng)
        index_kv = get_frequency_modes(seq_len_kv, modes, mode_select_method, rng)
        self.register_buffer("index_q", torch.tensor(index_q, dtype=torch.long))
        self.register_buffer("index_kv", torch.tensor(index_kv, dtype=torch.long))
        self.w_real, self.w_imag = _complex_weight(
            (n_heads, in_channels // n_heads, out_channels // n_heads, len(index_q)),
            1.0 / (in_channels * out_channels))

    def forward(self, q, k, v, attn_mask=None):
        b, l, h, e = q.shape
        xq_ft = torch.fft.rfft(q.permute(0, 2, 3, 1).float(), dim=-1)[..., self.index_q]
        xk_ft = torch.fft.rfft(k.permute(0, 2, 3, 1).float(), dim=-1)[..., self.index_kv]
        xqk = activate(torch.einsum("bhex,bhey->bhxy", xq_ft, xk_ft), self.activation)
        xqkv = torch.einsum("bhxy,bhey->bhex", xqk, xk_ft)
        w = torch.complex(self.w_real, self.w_imag)
        xqkvw = torch.einsum("bhex,heox->bhox", xqkv, w)
        out_ft = xqkvw.new_zeros(b, h, e, l // 2 + 1)
        out_ft[..., self.index_q] = xqkvw
        out = torch.fft.irfft(out_ft / self.in_channels / self.out_channels, n=l, dim=-1)
        return out, None
