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

The arithmetic is real, so that ``torch.export`` takes it (``serve.
export_model``): a complex tensor is a real one whose leading dim holds its
real and imaginary parts; a complex einsum is one real einsum of the left
operand against the right one's block form ``((br, bi), (-bi, br))``,
contracted over the parts as over the equation's own labels (``blocks``,
``complex_einsum``); and the rFFT at the kept modes and the inverse rFFT
of a spectrum that holds only those modes are products against cosine and
sine tables built from the same mode indices (``rdft``, ``irdft``; f64
tables cast to f32, built once and kept). A weight's block form is kept
from call to call while the weight is unchanged, out of autograd
(``weight_cache.derived``).
"""

import math

import numpy as np
import torch
import torch.nn as nn

from routeformer_torch.ops import weight_cache


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


def _angles(n: int, modes: torch.Tensor) -> torch.Tensor:
    """``(n, M)`` f64 angles ``2 pi m t / n`` (``m t`` reduced mod ``n``
    first, so that each angle is exact to f64)."""
    t = torch.arange(n, device=modes.device, dtype=torch.int64)
    return (t[:, None] * modes[None, :].long() % n).double() * (2.0 * math.pi / n)


def _build_tables(n: int, modes: torch.Tensor, dtype):
    """``rdft``'s ``(n, 2M)`` table (cosines, negated sines) and
    ``irdft``'s ``(2M, n)`` one (irfft's weights: 1/n at the DC and Nyquist
    modes, whose sines it drops, else 2/n), built in f64."""
    a = _angles(n, modes)
    m = modes.long()
    edge = (m == 0) | (2 * m == n)
    weight = torch.where(edge, 1.0, 2.0).double() / n
    fwd = torch.cat((torch.cos(a), -torch.sin(a)), dim=1)
    inv = torch.cat((torch.cos(a) * weight, torch.where(edge, 0.0, -torch.sin(a) * weight)),
                    dim=1)
    return fwd.to(dtype), inv.t().contiguous().to(dtype)


_KEPT = {}  # key -> a constant table, kept for the process


def kept(key, build):
    """``build()``, built once for the process under ``key`` (a normal
    tensor, usable inside and outside autograd and inference mode); while
    ``torch.export`` traces, built in the graph."""
    if torch.compiler.is_exporting():
        return build()
    if key not in _KEPT:
        with torch.inference_mode(False), torch.no_grad():
            _KEPT[key] = build()
    return _KEPT[key]


def _tables(n: int, modes, dtype, device):
    """The tables at ``modes``: an index tensor (kept while it lives, as
    ``weight_cache.derived`` keeps a weight) or ``M``, the lowest ``M``
    modes (``kept``)."""
    if not isinstance(modes, int):
        return weight_cache.derived(("dft_tables", n, dtype),
                                    lambda idx: _build_tables(n, idx, dtype), modes)
    return kept(("dft_tables", n, modes, dtype, device),
                lambda: _build_tables(n, torch.arange(modes, device=device), dtype))


def rdft(x: torch.Tensor, modes) -> torch.Tensor:
    """``torch.fft.rfft(x)[..., modes]`` over the last dim, as a
    ``(2, ..., M)`` real tensor (real, imaginary); ``modes`` an index
    tensor or ``M`` (the lowest ``M`` modes)."""
    fwd, _ = _tables(x.shape[-1], modes, x.dtype, x.device)
    return (x @ fwd).unflatten(-1, (2, -1)).movedim(-2, 0)


def irdft(z: torch.Tensor, modes, n: int) -> torch.Tensor:
    """``torch.fft.irfft(X, n)`` of a spectrum ``X`` (``z``, ``(2, ...,
    M)`` as ``rdft`` gives it) at ``modes`` and 0 elsewhere. As irfft, the
    imaginary part of the DC and Nyquist terms is ignored."""
    _, inv = _tables(n, modes, z.dtype, z.device)
    return z.movedim(0, -2).flatten(-2) @ inv


def blocks(z: torch.Tensor) -> torch.Tensor:
    """The ``(2, 2, ...)`` block form ``((zr, zi), (-zi, zr))`` of a
    complex ``z`` (``(2, ...)``): row ``p`` is what a left operand's part
    ``p`` multiplies in a complex product."""
    return torch.cat((z, -z[1:], z[:1])).unflatten(0, (2, 2))


def complex_einsum(eq: str, a: torch.Tensor, b_blocks: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, A, B)`` of complex ``A`` (``(2, ...)``) and ``B``
    (given as ``blocks(B)``): one real einsum, the parts (label ``p``)
    contracted with the equation's own labels, ``(2, ...)`` out."""
    ins, out = eq.split("->")
    lhs, rhs = ins.split(",")
    assert not {"p", "r"} & set(eq), eq
    return torch.einsum(f"p{lhs},pr{rhs}->r{out}", a, b_blocks)


def activate(xqk: torch.Tensor, activation: str) -> torch.Tensor:
    """The cross blocks' activation of complex scores (``(2, ...)``)."""
    if activation == "tanh":
        return torch.tanh(xqk)
    if activation == "softmax":
        return torch.stack((torch.softmax(torch.hypot(xqk[0], xqk[1]), dim=-1),
                            torch.zeros_like(xqk[0])))
    raise ValueError(f"{activation} activation is not implemented")


def weight_blocks(w_real: torch.Tensor, w_imag: torch.Tensor) -> torch.Tensor:
    """``blocks`` of a complex weight, kept while the weight is unchanged
    (``weight_cache.derived``; afresh while autograd records)."""
    return weight_cache.derived(
        "complex_blocks", lambda r, i: torch.stack((r, i, -i, r)).unflatten(0, (2, 2)),
        w_real, w_imag)


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
        x_ft = rdft(q.permute(0, 2, 3, 1).float(), self.index)  # (2, B, H, E, M)
        out = complex_einsum("bhim,hiom->bhom", x_ft, weight_blocks(self.w_real, self.w_imag))
        return irdft(out, self.index, l), None


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
        xq_ft = rdft(q.permute(0, 2, 3, 1).float(), self.index_q)
        xk_blocks = blocks(rdft(k.permute(0, 2, 3, 1).float(), self.index_kv))
        xqk = activate(complex_einsum("bhex,bhey->bhxy", xq_ft, xk_blocks), self.activation)
        xqkv = complex_einsum("bhxy,bhey->bhex", xqk, xk_blocks)
        out = complex_einsum("bhex,heox->bhox", xqkv, weight_blocks(self.w_real, self.w_imag))
        return irdft(out / self.in_channels / self.out_channels, self.index_q, l), None
