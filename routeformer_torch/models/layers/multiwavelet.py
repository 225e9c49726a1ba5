"""FEDformer's multiwavelet layers (counterpart of
``routeformer_tpu/models/layers/multiwavelet.py``): ``SparseKernelFT1d``,
``MWT_CZ1d``, ``MultiWaveletTransform``, ``FourierCrossAttentionW`` and
``MultiWaveletCross``.

The Legendre and Chebyshev filter banks are built in float64 numpy by the
JAX package's construction (orthonormal shifted-Legendre bases evaluated
by their recurrence, Gauss quadrature, the G rows an SVD completion of the
H rows; Gauss-Chebyshev quadrature for the Chebyshev base), copied here
line for line so the arrays are the same bits. A block keeps them as
non-persistent f32 buffers: constants, not parameters, rebuilt with the
module. Complex Fourier weights are real/imag f32 parameters; the spectral
products are real, as in ``fourier.py`` (the DFT at the lowest modes
against cosine and sine tables, a complex product one real product), so
that ``torch.export`` takes them. A ``SparseKernelFT1d`` takes every level
of its block in one call and lays its weight out once for all of them,
mode first with the real and imaginary outputs side by side (once for
every call while the weight is unchanged, out of autograd:
``weight_cache.derived``): a level is one batched product over its modes
of the stacked real and imaginary inputs, whose four real products the
inverse DFT's table combines.
"""

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn as nn

from routeformer_torch.models.layers.fourier import (_tables, activate, blocks, complex_einsum,
                                                     irdft, kept, rdft)
from routeformer_torch.ops import weight_cache

Poly = np.polynomial.Polynomial


def _chebyshev_phi(i: int) -> Poly:
    """Chebyshev-base phi_i, normalized as the reference does
    (2/sqrt(pi) T_i(2x-1); sqrt(2/pi) for i=0)."""
    t_coeffs = np.polynomial.chebyshev.cheb2poly(np.eye(i + 1)[i])
    p = Poly(t_coeffs)(Poly([-1.0, 2.0]))
    scale = math.sqrt(2 / math.pi) if i == 0 else 2 / math.sqrt(math.pi)
    return scale * p


def _clean(arr: np.ndarray, tol: float = 1e-8) -> np.ndarray:
    arr = np.asarray(arr, dtype=np.float64)
    arr[np.abs(arr) < tol] = 0.0
    return arr


def _phi_eval(i: int, x: np.ndarray) -> np.ndarray:
    """Orthonormal shifted Legendre phi_i(x) = sqrt(2i+1) P_i(2x-1),
    evaluated via the stable Legendre recurrence (Clenshaw), NOT the
    ill-conditioned power basis."""
    c = np.zeros(i + 1)
    c[i] = 1.0
    return math.sqrt(2 * i + 1) * np.polynomial.legendre.legval(2 * x - 1, c)


@lru_cache(maxsize=None)
def legendre_filters(k: int):
    """H0, H1, G0, G1, PHI0, PHI1 for the Legendre base.

    Numerically-sound construction (the reference's monomial-basis
    Gram-Schmidt — MultiWaveletCorrelation.py:452-523 — loses orthogonality
    badly at its own default k=8):

    - H filters from the two-scale relation, computed by Gauss-Legendre
      quadrature (exact for these polynomial degrees) with stable
      recurrence evaluation;
    - G filters as an orthonormal completion of the H rows in R^{2k}
      (any such completion is a valid orthonormal multiwavelet bank: the
      wavelets span V1 ⊖ V0). The completion is deterministic (SVD with a
      fixed sign convention).
    """
    n_quad = 2 * k + 2
    nodes, weights = np.polynomial.legendre.leggauss(n_quad)
    x = (nodes + 1) / 2  # map to [0, 1]
    w = weights / 2

    H0 = np.zeros((k, k))
    H1 = np.zeros((k, k))
    s2 = math.sqrt(2)
    for i in range(k):
        pi_half = _phi_eval(i, x / 2)
        pi_hshift = _phi_eval(i, (x + 1) / 2)
        for j in range(k):
            pj = _phi_eval(j, x)
            H0[i, j] = float((w * pi_half * pj).sum()) / s2
            H1[i, j] = float((w * pi_hshift * pj).sum()) / s2

    # Orthonormal completion: rows of [H0 H1] are orthonormal; the G rows
    # span the orthogonal complement.
    m_h = np.concatenate([H0, H1], axis=1)  # (k, 2k)
    _, _, vt = np.linalg.svd(m_h, full_matrices=True)
    comp = vt[k:]  # (k, 2k), orthonormal, orthogonal to H rows
    # Fix signs deterministically: make the largest-|entry| of each row +.
    signs = np.sign(comp[np.arange(k), np.abs(comp).argmax(axis=1)])
    comp = comp * signs[:, None]
    G0 = comp[:, :k]
    G1 = comp[:, k:]

    return (
        _clean(H0), _clean(H1), _clean(G0), _clean(G1),
        np.eye(k), np.eye(k),
    )


@lru_cache(maxsize=None)
def chebyshev_filters(k: int):
    """Chebyshev-base filters via Gauss-Chebyshev quadrature (reference
    semantics — the quadrature there is applied to unweighted integrals)."""
    k_use = 2 * k
    # roots of T_{k_use}(2x - 1)
    theta = (2 * np.arange(1, k_use + 1) - 1) * math.pi / (2 * k_use)
    y = np.cos(theta)
    x_m = (y + 1) / 2
    wm = math.pi / k_use / 2

    phi = [_chebyshev_phi(i) for i in range(k)]
    phi2 = [math.sqrt(2) * p(Poly([0.0, 2.0])) for p in phi]

    def on_interval(p, lo, hi):
        def f(x):
            x = np.asarray(x)
            vals = p(x)
            return np.where((x < lo) | (x > hi), 0.0, vals)

        return f

    phi_f = [on_interval(p, 0.0, 1.0) for p in phi]
    phi2_f = [on_interval(p, 0.0, 0.5) for p in phi2]

    psi1_f, psi2_f = [], []
    psi1_p, psi2_p = [], []
    for ki in range(k):
        p1 = phi2[ki]
        p2 = Poly([0.0])
        for i in range(k):
            proj = float((wm * phi_f[i](x_m) * phi2_f[ki](x_m)).sum())
            p1 = p1 - proj * phi[i]
            p2 = p2 - proj * phi[i]
        for j in range(ki):
            proj = float((wm * psi1_f[j](x_m) * phi2_f[ki](x_m)).sum())
            p1 = p1 - proj * psi1_p[j]
            p2 = p2 - proj * psi2_p[j]
        f1 = on_interval(p1, 0.0, 0.5)
        f2 = on_interval(p2, 0.5 + 1e-16, 1.0)
        norm = math.sqrt(
            float((wm * f1(x_m) ** 2).sum()) + float((wm * f2(x_m) ** 2).sum())
        )
        psi1_p.append(p1 / norm)
        psi2_p.append(p2 / norm)
        psi1_f.append(on_interval(p1 / norm, 0.0, 0.5 + 1e-16))
        psi2_f.append(on_interval(p2 / norm, 0.5 + 1e-16, 1.0))

    def psi(i, x):
        x = np.asarray(x)
        return np.where(x <= 0.5, psi1_f[i](x), psi2_f[i](x))

    H0 = np.zeros((k, k))
    H1 = np.zeros((k, k))
    G0 = np.zeros((k, k))
    G1 = np.zeros((k, k))
    PHI0 = np.zeros((k, k))
    PHI1 = np.zeros((k, k))
    s2 = math.sqrt(2)
    for i in range(k):
        for j in range(k):
            H0[i, j] = (wm * phi_f[i](x_m / 2) * phi_f[j](x_m)).sum() / s2
            G0[i, j] = (wm * psi(i, x_m / 2) * phi_f[j](x_m)).sum() / s2
            H1[i, j] = (wm * phi_f[i]((x_m + 1) / 2) * phi_f[j](x_m)).sum() / s2
            G1[i, j] = (wm * psi(i, (x_m + 1) / 2) * phi_f[j](x_m)).sum() / s2
            PHI0[i, j] = 2 * (wm * phi_f[i](2 * x_m) * phi_f[j](2 * x_m)).sum()
            PHI1[i, j] = 2 * (
                wm * phi_f[i](2 * x_m - 1) * phi_f[j](2 * x_m - 1)
            ).sum()

    return (
        _clean(H0), _clean(H1), _clean(G0), _clean(G1),
        _clean(PHI0), _clean(PHI1),
    )


def get_filter(base: str, k: int):
    """Filter bank dispatch (reference MultiWaveletCorrelation.py:585-651)."""
    if base == "legendre":
        return legendre_filters(k)
    if base == "chebyshev":
        return chebyshev_filters(k)
    raise ValueError("Base not supported")


def _reconstruction_filters(base: str, k: int):
    H0, H1, G0, G1, PHI0, PHI1 = get_filter(base, k)
    H0r = _clean(H0 @ PHI0)
    G0r = _clean(G0 @ PHI0)
    H1r = _clean(H1 @ PHI1)
    G1r = _clean(G1 @ PHI1)
    ec_s = np.concatenate((H0.T, H1.T), axis=0)
    ec_d = np.concatenate((G0.T, G1.T), axis=0)
    rc_e = np.concatenate((H0r, G0r), axis=0)
    rc_o = np.concatenate((H1r, G1r), axis=0)
    return ec_s, ec_d, rc_e, rc_o


def _wavelet_transform(x, ec_d, ec_s):
    """Even/odd split and the analysis matmuls: ``(d, s)``."""
    xa = torch.cat([x[:, ::2], x[:, 1::2]], dim=-1)
    return xa @ ec_d, xa @ ec_s


def _even_odd(x, rc_e, rc_o, k):
    """Synthesis and interleave: ``(B, N, c, 2k) -> (B, 2N, c, k)``."""
    b, n, c, _ = x.shape
    return torch.stack([x @ rc_e, x @ rc_o], dim=2).reshape(b, n * 2, c, k)


def _extend(x, n):
    """Wrap ``x`` (B, n, ...) around to the next power of two rows."""
    nl = 2 ** math.ceil(math.log2(n))
    return torch.cat([x, x[:, : nl - n]], dim=1)


class _Filters(nn.Module):
    """The four reconstruction filters as f32 non-persistent buffers."""

    def _register_filters(self, base: str, k: int) -> None:
        for name, arr in zip(("ec_s", "ec_d", "rc_e", "rc_o"), _reconstruction_filters(base, k)):
            self.register_buffer(name, torch.from_numpy(arr.astype(np.float32)),
                                 persistent=False)


def _modes_first(w_real: torch.Tensor, w_imag: torch.Tensor) -> torch.Tensor:
    """``(d_in, d_out, alpha)`` real and imaginary weights as one
    ``(alpha, d_in, 2 d_out)``, mode first: the real, then the imaginary
    outputs."""
    d_in, d_out, alpha = w_real.shape
    w = torch.stack((w_real.permute(2, 0, 1), w_imag.permute(2, 0, 1)), dim=2)
    return w.reshape(alpha, d_in, 2 * d_out)


def _product_table(n: int, m: int, dtype, device) -> torch.Tensor:
    """``(4m, n)``: the inverse DFT (``irdft``'s table) of a complex
    product given as its four real ones, rows (input part, weight part,
    mode): ``rr - ii`` is the real part, ``ri + ir`` the imaginary one."""
    def build():
        inv = _tables(n, m, dtype, device)[1]  # (2m, n): real rows, then imaginary
        return torch.cat((inv[:m], inv[m:], inv[m:], -inv[:m]))
    return kept(("dft_products", n, m, dtype, device), build)


class SparseKernelFT1d(nn.Module):
    """Frequency-domain linear operator on the lowest ``alpha`` modes.

    On a mesh the structural rule splits the square ``(d, d, alpha)``
    weights over ``model`` along their first dim (its tie-break), the input
    channels: a row split (``parallel/mesh.py``), computed by
    ``mesh_split_forward``."""

    mesh_split_weights = ("w_real", "w_imag")
    mesh_channel_dims = (0, None)  # (input, output) channels: a row split only

    def __init__(self, k: int, alpha: int, c: int = 1):
        super().__init__()
        self.modes = alpha
        self.k = k
        d = c * k
        scale = 1.0 / (d * d)
        self.w_real = nn.Parameter(scale * torch.rand(d, d, alpha))
        self.w_imag = nn.Parameter(scale * torch.rand(d, d, alpha))

    def forward(self, xs: list) -> list:
        """The operator on each level ``(B, N, c, k)`` of ``xs``."""
        w = weight_cache.derived("sparse_kernel_ft", _modes_first, self.w_real, self.w_imag)
        return [self._level(x.flatten(2), w).view(x.shape) for x in xs]

    def mesh_split_forward(self, split, xs: list) -> list:
        """``forward`` on this rank's block of the input channels: their
        DFT and their product with the weights' block, the partial products
        summed over ``model`` in f32 and cut to this rank's output channels
        (``split.scatter_sum``), their inverse DFT, the outputs gathered. So
        a rank does 1/n_model of each of the three products."""
        w = _modes_first(*split.blocks())
        return [split.gather(self._level(split.take_input(x.flatten(2), -1), w,
                                         split.scatter_sum), -1).view(x.shape) for x in xs]

    def _level(self, x: torch.Tensor, w: torch.Tensor, reduce=None) -> torch.Tensor:
        """One level ``(B, N, d_in)`` through ``w`` (``_modes_first``) to
        ``(B, N, d_out)``; ``reduce(products, dim)`` takes the products
        before the inverse DFT (their output channels on ``dim``)."""
        b, n, d = x.shape
        m = min(self.modes, n // 2 + 1)
        fwd = _tables(n, m, x.dtype, x.device)[0]  # (n, 2m)
        spec = fwd.t() @ x  # (B, 2m, d): the parts, then the modes
        spec = spec.unflatten(1, (2, m)).permute(2, 1, 0, 3).reshape(m, 2 * b, d)
        prod = torch.bmm(spec, w[:m]).view(m, 2, b, 2, -1)  # the four real products
        if reduce is not None:
            prod = reduce(prod, -1)
        prod = prod.permute(2, 1, 3, 0, 4).reshape(b, 4 * m, prod.shape[-1])
        return _product_table(n, m, x.dtype, x.device).t() @ prod


class MWT_CZ1d(_Filters):
    """One multiwavelet Cui-Zhang block."""

    def __init__(self, k: int = 3, alpha: int = 64, L: int = 0, c: int = 1,
                 base: str = "legendre"):
        super().__init__()
        self.k, self.L = k, L
        self._register_filters(base, k)
        self.A = SparseKernelFT1d(k, alpha, c)
        self.B = SparseKernelFT1d(k, alpha, c)
        self.C = SparseKernelFT1d(k, alpha, c)
        self.T0 = nn.Linear(k, k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[1]
        ns = math.floor(math.log2(n))
        x = _extend(x, n)
        ds, ss = [], []
        for _ in range(ns - self.L):
            d, x = _wavelet_transform(x, self.ec_d, self.ec_s)
            ds.append(d)
            ss.append(x)
        ud = [a + b for a, b in zip(self.A(ds), self.B(ss))]
        us = self.C(ds)
        x = self.T0(x)
        for i in range(ns - 1 - self.L, -1, -1):
            x = torch.cat([x + us[i], ud[i]], dim=-1)
            x = _even_odd(x, self.rc_e, self.rc_o, self.k)
        return x[:, :n]


class MultiWaveletTransform(nn.Module):
    """The multiwavelet self-"attention": values only; returns
    ``(B, L, H, E)``."""

    def __init__(self, ich: int = 1, k: int = 8, alpha: int = 16, c: int = 128,
                 nCZ: int = 1, L: int = 0, base: str = "legendre"):
        super().__init__()
        self.k, self.c, self.nCZ = k, c, nCZ
        self.Lk0 = nn.Linear(ich, c * k)
        self.Lk1 = nn.Linear(c * k, ich)
        self.mwt_cz = nn.ModuleList(MWT_CZ1d(k, alpha, L, c, base) for _ in range(nCZ))

    def forward(self, queries, keys, values, attn_mask=None):
        b, l, h, e = queries.shape
        s = values.shape[1]
        if l > s:
            values = torch.cat([values, torch.zeros_like(queries[:, : l - s])], dim=1)
        else:
            values = values[:, :l]
        v = self.Lk0(values.reshape(b, l, -1)).reshape(b, l, self.c, -1)
        for i, blk in enumerate(self.mwt_cz):
            v = blk(v)
            if i < self.nCZ - 1:
                v = torch.relu(v)
        v = self.Lk1(v.reshape(b, l, -1))
        return v.reshape(b, l, -1, e), None


class FourierCrossAttentionW(nn.Module):
    """Parameter-free frequency-domain cross attention on the lowest modes."""

    def __init__(self, in_channels, out_channels, seq_len_q, seq_len_kv, modes=16,
                 activation="tanh"):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.modes = modes
        self.activation = activation

    def forward(self, q, k, v, attn_mask=None):
        b, l, e, h = q.shape
        xq = q.permute(0, 3, 2, 1)  # (B, H, E, L)
        xk = k.permute(0, 3, 2, 1)
        mq = min(l // 2, self.modes)
        mk = min(xk.shape[-1] // 2, self.modes)
        xq_ft = rdft(xq, mq)
        xk_blocks = blocks(rdft(xk, mk))
        xqk = activate(complex_einsum("bhex,bhey->bhxy", xq_ft, xk_blocks), self.activation)
        xqkv = complex_einsum("bhxy,bhey->bhex", xqk, xk_blocks)
        out = irdft(xqkv / self.in_channels / self.out_channels, mq, l)
        return out.permute(0, 3, 2, 1), None


class MultiWaveletCross(_Filters):
    """Multiwavelet cross attention; returns ``(B, N, H, E)``."""

    def __init__(self, in_channels, out_channels, seq_len_q, seq_len_kv, modes, c=64, k=8,
                 ich=512, L=0, base="legendre", activation="tanh"):
        super().__init__()
        self.c, self.k, self.L = c, k, L
        self._register_filters(base, k)
        for name in ("attn1", "attn2", "attn3", "attn4"):
            setattr(self, name, FourierCrossAttentionW(in_channels, out_channels, seq_len_q,
                                                       seq_len_kv, modes, activation))
        self.T0 = nn.Linear(k, k)
        self.Lk = nn.Linear(ich, c * k)
        self.Lq = nn.Linear(ich, c * k)
        self.Lv = nn.Linear(ich, c * k)
        self.out = nn.Linear(c * k, ich)

    def _decompose(self, x, ns):
        """``ns - L`` analysis steps: the ``(d, s)`` of each and the
        coarsest ``s``."""
        steps = []
        for _ in range(ns - self.L):
            d, x = _wavelet_transform(x, self.ec_d, self.ec_s)
            steps.append((d, x))
        return steps, x

    def forward(self, q, k, v, attn_mask=None):
        b, n, h, e = q.shape
        s = k.shape[1]
        q = self.Lq(q.reshape(b, n, -1)).reshape(b, n, self.c, self.k)
        k = self.Lk(k.reshape(b, s, -1)).reshape(b, s, self.c, self.k)
        v = self.Lv(v.reshape(b, s, -1)).reshape(b, s, self.c, self.k)
        if n > s:
            zeros = torch.zeros_like(q[:, : n - s])
            v = torch.cat([v, zeros], dim=1)
            k = torch.cat([k, zeros], dim=1)
        else:
            v, k = v[:, :n], k[:, :n]
        ns = math.floor(math.log2(n))
        steps_q, q = self._decompose(_extend(q, n), ns)
        steps_k, k = self._decompose(_extend(k, n), ns)
        steps_v, v = self._decompose(_extend(v, n), ns)
        ud, us = [], []
        for (dq, sq), (dk, sk), (dv, sv) in zip(steps_q, steps_k, steps_v):
            ud.append(self.attn1(dq, dk, dv)[0] + self.attn2(sq, sk, sv)[0])
            us.append(self.attn3(dq, dk, dv)[0])
        v = self.attn4(q, k, v)[0]
        for i in range(ns - 1 - self.L, -1, -1):
            v = torch.cat([v + us[i], ud[i]], dim=-1)
            v = _even_odd(v, self.rc_e, self.rc_o, self.k)
        v = self.out(v[:, :n].reshape(b, n, -1))
        return v.reshape(b, n, -1, e), None
