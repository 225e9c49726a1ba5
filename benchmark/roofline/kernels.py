"""Operations and bytes that each kernel's inputs need, from its shapes.

Each counts what the result needs whatever computes it: every input byte
read once and every output byte written once, two operations a
multiply-add, and where the work depends on the data (ProbSparse keeps
``u`` of ``L`` queries) the work these inputs need. The arithmetic is the
one behind the port's bring-up bounds (``k1_gemms``, ``bound_ms``), frozen
here so that a change to the program cannot move it.
"""

import math


def swin_stages(v: dict) -> list:
    """A SwinV2's blocks per frame: [(tokens T, channels C, window tokens n,
    heads, window kinds of a shifted block or 1, blocks)]."""
    hw, c, out = v["img_size"] // v["patch_size"], v["embed_dim"], []
    for depth, heads in zip(v["depths"], v["heads"]):
        window = min(v["window"], hw)
        kinds = (hw // window) ** 2 if window < hw else 1
        out.append((hw * hw, c, window * window, heads, kinds, depth))
        hw, c = hw // 2, c * 2
    return out


def k1_call(frames: int, t: int, c: int, n: int, heads: int, kinds: int) -> tuple:
    """(flops, bytes) of one fused SwinV2 block over ``frames`` frames: the
    qkv, proj, fc1 and fc2 GEMMs (12 C^2 multiply-adds a token) and the
    window attention's two products (2 n C a token); bf16 activations in
    and out, bf16 weights, the f32 position bias (per window kind)."""
    tokens = frames * t
    flops = 2 * tokens * 12 * c * c + 4 * tokens * n * c
    nbytes = 2 * 2 * tokens * c + 2 * 12 * c * c + 4 * kinds * heads * n * n
    return flops, nbytes


def k1_frame_flops(v: dict) -> float:
    return sum(blocks * k1_call(1, t, c, n, h, 1)[0]
               for t, c, n, h, _, blocks in swin_stages(v))


def prob_sparse_u(l: int, factor: int = 5) -> int:
    return min(int(factor * math.ceil(math.log(l))), l)


def k3b_layer(r: int, l: int, d: int = 128, f: int = 256, factor: int = 5) -> tuple:
    """(flops, bytes) of one Perceive layer's backward from its saved
    input: the forward it needs again (the GEMMs, the sparsity measure
    over all queries, softmax and p.v over the ``u`` kept ones) and the
    backward (each GEMM's input and weight gradients, the attention's four
    products over the kept queries); f32 x, dy and dx, int8 masks, f32
    weights and their gradients."""
    m, u = r * l, prob_sparse_u(l, factor)
    gemm = 2 * m * (4 * d * d + 2 * d * f)
    forward = gemm + 2 * r * l * l * d + 2 * r * u * l * d
    backward = 2 * gemm + 8 * r * u * l * d
    weights = 4 * d * d + 2 * d * f + 7 * d + f
    nbytes = 3 * 4 * m * d + m * (2 * d + f) + 2 * 4 * weights + 4 * l * l
    return forward + backward, nbytes


def k4_call(b: int, l: int, h: int, e: int) -> tuple:
    """(flops, bytes) of dense attention over (B, L, H, E) bf16 q, k, v:
    the two products (4 B H L^2 E), q, k, v read and the output written."""
    return 4 * b * h * l * l * e, 4 * 2 * b * l * h * e
