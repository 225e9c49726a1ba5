"""Weights derived from parameters, kept from one call to the next.

``derived`` is shared by the kernels' wrappers: K1's bf16 weights and
position bias (``swin_block_fusion``) and the Perceive encoder's stacked
and kernel weights (``models/cross_modal.py``, K3a/K3b), by the mesh's
split layers (their blocks' bf16 casts, ``parallel/mesh.py``), and by
FEDformer's spectral layers (their weights' block forms and mode-first
layout, ``models/layers/fourier.py`` and ``multiwavelet.py``).

On a ``(data, model)`` mesh the sources of a gathered weight are the whole
tensors ``parallel.mesh.MeshParams.gathered`` makes: new tensors at every
gather, one gather unit at a time, which die when the unit returns (the
backward gathers again). So the cache misses on every call of a gathered
unit (K1's and K3's under a mesh), and a value cached from one gather is
never served to the next: its weak references die with the gathered
tensors, and the entry with them. A split layer computes on this rank's
block, the parameter itself, so its cast hits from one call to the next
(outside autograd; under FSDP the block is gathered over ``data`` and
misses too). A value the backward needs (K3b's derived weights) is saved
by autograd itself, so K3b's backward reads the weights its forward read.
"""

import weakref

import torch

_derived = {}  # (kind, id of each source) -> (stamps, weak references, value)


def _stamp(t):
    return t._version, t.data_ptr(), t.dtype, t.device, tuple(t.shape)


def derived(kind, fn, *sources, differentiable=True):
    """``fn(*sources)``, computed once and reused while every source is the
    same tensor with the same ``_version`` (which every in-place update
    bumps: an optimizer step, ``copy_`` in ``load_flax_params`` or
    ``load_state_dict``) and storage. A ``differentiable`` value is
    computed afresh while autograd records through a source, so its
    gradient still reaches the source; any other is computed without
    autograd (the kernel's bf16 weights: the block's backward recomputes
    from the f32 parameters). While ``torch.export`` traces, the value is
    computed in the graph, from the sources the exported program is
    given."""
    if torch.compiler.is_exporting() or any(s.is_inference() for s in sources) or (
            differentiable and torch.is_grad_enabled()
            and any(s.requires_grad for s in sources)):
        return fn(*sources)
    key = (kind, *map(id, sources))
    stamps = tuple(map(_stamp, sources))
    hit = _derived.get(key)
    if hit is not None and hit[0] == stamps and all(r() is s for r, s in zip(hit[1], sources)):
        return hit[2]
    with torch.inference_mode(False), torch.no_grad():  # a normal tensor, reusable anywhere
        value = fn(*sources)
    refs = [weakref.ref(s, lambda _, key=key: _derived.pop(key, None)) for s in sources]
    _derived[key] = (stamps, refs, value)
    return value
