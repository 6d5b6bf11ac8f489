"""2x trilinear upsample fused into a stride-2 k3 conv (port of
``jarvis_hybridnet_tpu/ops/fused_upfront.py``).

conv_s2(up2(x)) equals a stride-1 k3 conv of x on the half grid with an
interior-transformed kernel, plus corrections on the faces, edges and
corners where the upsample's edge clamp meets the conv's zero padding. Per
axis, with taps (-1, 0, +1):

  interior:   v = T_IN @ w
  face n=0:   + 0.25 (w[0] - w[-1]) x[0]
  face n=L-1: + 0.25 w[1] x[L-1]

The 3D correction expands over every non-empty subset of axes: the delta
pattern on the subset's axes, the interior transform on the others, applied
to the boundary slice (2D convs for faces, 1D for edges, a matmul for
corners). The transformed kernels depend only on the weights: inference
computes them once (``models/v2v.Basic3DBlock`` caches them under
``no_grad``), training in every step, through autograd, so the weight gets
its gradient as the JAX package's ``jax.grad`` through ``fused_up_conv3d``
gives it. Plain cuDNN convolutions.
"""

from __future__ import annotations

import functools
import itertools

import torch
import torch.nn.functional as F

# rows: new tap (-1, 0, +1); cols: original tap (-1, 0, +1)
_T_IN = torch.tensor([[0.75, 0.25, 0.0],
                      [0.25, 0.75, 0.75],
                      [0.0, 0.0, 0.25]], dtype=torch.float32)
_D_LO = torch.tensor([-0.25, 0.25, 0.0], dtype=torch.float32)
_D_HI = torch.tensor([0.0, 0.0, 0.25], dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _on(device: torch.device) -> tuple:
    """(T_IN, D_LO, D_HI) on ``device``, copied there once: a copy from the
    host in every training step would synchronize, which a CUDA graph's
    capture refuses."""
    return tuple(t.to(device) for t in (_T_IN, _D_LO, _D_HI))


def _transform_interior(w: torch.Tensor, axes) -> torch.Tensor:
    """Interior transform on the given spatial axes of (3, 3, 3, Cin, Cout)."""
    t = _on(w.device)[0]
    eqs = ("ab,bjkio->ajkio", "ab,jbkio->jakio", "ab,jkbio->jkaio")
    for a in axes:
        w = torch.einsum(eqs[a], t, w)
    return w


def _contract_delta(w: torch.Tensor, axis: int, lo: bool) -> torch.Tensor:
    d = _on(w.device)[1 if lo else 2]
    return torch.tensordot(d, torch.movedim(w, axis, 0), dims=([0], [0]))


def _corrections():
    """(axes, faces) of every boundary correction, in the JAX order."""
    for size in (1, 2, 3):
        for axes in itertools.combinations((0, 1, 2), size):
            for faces in itertools.product((True, False), repeat=size):
                yield axes, faces


def prepare_fused_weights(weight: torch.Tensor, dtype: torch.dtype):
    """Transformed kernels for :func:`fused_up_conv3d`.

    weight: torch Conv3d layout (Cout, Cin, 3, 3, 3). Returns the interior
    kernel (Cout, Cin, 3, 3, 3) and one kernel per correction, in torch conv
    layouts (a (Cin, Cout) matrix for corners), cast to ``dtype``;
    differentiable in ``weight``.
    """
    w = weight.float().permute(2, 3, 4, 1, 0)  # DHWIO, as in JAX
    interior = _transform_interior(w, (0, 1, 2)).permute(4, 3, 0, 1, 2)
    corr = []
    for axes, faces in _corrections():
        wc = _transform_interior(w, [a for a in (0, 1, 2) if a not in axes])
        consumed = 0
        for a, lo in sorted(zip(axes, faces)):
            wc = _contract_delta(wc, a - consumed, lo)
            consumed += 1
        if len(axes) < 3:  # (*spatial, Cin, Cout) -> (Cout, Cin, *spatial)
            r = wc.dim()
            wc = wc.permute(r - 1, r - 2, *range(r - 2))
        corr.append(wc.to(dtype).contiguous())
    return interior.to(dtype).contiguous(memory_format=torch.channels_last_3d), corr


def fused_up_conv3d(x: torch.Tensor, interior: torch.Tensor, corr,
                    bias: torch.Tensor | None = None):
    """== conv3d(stride 2, pad 1)(trilinear_up2(x)) on the half grid.

    x: (B, Cin, L, L, L); kernels from :func:`prepare_fused_weights`;
    ``bias`` is added after the sum of the pieces, in its dtype, or left out
    (K1 adds it: ``models/v2v.Basic3DBlock``).
    """
    x = x.to(interior.dtype)
    y = F.conv3d(x, interior, padding=1)
    for (axes, faces), w in zip(_corrections(), corr):
        index = [slice(None)] * 5
        for a, lo in zip(axes, faces):
            index[2 + a] = 0 if lo else -1  # integer index drops the axis
        piece = x[tuple(index)]
        if len(axes) == 3:
            c = piece @ w  # (B, Cin) @ (Cin, Cout)
        elif len(axes) == 2:
            c = F.conv1d(piece, w, padding=1)
        else:
            c = F.conv2d(piece, w, padding=1)
        y[tuple(index)] += c
    return y if bias is None else y + bias.to(y.dtype).reshape(1, -1, 1, 1, 1)
