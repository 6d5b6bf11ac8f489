"""Hand-written CUDA kernels of the port, one wrapper module each.

Every wrapper runs its plain PyTorch version on CPU tensors and launches its
CUDA kernel on CUDA tensors (raising if it cannot); there is no fallback.
Each wrapper counts the calls that launch its CUDA source in
``<wrapper>.launches``. Every call launches one ``__global__`` kernel:

- instance_norm_act (K1) launches with ``cudaLaunchKernelEx`` and a thread
  block cluster per sample: its CTAs bring their rows into shared memory
  with bulk TMA copies and merge their statistics through distributed
  shared memory, so it needs ``sm_90a`` and the cluster launch API; it can
  return the statistics it used, for the backward;
- repro_quarter_gather (K2, quarter_fused) computes a tile of the quarter
  grid with a one-voxel halo in shared memory (index, gather, upsample) and
  writes the half grid from it;
- repro_grid_gather (K5, exact / half / half_fused) does the same on the
  half grid, with the index upsample (exact) or the value upsample (half);
- soft_argmax (K3) runs a thread block cluster per frameset whose CTAs merge
  their sums through distributed shared memory;
- resize_normalize (K4) resizes and normalizes the uint8 or float32 frames;
- instance_norm_act_backward (K6), K1's gradient from K1's statistics, is
  a cooperative grid of co-resident thread block clusters that holds its
  spans of rows in shared memory across one grid-wide barrier;
- hybridnet_loss_fwd / hybridnet_loss_bwd (K7), the 3D training loss with
  its Gaussian target built on the fly: the forward's last block to finish
  sums every block's partials;
- heatmap2d_loss_fwd / heatmap2d_loss_bwd (K8), the 2D training loss with
  its two Gaussian targets built on the fly: a block per band of rows of one
  image and scale, 16-byte loads with positions carried by adds; the
  forward's last block sums the partials;
- color_aug (K9) turns raw uint8 images into the normalized network input,
  with the training-time color augmentation (a blur over bands of whole
  rows staged once in shared memory, Philox noise, contrast and gains, the
  warp-border re-zero) between; without a record or a border, a flat walk
  of 4 bytes to a float4 a thread;
- argmax2d (K10) reduces each heatmap channel to its maximum and first
  index through 64-bit order keys, several CTAs a channel (or an image of
  channels-last heads), merged by atomics and a last-CTA ticket.
- repro_quarter_gather_backward (K11) and repro_grid_gather_backward (K12),
  the gathers' VJPs with respect to the rows, into a buffer zeroed on the
  stream. K11: a thread per (gather point, joint) sums the transposed
  value upsample and adds it, divided by C, to each camera's row with
  float atomics. K12: a block per tile of gather points stages the tile's
  values (half: the transposed upsample, separably from the tile's
  upstream block) and every camera's indices in shared memory; exact sorts
  each camera's points by pixel inside a window over the tile's box and
  adds each pixel's sum once, in 16-byte reductions; half_fused takes a
  thread per (point, 4 joints) and no tile.

The serving kernels, K1, K2, K3, K4, K5 and K10, are registered operators
(``torch.library.custom_op``, namespace ``jarvis_torch``, listed in
``SERVING_OPS``): each wrapper calls its op, whose CPU implementation is the
plain version and whose CUDA implementation is the kernel's launch through
its ctypes binding (counting the launch), and a fake implementation gives
the output shapes and dtypes. So ``torch.export`` keeps each kernel as one
node of an exported predictor (``prediction/export.py``), and a loaded
artifact launches the same kernels, counted alike, as the live predictor.

``InstanceNormAct`` (K1 forward, K6 backward), ``hybridnet_loss`` (K7),
``Heatmap2DLoss`` (K8, through ``heatmap2d_loss``), ``QuarterGather`` (K2
forward, K11 backward) and ``GridGather`` (K5 forward, K12 backward) are the
autograd Functions the training steps go through.
"""

from .argmax2d import argmax2d, argmax_2d_plain
from .color_aug import color_aug, color_aug_plain
from .heatmap2d_loss import (
    Heatmap2DLoss,
    heatmap2d_loss,
    heatmap2d_loss_bwd,
    heatmap2d_loss_bwd_plain,
    heatmap2d_loss_fwd,
    heatmap2d_loss_fwd_plain,
)
from .hybridnet_loss import (
    hybridnet_loss,
    hybridnet_loss_bwd,
    hybridnet_loss_bwd_plain,
    hybridnet_loss_fwd,
    hybridnet_loss_fwd_plain,
)
from .instance_norm import (
    InstanceNormAct,
    instance_norm_act,
    instance_norm_act_backward,
    instance_norm_act_backward_plain,
    instance_norm_act_plain,
)
from .repro_gather import (
    repro_quarter_gather,
    repro_quarter_gather_backward,
    repro_quarter_gather_backward_plain,
    repro_quarter_gather_plain,
)
from .repro_grid_gather import (
    repro_grid_gather,
    repro_grid_gather_backward,
    repro_grid_gather_backward_plain,
    repro_grid_gather_plain,
)
from .resize_normalize import resize_normalize, resize_normalize_plain
from .soft_argmax import soft_argmax, soft_argmax_plain

WRAPPERS = (instance_norm_act, repro_quarter_gather, repro_grid_gather, soft_argmax,
            resize_normalize, instance_norm_act_backward, hybridnet_loss_fwd,
            hybridnet_loss_bwd, heatmap2d_loss_fwd, heatmap2d_loss_bwd, color_aug, argmax2d,
            repro_quarter_gather_backward, repro_grid_gather_backward)


SERVING_OPS = ("instance_norm_act", "repro_quarter_gather", "repro_grid_gather", "soft_argmax",
               "resize_normalize", "argmax2d")


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict[str, int]:
    return {w.__name__: w.launches for w in WRAPPERS}


__all__ = [
    "Heatmap2DLoss", "InstanceNormAct", "WRAPPERS", "argmax2d", "argmax_2d_plain", "color_aug",
    "color_aug_plain",
    "heatmap2d_loss", "heatmap2d_loss_bwd", "heatmap2d_loss_bwd_plain", "heatmap2d_loss_fwd",
    "heatmap2d_loss_fwd_plain", "hybridnet_loss", "hybridnet_loss_bwd",
    "hybridnet_loss_bwd_plain", "hybridnet_loss_fwd", "hybridnet_loss_fwd_plain",
    "instance_norm_act", "instance_norm_act_backward", "instance_norm_act_backward_plain",
    "instance_norm_act_plain",
    "launch_counts", "repro_grid_gather", "repro_grid_gather_backward",
    "repro_grid_gather_backward_plain", "repro_grid_gather_plain",
    "repro_quarter_gather", "repro_quarter_gather_backward",
    "repro_quarter_gather_backward_plain", "repro_quarter_gather_plain",
    "SERVING_OPS", "reset_launch_counts", "resize_normalize", "resize_normalize_plain",
    "soft_argmax", "soft_argmax_plain",
]
