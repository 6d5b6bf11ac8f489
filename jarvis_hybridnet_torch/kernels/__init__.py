"""Hand-written CUDA kernels of the port, one wrapper module each.

Every wrapper runs its plain PyTorch version on CPU tensors and launches its
CUDA kernel on CUDA tensors (raising if it cannot); there is no fallback.
Each wrapper counts the calls that launch its CUDA source in
``<wrapper>.launches``. Every call of K1-K5 launches one ``__global__``
kernel:

- instance_norm_act (K1) launches with ``cudaLaunchKernelEx`` and a thread
  block cluster per sample: its CTAs bring their rows into shared memory
  with bulk TMA copies and merge their statistics through distributed
  shared memory, so it needs ``sm_90a`` and the cluster launch API;
- repro_quarter_gather (K2, quarter_fused) computes a tile of the quarter
  grid with a one-voxel halo in shared memory (index, gather, upsample) and
  writes the half grid from it;
- repro_grid_gather (K5, exact / half / half_fused) does the same on the
  half grid, with the index upsample (exact) or the value upsample (half);
- soft_argmax (K3) runs a thread block cluster per frameset whose CTAs merge
  their sums through distributed shared memory;
- resize_normalize (K4) resizes and normalizes the uint8 or float32 frames;
- instance_norm_act_backward (K6), K1's gradient, runs three kernels per
  call (statistics, sums, the gradient), each a grid of row chunks;
- hybridnet_loss_fwd / hybridnet_loss_bwd (K7), the 3D training loss with
  its Gaussian target built on the fly, run two kernels (partials, then one
  block that sums them) and one.

``InstanceNormAct`` (K1 forward, K6 backward) and ``hybridnet_loss`` (K7)
are the autograd Functions the training step goes through.
"""

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
from .repro_gather import repro_quarter_gather, repro_quarter_gather_plain
from .repro_grid_gather import repro_grid_gather, repro_grid_gather_plain
from .resize_normalize import resize_normalize, resize_normalize_plain
from .soft_argmax import soft_argmax, soft_argmax_plain

WRAPPERS = (instance_norm_act, repro_quarter_gather, repro_grid_gather, soft_argmax,
            resize_normalize, instance_norm_act_backward, hybridnet_loss_fwd,
            hybridnet_loss_bwd)


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict[str, int]:
    return {w.__name__: w.launches for w in WRAPPERS}


__all__ = [
    "InstanceNormAct", "WRAPPERS", "hybridnet_loss", "hybridnet_loss_bwd",
    "hybridnet_loss_bwd_plain", "hybridnet_loss_fwd", "hybridnet_loss_fwd_plain",
    "instance_norm_act", "instance_norm_act_backward", "instance_norm_act_backward_plain",
    "instance_norm_act_plain",
    "launch_counts", "repro_grid_gather", "repro_grid_gather_plain",
    "repro_quarter_gather", "repro_quarter_gather_plain",
    "reset_launch_counts", "resize_normalize", "resize_normalize_plain",
    "soft_argmax", "soft_argmax_plain",
]
