"""Sharded inference (port of ``jarvis_hybridnet_tpu/parallel/predict_step.py``).

The fused predict3D cascade over a mesh of ranks, one process per GPU:

* ``data``: each data group takes its own frames (the prediction drivers
  give each group a contiguous time slice of the recording,
  ``multihost.process_frame_range``), with no collective on its path;
* ``cameras`` (optional): each camera rank of a group takes its
  ``C / n_cameras`` cameras' frames and runs K4, CenterDetect and
  KeypointDetect on them; the (T, C, 2) centers and their maxima are
  gathered over the camera group, in camera order, for the >= 2-camera gate
  and the weighted DLT, which every rank then computes alike; the
  reprojection layer's camera mean becomes a sum over the camera group;
  V2V and K3 run on every camera rank, and camera rank 0 of each group
  keeps the rows (``Predict3D.set_mesh``).

The 2D cascade has no cross-frame coupling: each rank predicts its frames
alone (``build_sharded_predict2d``).

Under NCCL the collectives of a camera-sharded step are captured in the
predictor's CUDA graph (``graph=True``); gloo's cannot be, and a gloo mesh
on the card takes ``graph=False``.
"""

from __future__ import annotations

from ..prediction.loaders import make_predictor2d, make_predictor3d
from ..training.graphed import check_capturable


def build_sharded_predict3d(cfg, rig, weights_center_detect="latest",
                            weights_hybridnet="latest", mesh=None, dtype=None,
                            shard_cameras: bool = False, device="cuda", graph: bool = True):
    """``make_predictor3d`` on this rank of ``mesh``: a call takes this
    rank's frames (T, C, H, W, 3), or with ``shard_cameras`` its cameras'
    frames (T, C / n_cameras, H, W, 3), and returns the (points3D,
    confidences, valid) of its framesets, the same on every camera rank."""
    mesh = mesh if shard_cameras and mesh is not None and mesh.n_cameras > 1 else None
    check_capturable(graph, device, mesh)
    predictor = make_predictor3d(cfg, rig, weights_center_detect, weights_hybridnet,
                                 dtype=dtype, device=device, graph=False)
    predictor.set_mesh(mesh)
    if graph:
        from ..prediction.export import wrap_predictor

        predictor.step = wrap_predictor(predictor.eager_step, predictor.device)
    return predictor


def build_sharded_predict2d(cfg, weights_center_detect="latest",
                            weights_keypoint_detect="latest", mesh=None, dtype=None,
                            device="cuda", graph: bool = True):
    """``make_predictor2d`` on this rank of ``mesh``: a call takes this
    rank's frames and returns its (points2D, confidences, valid); no
    collective runs (each rank predicts its frames alone)."""
    del mesh
    return make_predictor2d(cfg, weights_center_detect, weights_keypoint_detect, dtype=dtype,
                            device=device, graph=graph)
