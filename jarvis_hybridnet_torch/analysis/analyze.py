"""Validation-set accuracy analysis (port of
``jarvis_hybridnet_tpu/analysis/analyze.py``; reference
analyze_validation_data, jarvis/analysis/analyze.py:22-96).

Runs the fused 3D predictor over the val split (full frames, the dataset's
``analysisMode``) on ``device``, the card unless the caller asks for the
CPU, and writes ``frame_names.csv``, ``points_HybridNet.csv`` and
``points_GroundTruth.csv`` to
``projects/<p>/analysis/Validation_Predictions_<ts>/``. Framesets the
network cannot detect are left out, with a warning, as the reference does.

The framesets are read by the native prefetching pipeline
(``native.FramesetPipeline``: uint8 frames) where its library builds and
the frames are same-sized JPEGs, else through the dataset with cv2 (float32
frames in [0, 1]); both are inputs the predictor takes. The tail batch is
padded to ``frame_batch`` framesets: on the card a new leading size would
capture a new CUDA graph (``prediction/export.py``).
"""

from __future__ import annotations

import os
import time

import numpy as np

from ..config.project_manager import ProjectManager
from ..dataset.dataset3d import Dataset3D
from ..prediction.loaders import make_predictor3d
from ..utils import clp


def _native_frameset_stream(dataset, cfg):
    """The C++ decode of whole framesets (``native.FramesetPipeline``):
    every camera's full-frame JPEG decode runs in worker threads ahead of
    the predictor. None where the native library does not load or the
    frames are not same-sized JPEGs."""
    from .. import native

    if not native.available():
        return None
    framesets = []
    size = None
    for key in dataset.frameset_keys:
        fs = dataset.dataset["framesets"][key]
        frame_ids = fs["frames"]
        if dataset.use_idxs is not None:
            frame_ids = [frame_ids[i] for i in dataset.use_idxs]
        paths = []
        for img_id in frame_ids:
            name = dataset.imgs[img_id]["file_name"]
            if not name.lower().endswith((".jpg", ".jpeg")):
                return None
            meta = dataset.imgs[img_id]
            wh = (int(meta.get("width", cfg.DATASET.IMAGE_SIZE[0])),
                  int(meta.get("height", cfg.DATASET.IMAGE_SIZE[1])))
            if size is None:
                size = wh
            elif size != wh:
                return None
            paths.append(os.path.join(dataset.root_dir, dataset.set_name, name))
        framesets.append(paths)
    if not framesets:
        return None
    return native.FramesetPipeline(framesets, size[0], size[1], prefetch=4)


def analyze_validation_data(
    project_name,
    weights_center="latest",
    weights_hybridnet="latest",
    cameras_to_use=None,
    progress_bar=None,
    frame_batch=8,
    max_framesets=None,
    repro_mode=None,
    device="cuda",
):
    """Run the project's predictor over its val split; returns the output
    directory, or None when the project does not load. ``repro_mode``
    overrides ``TPU.REPRO_MODE`` without editing the project's config."""
    from tqdm import tqdm

    project = ProjectManager()
    if not project.load(project_name):
        return None
    cfg = project.get_cfg()
    if repro_mode is not None:
        cfg.TPU.REPRO_MODE = repro_mode

    output_dir = os.path.join(
        project.parent_dir, cfg.PROJECTS_ROOT_PATH, project_name,
        "analysis", f'Validation_Predictions_{time.strftime("%Y%m%d-%H%M%S")}',
    )
    os.makedirs(output_dir)

    dataset = Dataset3D(cfg, set="val", analysisMode=True, cameras_to_use=cameras_to_use)
    if max_framesets is not None:
        dataset.frameset_keys = dataset.frameset_keys[:max_framesets]
        dataset.keypoints3D = dataset.keypoints3D[:max_framesets]

    points_net, points_gt, filenames = [], [], []
    # one predictor per calibration session (its cameras are the
    # predictor's); typically there is a single session
    predictors = {}

    n = len(dataset)
    buf, metas = [], []

    def flush():
        if not buf:
            return
        name = metas[0][1]
        if name not in predictors:
            predictors[name] = make_predictor3d(cfg, dataset.rigs[name], weights_center,
                                                weights_hybridnet, device=device)
        k = len(buf)
        imgs = np.stack(buf)
        if k < frame_batch:
            pad = np.repeat(imgs[-1:], frame_batch - k, axis=0)
            imgs = np.concatenate([imgs, pad], axis=0)
        pts, _, valid = predictors[name](imgs)
        pts, valid = pts[:k].cpu().numpy(), valid[:k].cpu().numpy()
        for (kp3d, _, fname), p, v in zip(metas, pts, valid):
            if v:
                points_net.append(p)
                points_gt.append(kp3d)
                filenames.append(fname)
        buf.clear()
        metas.clear()

    def meta_for(idx):
        fs = dataset.dataset["framesets"][dataset.frameset_keys[idx]]
        return (dataset.keypoints3D[idx].astype(np.float32), fs["datasetName"],
                dataset.imgs[fs["frames"][0]]["file_name"])

    pipeline = _native_frameset_stream(dataset, cfg)
    if pipeline is not None:
        # uint8 framesets from the C++ prefetcher; the predictor scales
        # uint8 frames on the device
        try:
            for count, (idx, imgs) in enumerate(tqdm(pipeline, total=n)):
                m = meta_for(idx)
                if metas and metas[0][1] != m[1]:
                    flush()
                buf.append(imgs)
                metas.append(m)
                if len(buf) == frame_batch:
                    flush()
                if progress_bar is not None:
                    progress_bar.progress((count + 1) / n)
        finally:
            pipeline.close()
    else:
        for idx in tqdm(range(n)):
            s = dataset[idx]
            if metas and metas[0][1] != s["dataset_name"]:
                flush()
            buf.append(s["imgs"])
            metas.append((s["keypoints3D"], s["dataset_name"], s["file_name"]))
            if len(buf) == frame_batch:
                flush()
            if progress_bar is not None:
                progress_bar.progress((idx + 1) / n)
    flush()

    clp.success("Successfully analysed all validation frames!")
    if len(points_net) != n:
        clp.warning(
            f"Network could not detect instance in {n - len(points_net)} "
            "frameSets. Those were not included in the output files!"
        )

    J = int(cfg.KEYPOINTDETECT.NUM_JOINTS)
    np.savetxt(os.path.join(output_dir, "frame_names.csv"),
               np.array(filenames), delimiter=",", fmt="%s")
    np.savetxt(os.path.join(output_dir, "points_HybridNet.csv"),
               np.array(points_net).reshape(-1, J * 3), delimiter=",")
    np.savetxt(os.path.join(output_dir, "points_GroundTruth.csv"),
               np.array(points_gt).reshape(-1, J * 3), delimiter=",")
    return output_dir
