"""Interactive terminal menu (port of
``jarvis_hybridnet_tpu/ui/interactive_cli.py``; ``jarvis-torch launch-cli``).

Equivalent of the reference inquirer-based interactive CLI
(jarvis/ui/interactive_cli/cli.py:27 and siblings) built on plain
``input()`` so it needs no extra dependency. The menus, prompts and answers
are the JAX package's; every entry point runs on the ``device`` that
:func:`launch_interactive_prompt` is given (the command line's root
``--device``). Parity features:

* project / pretrain / weight pickers with path validation
  (reference train_cli.py:49-64, predict_cli.py:63-81)
* frame-range prompts bounded by the video's frame count
  (predict_cli.py:157-184)
* compiled-model reuse wizard — the exported-artifact analog of the
  reference's saved-TRT-engine prompts (predict_cli.py:193-229), over
  ``prediction/export.list_artifacts``
* visualize/analyze parameter menus incl. dataset sample viewers and
  prediction-run pickers (visualize_cli.py:39-258, analyze_cli.py:26-183)
* accelerator presence check (the reference's GPU check,
  train_cli.py:22-29)
"""

from __future__ import annotations

import os

from ..config.project_manager import ProjectManager
from ..utils import clp
from ..utils.param_classes import (
    CreateVideos2DParams,
    CreateVideos3DParams,
    Predict2DParams,
    Predict3DParams,
)
from ..utils.utils import get_available_pretrains, list_run_dirs


def _menu(title: str, options: list[str]) -> str | None:
    print(f"\n{title}")
    for i, opt in enumerate(options, 1):
        print(f"  {i}) {opt}")
    print("  q) back")
    while True:
        ans = input("> ").strip()
        if ans in ("q", "Q"):
            return None
        if ans.isdigit() and 1 <= int(ans) <= len(options):
            return options[int(ans) - 1]
        print("Please enter a valid option number.")


def _pick_project() -> str | None:
    projects = ProjectManager().get_projects()
    if not projects:
        clp.error("No projects found in the current parent directory.")
        return None
    return _menu("Select a project:", projects)


def _ask(prompt: str, default: str = "") -> str:
    raw = input(f"{prompt} [{default}]: ").strip()
    return raw or default


def _ask_int(prompt: str, default: int, lo=None, hi=None) -> int:
    while True:
        raw = _ask(prompt, str(default))
        try:
            v = int(raw)
        except ValueError:
            print("Please enter a number.")
            continue
        if (lo is not None and v < lo) or (hi is not None and v > hi):
            print(f"Value must be in [{lo}, {hi}].")
            continue
        return v


def _ask_path(prompt: str, must_exist: bool = True, suffix=None) -> str:
    while True:
        p = _ask(prompt)
        if not must_exist or (os.path.exists(p)
                              and (suffix is None or p.endswith(suffix))):
            return p
        print("Path does not exist" +
              (f" or is not a '{suffix}' file" if suffix else "") + ".")


def _check_devices(device: str) -> bool:
    """Accelerator presence check (the reference aborts without a GPU,
    train_cli.py:22-29): ``device`` 'cuda' needs a card; on the CPU a
    warning only."""
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        clp.error("No CUDA device available, aborting!")
        return False
    if torch.device(device).type == "cpu":
        clp.warning("Running on CPU — this will be slow. A GPU is "
                    "recommended.")
    return True


def _pick_weights_or_pretrain(parent_dir: str):
    """Pretrain picker + optional explicit weights path
    (reference get_project_and_pretrain, train_cli.py:49-64)."""
    pretrains = get_available_pretrains(parent_dir)
    weights = _menu("Select pretrain to be used:", ["None"] + pretrains)
    if weights in (None, "None"):
        if _menu("Specify weights to load before training?",
                 ["Yes", "No"]) == "Yes":
            return _ask_path("Path to '.pth'/'.ckpt' weights file",
                             suffix=(".pth", ".ckpt"))
        return None
    return weights


def _pick_model_weights(label: str) -> str:
    """'latest' vs explicit path (reference predict_cli.py:63-81)."""
    if _menu(f"Use most recently saved {label} weights?",
             ["Yes", "No"]) != "No":
        return "latest"
    return _ask_path(f"Path to {label} weights file",
                     suffix=(".pth", ".ckpt"))


def get_frame_start_number(video_path: str):
    """Frame-range prompts bounded by the recording's length
    (reference predict_cli.py:157-184)."""
    if _menu("Predict for the whole video?", ["Yes", "No"]) != "No":
        return 0, -1
    total = None
    probe = video_path
    if os.path.isdir(video_path):
        vids = [f for f in sorted(os.listdir(video_path))
                if f.split(".")[-1].lower() in ("mp4", "avi", "mov", "mkv")]
        probe = os.path.join(video_path, vids[0]) if vids else None
    if probe and os.path.isfile(probe):
        try:
            import cv2

            cap = cv2.VideoCapture(probe)
            total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            cap.release()
        except ImportError:
            total = None
    hint = f" (Max: {total})" if total else ""
    frame_start = _ask_int(f"Frame to start predictions at{hint}", 0,
                           lo=0, hi=(total - 1) if total else None)
    max_frames = (total - frame_start) if total else None
    hint = f" (Max: {max_frames})" if max_frames else ""
    number_frames = _ask_int(
        f"Number of frames to predict pose for, -1 = all{hint}", -1,
        lo=-1, hi=max_frames)
    return frame_start, number_frames


def get_compiled_mode(cfg, kind: str) -> str:
    """Compiled-model reuse wizard — exported artifacts play the role of
    the reference's saved TRT engines (predict_cli.py:193-229)."""
    if _menu("Use a saved compiled model (AOT artifact)?",
             ["Yes", "No"]) != "Yes":
        return "off"
    from ..prediction import export as aot

    # only artifacts exported under the CURRENT numerics config count: a
    # stale-numerics file would be skipped by the driver's exact-path
    # check anyway, so reporting it as reusable would silently fall back
    # to a freshly built predictor with default weights
    if not aot.list_artifacts(cfg, kind):
        print("No saved compiled model found — a new one will be exported.")
        return "new"
    if _menu("Use previously saved compiled model?", ["Yes", "No"]) != "No":
        return "previous"
    if _menu("This will override the old compiled model, are you sure?",
             ["Yes", "No"]) == "Yes":
        return "new"
    return "previous"


def launch_interactive_prompt(device: str = "cuda") -> None:
    print("Welcome to JARVIS (PyTorch / CUDA edition) interactive CLI!")
    while True:
        choice = _menu(
            "Main menu:",
            ["Create Project", "Train", "Predict", "Visualize", "Analyze"],
        )
        if choice is None:
            return
        if choice == "Create Project":
            name = _ask("Project name")
            d3d = _ask("3D dataset path")
            d2d = _ask("2D dataset path", d3d)
            if name and d2d:
                ProjectManager().create_new(name, d2d, d3d or None)
        elif choice == "Train":
            _train_menu(device)
        elif choice == "Predict":
            _predict_menu(device)
        elif choice == "Visualize":
            _visualize_menu(device)
        elif choice == "Analyze":
            _analyze_menu(device)


def _train_menu(device: str = "cuda"):
    from ..training import train_interface

    project = _pick_project()
    if project is None:
        return
    pm = ProjectManager()
    if not pm.load(project):
        clp.error(f"Could not load project {project}!")
        return
    cfg = pm.get_cfg()
    what = _menu("Train:", ["All", "CenterDetect", "KeypointDetect",
                            "HybridNet"])
    if what is None or not _check_devices(device):
        return
    if what == "All":
        ep_c = _ask_int("Epochs CenterDetect",
                        int(cfg.CENTERDETECT.NUM_EPOCHS), lo=1)
        ep_k = _ask_int("Epochs KeypointDetect",
                        int(cfg.KEYPOINTDETECT.NUM_EPOCHS), lo=1)
        ep_h = _ask_int("Epochs HybridNet",
                        int(cfg.HYBRIDNET.NUM_EPOCHS), lo=1)
        pretrain = _pick_weights_or_pretrain(pm.parent_dir)
        if not train_interface.train_efficienttrack(
                "CenterDetect", project, ep_c, pretrain, device=device):
            clp.error("CenterDetect training failed, aborting.")
            return
        if not train_interface.train_efficienttrack(
                "KeypointDetect", project, ep_k, pretrain, device=device):
            clp.error("KeypointDetect training failed, aborting.")
            return
        if not train_interface.train_hybridnet(project, ep_h, "latest",
                                               None, "3D_only", device=device):
            clp.error("HybridNet training did not complete.")
            return
        clp.success("Training finished! Your networks are ready for "
                    "prediction, have fun :)")
    elif what in ("CenterDetect", "KeypointDetect"):
        epochs = _ask_int("Number of epochs",
                          int(cfg[what.upper()].NUM_EPOCHS), lo=1)
        weights = _pick_weights_or_pretrain(pm.parent_dir)
        train_interface.train_efficienttrack(what, project, epochs, weights,
                                             device=device)
    else:
        mode = _menu("Training mode:", ["3D_only", "last_layers", "bifpn",
                                        "all"]) or "3D_only"
        epochs = _ask_int("Number of epochs",
                          int(cfg.HYBRIDNET.NUM_EPOCHS), lo=1)
        keypoint_weights = _pick_model_weights("KeypointDetect")
        finetune = _menu("Finetune (LR/10)?", ["No", "Yes"]) == "Yes"
        train_interface.train_hybridnet(project, epochs, keypoint_weights,
                                        None, mode, finetune=finetune,
                                        device=device)


def _predict_menu(device: str = "cuda"):
    project = _pick_project()
    if project is None:
        return
    pm = ProjectManager()
    if not pm.load(project):
        clp.error(f"Could not load project {project}!")
        return
    cfg = pm.get_cfg()
    what = _menu("Predict:", ["predict3D", "predict2D"])
    if what is None:
        return
    path = _ask_path("Recording path")
    frame_start, number_frames = get_frame_start_number(path)
    if what == "predict3D":
        from ..prediction.predict3d import predict3D

        params = Predict3DParams(project, path)
        params.trt_mode = get_compiled_mode(cfg, "predict3D")
        if params.trt_mode != "previous":
            params.weights_center_detect = _pick_model_weights(
                "CenterDetect")
            params.weights_hybridnet = _pick_model_weights("HybridNet")
        params.frame_start = frame_start
        params.number_frames = number_frames
        predict3D(params, device=device)
    else:
        from ..prediction.predict2d import predict2D

        params = Predict2DParams(project, path)
        params.trt_mode = get_compiled_mode(cfg, "predict2D")
        if params.trt_mode != "previous":
            params.weights_center_detect = _pick_model_weights(
                "CenterDetect")
            params.weights_keypoint_detect = _pick_model_weights(
                "KeypointDetect")
        params.frame_start = frame_start
        params.number_frames = number_frames
        predict2D(params, device=device)


def _pick_prediction_run(cfg, kind: str):
    """(run dir, csv path) picker over saved prediction runs
    (reference visualize_cli.py:152-258)."""
    base = os.path.join(cfg.PARENT_DIR, cfg.PROJECTS_ROOT_PATH,
                        cfg.PROJECT_NAME, "predictions",
                        f"predictions{kind}")
    runs = list_run_dirs(base)
    if not runs:
        clp.error(f"No predictions created yet. Run Predict{kind} first!")
        return None, None
    run = _menu("Select prediction run:", runs)
    if run is None:
        return None, None
    run_dir = os.path.join(base, run)
    csvs = sorted(f for f in os.listdir(run_dir) if f.endswith(".csv"))
    if not csvs:
        clp.error("No CSVs in that prediction run.")
        return None, None
    csv_name = csvs[0] if len(csvs) == 1 else _menu("Select CSV:", csvs)
    if csv_name is None:
        return None, None
    return run_dir, os.path.join(run_dir, csv_name)


def _visualize_menu(device: str = "cuda"):
    project = _pick_project()
    if project is None:
        return
    pm = ProjectManager()
    if not pm.load(project):
        return
    cfg = pm.get_cfg()
    what = _menu("Visualize:", ["Create Videos 3D", "Create Videos 2D",
                                "Visualize Dataset2D",
                                "Visualize Dataset3D"])
    if what is None:
        return
    if what.startswith("Create"):
        kind = "3D" if "3D" in what else "2D"
        run_dir, data_csv = _pick_prediction_run(cfg, kind)
        if run_dir is None:
            return
        import yaml

        with open(os.path.join(run_dir, "info.yaml")) as f:
            info = yaml.safe_load(f)
        if kind == "3D":
            from ..visualization.create_videos3d import create_videos3D

            params = CreateVideos3DParams(project, info["recording_path"],
                                          data_csv)
            # multi-session projects: reproject with the calibration rig
            # the prediction ran with, not an arbitrary first one
            params.dataset_name = info.get("dataset_name")
            params.frame_start = info.get("frame_start", 0)
            params.number_frames = info.get("number_frames", -1)
            create_videos3D(params, device=device)
        else:
            from ..visualization.create_videos2d import create_videos2D

            params = CreateVideos2DParams(project, info["recording_path"],
                                          data_csv)
            params.frame_start = info.get("frame_start", 0)
            params.number_frames = info.get("number_frames", -1)
            create_videos2D(params)
        return

    split = ("train" if _menu("Load training or validation set?",
                              ["Training", "Validation"]) == "Training"
             else "val")
    from ..visualization import visualize_dataset as vd

    if what.endswith("2D"):
        mode = _menu("Select mode:", ["CenterDetect", "KeypointDetect"]) \
            or "CenterDetect"
        from ..dataset.dataset2d import Dataset2D

        ds = Dataset2D(cfg, set=split, mode=mode)
        if len(ds) == 0:
            clp.error(f"The {split} split has no samples.")
            return
        n = _ask_int("How many samples to show", min(5, len(ds)),
                     lo=1, hi=len(ds))
        import matplotlib.pyplot as plt

        for idx in range(n):
            vd.visualize_2D_sample(ds, mode, idx)
            plt.show()
    else:
        from ..dataset.dataset3d import Dataset3D

        ds = Dataset3D(cfg, set=split)
        if len(ds) == 0:
            clp.error(f"The {split} split has no samples.")
            return
        n = _ask_int("How many samples to show", min(5, len(ds)),
                     lo=1, hi=len(ds))
        import matplotlib.pyplot as plt

        for idx in range(n):
            vd.visualize_3D_sample(ds, idx)
            plt.show()


def _pick_cameras_subset(cfg):
    """Optional camera subset for analysis (reference
    interactive_cli/analyze_cli.py:71-88 lists calib_params/<session>/)."""
    if _menu("Use only a subset of available cameras?",
             ["No", "Yes"]) != "Yes":
        return None
    from ..utils.calibration import discover_camera_names

    names = discover_camera_names(cfg)
    if not names:
        clp.warning("Could not list calibration cameras; using all.")
        return None
    chosen = []
    for name in names:
        answer = _menu(f"Use camera {name}?", ["Yes", "No"])
        if answer is None:  # 'q' aborts the picker, not "select this one"
            clp.warning("Camera selection aborted; using all cameras.")
            return None
        if answer == "Yes":
            chosen.append(name)
    if not chosen:
        # An explicit everything-deselected answer must not silently
        # invert into "all cameras" (the GUI errors here too).
        clp.warning("No cameras selected; using all cameras instead.")
        return None
    return chosen


def _pick_analysis_run(cfg):
    """Analysis-run picker over saved validation analyses (reference
    interactive_cli/analyze_cli.py:97-112)."""
    base = os.path.join(cfg.PARENT_DIR, cfg.PROJECTS_ROOT_PATH,
                        cfg.PROJECT_NAME, "analysis")
    runs = list_run_dirs(base)
    if not runs:
        clp.error("Please run Analysis on this project first! Aborting...")
        return None
    run = _menu("Select analysis set to load:", runs)
    return os.path.join(base, run) if run else None


def _ask_additional_data() -> dict:
    """Extra prediction CSVs overlaid on the histogram (reference
    interactive_cli/analyze_cli.py:133-145)."""
    additional = {}
    while _menu("Add another '.csv' file containing predictions?",
                ["No", "Yes"]) == "Yes":
        data_path = _ask_path("Path to prediction '.csv' file",
                              suffix=".csv")
        pred_name = _ask("Name of the predictions for the legend",
                         os.path.basename(data_path))
        additional[pred_name] = data_path
    return additional


def _ask_cutoff() -> int:
    if _menu("Use error cutoff? (values above it are grouped in one bin)",
             ["No", "Yes"]) != "Yes":
        return -1
    return _ask_int("Cutoff value (mm)", 30, lo=1)


def _ask_interactive() -> bool:
    return _menu("Show interactive matplotlib window?",
                 ["Yes", "No"]) != "No"


def _analyze_menu(device: str = "cuda"):
    project = _pick_project()
    if project is None:
        return
    pm = ProjectManager()
    if not pm.load(project):
        clp.error(f"Could not load project {project}!")
        return
    cfg = pm.get_cfg()
    what = _menu("Analyze:", [
        "analyze-validation-data", "plot-error-histogram",
        "plot-error-per-keypoint", "plot-error-histogram-per-keypoint"])
    if what is None:
        return
    if what == "analyze-validation-data":
        weights_center = _pick_model_weights("CenterDetect")
        weights_hybridnet = _pick_model_weights("HybridNet")
        cameras_to_use = _pick_cameras_subset(cfg)
        from ..analysis.analyze import analyze_validation_data

        out = analyze_validation_data(
            project, weights_center=weights_center,
            weights_hybridnet=weights_hybridnet,
            cameras_to_use=cameras_to_use, device=device)
        if out:
            clp.success(f"Analysis written to {out}")
        return

    path = _pick_analysis_run(cfg)
    if path is None:
        return
    from ..analysis import plotting

    if what == "plot-error-histogram":
        additional = _ask_additional_data()
        cutoff = _ask_cutoff()
        plotting.plot_error_histogram(
            path, additional_data=additional, cutoff=cutoff,
            interactive=_ask_interactive())
    elif what == "plot-error-per-keypoint":
        plotting.plot_error_per_keypoint(
            path, project, interactive=_ask_interactive())
    else:
        cutoff = _ask_cutoff()
        plotting.plot_error_histogram_per_keypoint(
            path, project, cutoff=cutoff, interactive=_ask_interactive())
