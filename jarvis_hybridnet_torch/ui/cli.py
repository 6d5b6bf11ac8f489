"""The ``jarvis-torch`` command line: the port's counterpart of the JAX
package's ``jarvis`` command (``jarvis_hybridnet_tpu/ui/cli.py``; reference
click CLI, jarvis/ui/jarvis.py:33-117, jarvis/ui/cli/*.py).

The same command tree, names, arguments, options, defaults and choices:
``create-project``, ``train centerDetect|keypointDetect|hybridNet|all``,
``predict predict2D|predict3D``, ``visualize create-videos3D|
create-videos2D|plot-time-slices``, ``analyze analyze-validation-data|
plot-error-histogram|plot-error-per-keypoint|
plot-error-histogram-per-keypoint``, ``launch-cli`` and ``launch``, with
command names resolved case-insensitively. The root group adds one option,
``--device`` (default ``cuda``), which every entry point that runs on a
device receives: ``jarvis-torch --device cpu predict predict3D P rec/``
runs on the CPU. With ``--device cuda`` and no card the entry point raises;
nothing carries on on the CPU.

Not ported yet, each raising with its ROADMAP.md item: ``launch-cli`` (the
interactive CLI), ``launch`` (the Streamlit GUI) and ``--trt_mode new`` /
``previous`` (the predict drivers raise, ``prediction/predict2d.py``).

Run it as ``jarvis-torch ...`` once the package is installed, or as
``python3 -m jarvis_hybridnet_torch.ui.cli ...``. yaml and the modules of
each command are imported when the command runs.
"""

from __future__ import annotations

import collections
import os

import click

from ..config.project_manager import ProjectManager
from ..utils import clp
from ..utils.param_classes import (
    CreateVideos2DParams,
    CreateVideos3DParams,
    Predict2DParams,
    Predict3DParams,
)
from ..utils.utils import latest_run_dir


class OrderedGroup(click.Group):
    """Group preserving declaration order, resolving names
    case-insensitively: the reference documents camelCase commands
    (``jarvis predict predict2D``) but click >= 8 lowercases undeclared
    command names, so users arrive with either spelling."""

    def __init__(self, name=None, commands=None, **attrs):
        super().__init__(name, commands, **attrs)
        self.commands = commands or collections.OrderedDict()

    def list_commands(self, ctx):
        return self.commands

    def get_command(self, ctx, cmd_name):
        cmd = super().get_command(ctx, cmd_name)
        if cmd is not None:
            return cmd
        folded = cmd_name.lower()
        for name in self.commands:
            if name.lower() == folded:
                return super().get_command(ctx, name)
        return None


def _device() -> str:
    """The root group's ``--device``."""
    return click.get_current_context().find_root().params["device"]


def _not_ported(what: str, item: str):
    raise click.ClickException(f"{what} is not ported to the PyTorch package yet "
                               f"(ROADMAP.md {item}); use the JAX package's 'jarvis'.")


@click.group(cls=OrderedGroup)
@click.option("--device", default="cuda", show_default=True,
              help="Device the networks run on: 'cuda' (the card) or 'cpu'.")
def cli(device):
    """
    Welcome to JARVIS (PyTorch / CUDA edition)! The standard CLI: see this
    help for all available commands. Every command that runs a network runs
    it on --device.
    """


@cli.command()
def launch():
    """Launch the Streamlit GUI in your browser (not ported yet)."""
    _not_ported("The Streamlit GUI ('launch')", "A.13")


@cli.command(name="launch-cli")
def launch_cli():
    """Launch the interactive CLI in this terminal (not ported yet)."""
    _not_ported("The interactive CLI ('launch-cli')", "A.13")


@cli.command(name="create-project")
@click.option("--dataset2d", default="", type=click.Path(file_okay=False))
@click.option("--dataset3d", default="", type=click.Path(file_okay=False))
@click.argument("project_name")
def create_project(project_name, dataset2d, dataset3d):
    """Create and configure a new project for your dataset."""
    if dataset3d == "" and dataset2d == "":
        clp.error("Specify at least one dataset to create a project. Aborting...")
        return
    if dataset3d == "":
        print("[Info] You have not specified a 3D-dataset, you will not be "
              "able to train the full 3D network!")
    if dataset2d == "":
        dataset2d = dataset3d
    ProjectManager().create_new(
        name=project_name,
        dataset2D_path=dataset2d,
        dataset3D_path=dataset3d or None,
    )


# ---------------------------------------------------------------- train ---
@cli.group(cls=OrderedGroup)
def train():
    """Training commands, more info: 'jarvis-torch train --help'."""


def _resolve_train_weights(weights_path, pretrained_weights):
    if weights_path is not None:
        return weights_path
    if pretrained_weights != "None":
        return pretrained_weights
    return None


@train.command(name="centerDetect")
@click.option("--num_epochs", default=None, type=click.IntRange(min=1))
@click.option("--weights_path", default=None,
              help="Path to a specific checkpoint to load before training.")
@click.option("--pretrained_weights", default="None",
              help="Named pretrain ('EcoSet' or a pose pretrain).")
@click.option("--resume", default=None,
              help="Resume a full train state (path to train_state.ckpt or "
              "'latest'), e.g. after a preemption.")
@click.argument("project_name")
def train_center_detect(project_name, num_epochs, weights_path, pretrained_weights, resume):
    """Train only the centerDetect network."""
    from ..training import train_interface

    train_interface.train_efficienttrack(
        "CenterDetect", project_name, num_epochs,
        _resolve_train_weights(weights_path, pretrained_weights),
        resume=resume, device=_device())


@train.command(name="keypointDetect")
@click.option("--num_epochs", default=None, type=click.IntRange(min=1))
@click.option("--weights_path", default=None)
@click.option("--pretrained_weights", default="None")
@click.option("--resume", default=None,
              help="Resume a full train state (path to train_state.ckpt or "
              "'latest'), e.g. after a preemption.")
@click.argument("project_name")
def train_keypoint_detect(project_name, num_epochs, weights_path, pretrained_weights, resume):
    """Train only the keypointDetect network."""
    from ..training import train_interface

    train_interface.train_efficienttrack(
        "KeypointDetect", project_name, num_epochs,
        _resolve_train_weights(weights_path, pretrained_weights),
        resume=resume, device=_device())


@train.command(name="hybridNet")
@click.option("--num_epochs", default=None, type=click.IntRange(min=1))
@click.option("--weights_hybridnet", default=None)
@click.option("--weights_keypoint_detect", default=None)
@click.option("--mode", default="3D_only",
              type=click.Choice(["3D_only", "last_layers", "bifpn", "all"],
                                case_sensitive=False))
@click.option("--resume", default=None,
              help="Resume a full train state (path to train_state.ckpt or "
              "'latest'), e.g. after a preemption.")
@click.argument("project_name")
def train_hybridnet(project_name, num_epochs, weights_keypoint_detect, weights_hybridnet, mode,
                    resume):
    """Train the full HybridNet using trained keypointDetect weights."""
    from ..training import train_interface

    train_interface.train_hybridnet(
        project_name, num_epochs, weights_keypoint_detect, weights_hybridnet,
        mode, finetune=(mode != "3D_only"), resume=resume, device=_device())


@train.command(name="all")
@click.option("--num_epochs_center", default=None, type=click.IntRange(min=1))
@click.option("--num_epochs_keypoint", default=None, type=click.IntRange(min=1))
@click.option("--num_epochs_hybridnet", default=None, type=click.IntRange(min=1))
@click.option("--pretrain", default="None")
@click.argument("project_name")
def train_all(project_name, num_epochs_center, num_epochs_keypoint, num_epochs_hybridnet,
              pretrain):
    """Train the full network stack from scratch."""
    from ..training import train_interface

    device = _device()
    click.echo("First training CenterDetect...")
    if not train_interface.train_efficienttrack(
            "CenterDetect", project_name, num_epochs_center,
            pretrain if pretrain != "None" else None, device=device):
        return
    click.echo("Training KeypointDetect...")
    if not train_interface.train_efficienttrack(
            "KeypointDetect", project_name, num_epochs_keypoint,
            pretrain if pretrain != "None" else None, device=device):
        return
    click.echo("Training 3D section of HybridNet...")
    if not train_interface.train_hybridnet(
            project_name, num_epochs_hybridnet, "latest", None, "3D_only", device=device):
        clp.error("HybridNet training did not complete (preempted or failed).")
        return
    clp.success("Training finished! Your networks are ready for prediction, have fun :)")


# -------------------------------------------------------------- predict ---
@cli.group(cls=OrderedGroup)
def predict():
    """Prediction commands, more info: 'jarvis-torch predict --help'."""


@predict.command(name="predict2D")
@click.option("--weights_center_detect", default="latest")
@click.option("--weights_keypoint_detect", default="latest")
@click.option("--frame_start", default=0)
@click.option("--number_frames", default=-1)
@click.option("--trt_mode", default="off",
              type=click.Choice(["off", "new", "previous"]),
              help="Compiled-predictor mode; only 'off' is ported (ROADMAP.md A.13).")
@click.argument("project_name")
@click.argument("video_path")
def predict2d_cmd(project_name, video_path, weights_center_detect, weights_keypoint_detect,
                  frame_start, number_frames, trt_mode):
    """Predict 2D poses on a single video."""
    from ..prediction.predict2d import predict2D

    params = Predict2DParams(project_name, video_path)
    params.weights_center_detect = weights_center_detect
    params.weights_keypoint_detect = weights_keypoint_detect
    params.frame_start = frame_start
    params.number_frames = number_frames
    params.trt_mode = trt_mode
    predict2D(params, device=_device())


@predict.command(name="predict3D")
@click.option("--weights_center_detect", default="latest")
@click.option("--weights_hybridnet", default="latest")
@click.option("--frame_start", default=0)
@click.option("--number_frames", default=-1)
@click.option("--dataset_name", default=None)
@click.option("--trt_mode", default="off",
              type=click.Choice(["off", "new", "previous"]))
@click.argument("project_name")
@click.argument("recording_path")
def predict3d_cmd(project_name, recording_path, weights_center_detect, weights_hybridnet,
                  frame_start, number_frames, dataset_name, trt_mode):
    """Predict 3D poses on a multi-camera recording."""
    from ..prediction.predict3d import predict3D

    params = Predict3DParams(project_name, recording_path)
    params.weights_center_detect = weights_center_detect
    params.weights_hybridnet = weights_hybridnet
    params.frame_start = frame_start
    params.number_frames = number_frames
    params.dataset_name = dataset_name
    params.trt_mode = trt_mode
    predict3D(params, device=_device())


# ------------------------------------------------------------ visualize ---
@cli.group(cls=OrderedGroup)
def visualize():
    """Visualize commands, more info: 'jarvis-torch visualize --help'."""


def _latest_run(project_name, sub, missing):
    """Newest run directory under ``projects/<p>/<sub>``, or None (with
    ``missing`` logged)."""
    pm = ProjectManager()
    if not pm.load(project_name):
        return None
    cfg = pm.get_cfg()
    latest = latest_run_dir(os.path.join(pm.parent_dir, cfg.PROJECTS_ROOT_PATH, project_name,
                                         *sub))
    if latest is None:
        clp.error(missing)
    return latest


def _prediction_info(project_name, prediction_path, kind, data_csv):
    """(run directory, its info.yaml) of a prediction run ('latest': the
    newest of ``kind``), or None with the error logged."""
    import yaml

    if prediction_path == "latest":
        prediction_path = _latest_run(project_name, ("predictions", kind),
                                      "No predictions found! Aborting...")
        if prediction_path is None:
            return None
    if not os.path.exists(os.path.join(prediction_path, data_csv)):
        clp.error("DataCSV does not exist! Aborting...")
        return None
    with open(os.path.join(prediction_path, "info.yaml")) as f:
        return prediction_path, yaml.safe_load(f)


@visualize.command(name="create-videos3D")
@click.option("--prediction_path", default="latest")
@click.option("--data_csv", default="data3D.csv")
@click.argument("project_name")
def create_videos3d_cmd(project_name, prediction_path, data_csv):
    """Create videos overlayed with 3D poses for a recording."""
    from ..visualization.create_videos3d import create_videos3D

    found = _prediction_info(project_name, prediction_path, "predictions3D", data_csv)
    if found is None:
        return
    prediction_path, info = found
    params = CreateVideos3DParams(project_name, info["recording_path"],
                                  os.path.join(prediction_path, data_csv))
    params.dataset_name = info.get("dataset_name")
    params.frame_start = info["frame_start"]
    params.number_frames = info["number_frames"]
    params.video_cam_list = [v.split(".")[0] for v in os.listdir(params.recording_path)]
    create_videos3D(params, device=_device())


@visualize.command(name="create-videos2D")
@click.option("--prediction_path", default="latest")
@click.option("--data_csv", default="data2D.csv")
@click.argument("project_name")
def create_videos2d_cmd(project_name, prediction_path, data_csv):
    """Create a video overlayed with predicted 2D poses."""
    from ..visualization.create_videos2d import create_videos2D

    found = _prediction_info(project_name, prediction_path, "predictions2D", data_csv)
    if found is None:
        return
    prediction_path, info = found
    params = CreateVideos2DParams(project_name, info["recording_path"],
                                  os.path.join(prediction_path, data_csv))
    params.frame_start = info["frame_start"]
    params.number_frames = info["number_frames"]
    create_videos2D(params)


@visualize.command(name="plot-time-slices")
@click.option("--start_frame", default=0)
@click.option("--num_frames", default=10)
@click.option("--skip_number", default=1)
@click.option("--plot_azim", default=None, type=float)
@click.option("--plot_elev", default=None, type=float)
@click.argument("csv_file")
@click.argument("filename")
def plot_time_slices(csv_file, filename, start_frame, num_frames, skip_number, plot_azim,
                     plot_elev):
    """Render a row of 3D poses sampled over time."""
    from ..visualization.time_slices import plot_slices

    plot_slices(csv_file, filename, start_frame, num_frames, skip_number,
                plot_azim=plot_azim, plot_elev=plot_elev)


# -------------------------------------------------------------- analyze ---
@cli.group(cls=OrderedGroup)
def analyze():
    """Analysis commands, more info: 'jarvis-torch analyze --help'."""


def _analysis_path(project_name, analysis_path):
    if analysis_path != "latest":
        return analysis_path
    return _latest_run(project_name, ("analysis",), "No analysis results found! Aborting...")


@analyze.command(name="analyze-validation-data")
@click.option("--weights_center_detect", default="latest")
@click.option("--weights_hybridnet", default="latest")
@click.argument("project_name")
def analyze_validation_data_cmd(project_name, weights_center_detect, weights_hybridnet):
    """Analyse the validation data of your project's dataset."""
    from ..analysis.analyze import analyze_validation_data

    analyze_validation_data(project_name, weights_center_detect, weights_hybridnet, None,
                            device=_device())


@analyze.command(name="plot-error-histogram")
@click.option("--analysis_path", default="latest")
@click.option("--cutoff", default=-1)
@click.option("--mode", default="interactive",
              type=click.Choice(["interactive", "headless"]))
@click.argument("project_name")
def plot_error_histogram_cmd(project_name, analysis_path, cutoff, mode):
    """Euclidean error across keypoints and time."""
    from ..analysis.plotting import plot_error_histogram

    analysis_path = _analysis_path(project_name, analysis_path)
    if analysis_path is None:
        return
    plot_error_histogram(analysis_path, cutoff=cutoff, interactive=(mode == "interactive"))


@analyze.command(name="plot-error-per-keypoint")
@click.option("--analysis_path", default="latest")
@click.option("--mode", default="interactive",
              type=click.Choice(["interactive", "headless"]))
@click.argument("project_name")
def plot_error_per_keypoint_cmd(project_name, analysis_path, mode):
    """Mean euclidean error per keypoint."""
    from ..analysis.plotting import plot_error_per_keypoint

    analysis_path = _analysis_path(project_name, analysis_path)
    if analysis_path is None:
        return
    plot_error_per_keypoint(analysis_path, project_name, interactive=(mode == "interactive"))


@analyze.command(name="plot-error-histogram-per-keypoint")
@click.option("--analysis_path", default="latest")
@click.option("--cutoff", default=-1)
@click.option("--mode", default="interactive",
              type=click.Choice(["interactive", "headless"]))
@click.argument("project_name")
def plot_error_histogram_per_keypoint_cmd(project_name, analysis_path, cutoff, mode):
    """Per-keypoint error histograms."""
    from ..analysis.plotting import plot_error_histogram_per_keypoint

    analysis_path = _analysis_path(project_name, analysis_path)
    if analysis_path is None:
        return
    plot_error_histogram_per_keypoint(analysis_path, project_name, cutoff=cutoff,
                                      interactive=(mode == "interactive"))


if __name__ == "__main__":
    cli()
