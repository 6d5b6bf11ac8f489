"""Default configuration tree.

A copy of ``jarvis_hybridnet_tpu/config/defaults.py`` (same keys, same
values), so that a project ``config.yaml`` means the same to both packages.
The ``TPU`` section keeps its name: the port reads ``TPU.INFERENCE_DTYPE``
and ``TPU.REPRO_MODE`` from it as the JAX package does.
"""

from .cfg_node import CfgNode


def get_default_cfg() -> CfgNode:
    c = CfgNode()

    # General
    c.PROJECTS_ROOT_PATH = "projects"
    c.PROJECT_NAME = None
    c.DATALOADER_NUM_WORKERS = 8
    # 'process' (forked workers, the torch DataLoader analog: no GIL
    # against the consumer, augmentation scales with cores — measured
    # 2.9x faster end-to-end even on one core, BASELINE.md training
    # table), 'thread' (GIL-releasing decode parallelism only; fallback
    # where fork is unavailable/unsafe), or 'forkserver'/'spawn'
    # (clean-child processes, no copy-on-write dataset inheritance; for
    # datasets that violate the workers-never-touch-JAX invariant — see
    # docs/troubleshooting.md "os.fork() warnings").
    c.DATALOADER_WORKER_MODE = "process"
    # 'auto' | 'on' | 'off': cache the deterministic pre-augmentation part
    # of every training sample (decoded/resized/cropped uint8) in RAM once,
    # so epochs 2..N skip JPEG decode entirely; 'auto' preloads when the
    # cache fits in half the available RAM (loader.maybe_preload)
    c.DATALOADER_PRELOAD = "auto"
    c.PARENT_DIR = ""

    c.KEYPOINT_NAMES = []
    c.SKELETON = []

    # Dataset (reference: jarvis/config/config.py:23-31)
    c.DATASET = CfgNode()
    c.DATASET.DATASET_ROOT_DIR = "datasets"
    c.DATASET.DATASET_2D = None
    c.DATASET.DATASET_3D = None
    c.DATASET.TRAIN_SET = "train"
    c.DATASET.VAL_SET = "val"
    c.DATASET.MEAN = [0.485, 0.456, 0.406]
    c.DATASET.STD = [0.229, 0.224, 0.225]
    c.DATASET.IMG_SIZE = None
    c.DATASET.IMAGE_SIZE = None  # [width, height], filled from data

    # CenterDetect (reference: :35-45)
    c.CENTERDETECT = CfgNode()
    c.CENTERDETECT.IMAGE_SIZE = 320
    c.CENTERDETECT.MODEL_SIZE = "medium"
    c.CENTERDETECT.NUM_JOINTS = 1
    c.CENTERDETECT.BATCH_SIZE = 4
    c.CENTERDETECT.OPTIMIZER = "adamw"
    c.CENTERDETECT.USE_ONECYLCLE = True  # (sic) name kept for compatibility
    c.CENTERDETECT.MAX_LEARNING_RATE = 0.003
    c.CENTERDETECT.NUM_EPOCHS = 50
    c.CENTERDETECT.CHECKPOINT_SAVE_INTERVAL = 10
    c.CENTERDETECT.VAL_INTERVAL = 1

    # KeypointDetect (reference: :48-58)
    c.KEYPOINTDETECT = CfgNode()
    c.KEYPOINTDETECT.MODEL_SIZE = "medium"
    c.KEYPOINTDETECT.NUM_JOINTS = 0
    c.KEYPOINTDETECT.BOUNDING_BOX_SIZE = 320
    c.KEYPOINTDETECT.BATCH_SIZE = 4
    c.KEYPOINTDETECT.OPTIMIZER = "adamw"
    c.KEYPOINTDETECT.USE_ONECYLCLE = True
    c.KEYPOINTDETECT.MAX_LEARNING_RATE = 0.003
    c.KEYPOINTDETECT.NUM_EPOCHS = 100
    c.KEYPOINTDETECT.CHECKPOINT_SAVE_INTERVAL = 10
    c.KEYPOINTDETECT.VAL_INTERVAL = 1

    # Augmentation (reference: :60-84)
    c.AUGMENTATION = CfgNode()
    c.AUGMENTATION.COLOR_MANIPULATION = CfgNode()
    cm = c.AUGMENTATION.COLOR_MANIPULATION
    cm.ENABLED = True
    cm.GAUSSIAN_BLUR = CfgNode()
    cm.GAUSSIAN_BLUR.PROBABILITY = 0.25
    cm.GAUSSIAN_BLUR.SIGMA = [0, 0.5]
    cm.GAUSSIAN_NOISE = CfgNode()
    cm.GAUSSIAN_NOISE.PER_CHANNEL_PROBABILITY = 0.25
    cm.GAUSSIAN_NOISE.SCALE = [0.0, 0.02]
    cm.LINEAR_CONTRAST = CfgNode()
    cm.LINEAR_CONTRAST.PROBABILITY = 0.25
    cm.LINEAR_CONTRAST.SCALE = [0.8, 1.2]
    cm.MULTIPLY = CfgNode()
    cm.MULTIPLY.PROBABILITY = 0.25
    cm.MULTIPLY.SCALE = [0.8, 1.2]
    cm.PER_CHANNEL_MULTIPLY = CfgNode()
    cm.PER_CHANNEL_MULTIPLY.PROBABILITY = 0.25
    cm.PER_CHANNEL_MULTIPLY.PER_CHANNEL_PROBABILITY = 0.3
    cm.PER_CHANNEL_MULTIPLY.SCALE = [0.8, 1.2]
    c.AUGMENTATION.MIRROR = CfgNode()
    c.AUGMENTATION.MIRROR.PROBABILITY = 0.0
    c.AUGMENTATION.AFFINE_TRANSFORM = CfgNode()
    c.AUGMENTATION.AFFINE_TRANSFORM.PROBABILITY = 0.5
    c.AUGMENTATION.AFFINE_TRANSFORM.ROTATION_RANGE = [-45, 45]
    c.AUGMENTATION.AFFINE_TRANSFORM.SCALE_RANGE = [0.8, 1.2]

    # HybridNet (reference: :88-99). BATCH_SIZE default of 1 matches the
    # reference config, but unlike the reference (repro_layer.py:113 processes
    # only batch element 0) the TPU implementation is fully batched: the
    # measured device-only sweep (BASELINE.md "3D train-step batch sweep")
    # peaks at B=8 with 3.0x the B=1 per-chip sample rate — after round 5's
    # ROI decode + on-device aug the loader feeds B=8 from ~1.5 cores
    # (24.9 ms/sample, BASELINE.md host split), so most hosts can set 8;
    # B=1 stays the default because it reproduces the reference's LR
    # schedule and steps/epoch exactly.
    c.HYBRIDNET = CfgNode()
    c.HYBRIDNET.NUM_CAMERAS = 0
    c.HYBRIDNET.ROI_CUBE_SIZE = None
    c.HYBRIDNET.GRID_SPACING = None
    c.HYBRIDNET.USE_ONECYLCLE = True
    c.HYBRIDNET.BATCH_SIZE = 1
    c.HYBRIDNET.OPTIMIZER = "adamw"
    c.HYBRIDNET.MAX_LEARNING_RATE = 0.003
    c.HYBRIDNET.NUM_EPOCHS = 30
    c.HYBRIDNET.CHECKPOINT_SAVE_INTERVAL = 10
    c.HYBRIDNET.VAL_INTERVAL = 1

    # TPU-specific (new capability, no reference equivalent)
    c.TPU = CfgNode()
    c.TPU.INFERENCE_DTYPE = "bfloat16"  # compute dtype on the inference path
    c.TPU.TRAIN_DTYPE = "float32"
    # run color augmentation inside the jitted 3D train step (the host
    # samples only per-image parameters; ops/augment.py) — removes the
    # largest GIL-held host cost of the sample build (34.2 ms = 33%,
    # BASELINE.md host split) from the loader's critical path
    c.TPU.DEVICE_AUG = True
    c.TPU.MESH_DATA_AXIS = -1  # -1: all devices on the data axis
    c.TPU.MESH_CAMERA_AXIS = 1
    c.TPU.COMPILE_CACHE = "on"  # persistent XLA compilation cache
    c.TPU.FRAME_BATCH = 8  # frames batched across time for streaming predict
    # 'quarter_fused' (default): gather heatmap samples at the quarter
    # voxel grid (64x fewer scattered reads than 'exact'), interpolate the
    # values up to the half grid, and fold the final 2x upsample into
    # V2V's stride-2 front conv — ~10x faster end-to-end than 'exact'
    # with 0.005 mm measured deviation (bench.py --fidelity).
    # 'half_fused' gathers at the half grid (8x fewer reads, 0.002 mm);
    # 'half' keeps the explicit value upsample; 'exact' replicates the
    # reference repro numerics bit-carefully for parity work.
    c.TPU.REPRO_MODE = "quarter_fused"
    # when set, prediction drivers capture a jax.profiler trace here
    # (new observability capability; the reference has none, SURVEY.md §5)
    c.TPU.PROFILE_DIR = None
    # two-phase streaming predict3D: CenterDetect consumes a LOWRES_FACTOR-
    # downscaled frame ring (produced by the same decode pass) and only the
    # detected bbox crops ship to the device at full resolution — ~9x less
    # host->device traffic on bandwidth-limited links
    c.TPU.TWO_PHASE = False
    c.TPU.LOWRES_FACTOR = 4
    # shard the camera axis of predict3D over this many chips (the repro
    # camera-mean becomes an ICI reduction); 1 = data-parallel only
    c.TPU.SHARD_CAMERAS = 1
    # video decode backend for the prediction drivers: None = auto (native
    # C++ libav pipeline when built, else cv2), or force 'native' / 'cv2'
    c.TPU.DECODE_BACKEND = None

    return c
