"""PyTorch / CUDA port of the JARVIS-HybridNet prediction cascades and of
their training.

Runs beside the JAX package ``jarvis_hybridnet_tpu`` and imports nothing of
it. Entry points: ``prediction.loaders`` (``make_predictor3d``,
``make_predictor3d_twophase``, ``make_predictor2d``) and the video -> CSV
drivers ``prediction.predict3d.predict3D`` and
``prediction.predict2d.predict2D``; ``training.train_interface.train_hybridnet``
(every freeze mode) and ``train_efficienttrack``. Under ``torchrun`` (one
process per GPU) the trainers and drivers shard their work over a
(data, cameras) mesh of ranks (``parallel/``). The hand-written Hopper
kernels live in ``kernels/``; each wrapper launches its CUDA kernel on a CUDA
tensor and runs its plain PyTorch version on a CPU tensor.
"""
