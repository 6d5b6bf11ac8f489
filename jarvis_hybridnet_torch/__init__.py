"""PyTorch / CUDA port of the JARVIS-HybridNet predict3D cascade.

Runs beside the JAX package ``jarvis_hybridnet_tpu`` and imports nothing of
it. Entry point: ``prediction.loaders.make_predictor3d``. The hand-written
Hopper kernels live in ``kernels/``; each wrapper launches its CUDA kernel on
a CUDA tensor and runs its plain PyTorch version on a CPU tensor.
"""
