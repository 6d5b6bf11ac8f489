"""Multi-device training and inference on ``torch.distributed`` (port of
``jarvis_hybridnet_tpu/parallel/``): one process per GPU, the world laid
out as a (data, cameras) mesh of ranks (``mesh``), the pod loaders and
frame ranges (``multihost``), the collectives of the sharded steps
(``collectives``), and the sharded train and predict steps
(``train_step``, ``predict_step``)."""
