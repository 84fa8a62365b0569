"""The benchmark's plain reference: a frozen copy of the modules of
``satellite_pose_estimation_tpu_torch`` that the benchmark's cells run
(the DETR and RT-DETR models, the train step, the augmentation, the
solvers, the criterion, the optimizers), cut to what those cells drive:
every hand-written kernel route, int8 path and multi-device form is taken
out, so that each function computes on one device through its plain
PyTorch version. It imports nothing of the program and neither ``jax`` nor
the JAX package; the benchmark computes it in float32 with TF32 off and
holds the program's outputs against it. Later changes to the program do
not reach it.
"""
