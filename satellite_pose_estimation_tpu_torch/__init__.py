"""satellite_pose_estimation_tpu_torch: the PyTorch / CUDA port of
``satellite_pose_estimation_tpu`` for NVIDIA Hopper GPUs.

The JAX package stays the reference; every module here sits at the same
relative path as its JAX counterpart and is held against it by the
``tests/test_torch_*.py`` parity tests. This package imports ``torch`` and
never ``jax``.

Ported so far: the R1 DETR and R2 RT-DETR eval and train steps
(``train.steps``), int8 static PTQ, and the host pipeline with the two
CLIs (``tools.main`` for R1, ``tools.train`` for R2, both over
``train.solver.SpeedSolver``). Each TPU kernel of the JAX package is a
hand-written CUDA kernel (``csrc/``) on the GPU, beside a plain PyTorch
version that the CPU takes. ROADMAP.md lists what is left.
"""

__version__ = "0.1.0"
