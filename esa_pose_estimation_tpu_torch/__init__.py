"""esa_pose_estimation_tpu_torch — the PyTorch/CUDA port of the serving path.

The JAX package ``esa_pose_estimation_tpu`` is the reference; this package
reproduces its serving chain (frames -> square crop -> HRNet-W32+CBAM ->
peak decode -> RANSAC-EPnP + dual LM) in PyTorch, its experimental serving
levers (``experimental/``), the held-out evaluation and the utilization
experiments (``cli/``).  The three TPU kernels of the JAX package (peak
decode, fused CBAM, branch chain) are rewritten as CUDA C++ kernels for
Hopper (``csrc/``).

It imports torch and numpy only.  Public functions keep the JAX package's
layouts (frames ``(B, H, W)``, heatmaps ``(B, S, S, K)`` channels-last), so
the parity tests compare like with like.  Entry points follow the device of
their inputs; the weight loader places the model on ``cuda`` unless the
caller asks for the CPU.
"""

import torch

__version__ = "0.1.0"

# Geometry, crop and the f32 model compute in full float32, as the JAX
# package pins Precision.HIGHEST: no TF32 in f32 products or convolutions.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
