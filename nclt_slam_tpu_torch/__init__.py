"""nclt_slam_tpu_torch — the PyTorch + CUDA port of nclt_slam_tpu.

A second package beside the JAX one, module for module
(``nclt_slam_tpu_torch/planning/wavefront.py`` ↔
``nclt_slam_tpu/planning/wavefront.py``): plain functions on tensors whose
leading dimension is the route batch, NamedTuple state, explicit devices,
and JAX's threefry PRNG reproduced bit for bit (``core/prng.py``) so both
packages draw the same noise from the same keys.  The wavefront relaxation
runs as a hand-written CUDA kernel on the card (``ops/wavefront.py``,
``csrc/wavefront.cu``).  The port never imports JAX.

The first slice covers the GT-localized teach → repeat campaign
(``config.gt_localization()`` with ``teach.run_vio=False``).
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry needs true float32 products, as the JAX package asks of XLA with
# jax_default_matmul_precision="highest": no TF32 in matmuls or cuDNN.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
