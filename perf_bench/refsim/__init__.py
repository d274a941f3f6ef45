"""refsim: the benchmark's plain reference of the port's campaign tick.

A frozen copy of the port's modules that the teach and repeat ticks run
(``rollout/``, ``sensors/``, ``vio/``, ``landmarks/``, ``fusion/``,
``mapping/``, ``planning/``, ``control/``, ``dynamics/``, ``scene/``,
``core/``, ``config.py``, ``baselines/configs.py``), taken at the commit
that defined the benchmark, with the hand-written kernels replaced by their
plain PyTorch versions (``ops/hamming.py``, ``ops/wavefront.py``,
``vio/ba.py:solve_ba_plain``).  It imports nothing of the port, and later
changes to the port do not reach it: a change that alters what the port
computes shows as a gap between the two.
"""

import torch as _torch

# Geometry needs true float32 products: no TF32 in matmuls or cuDNN.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
