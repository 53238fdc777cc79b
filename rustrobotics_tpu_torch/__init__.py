"""PyTorch/CUDA port of ``rustrobotics_tpu``.

The JAX package beside this one is the reference; every module here keeps
its counterpart's name and function names and is tested against it on the
same inputs. This package never imports JAX or ``rustrobotics_tpu``.

Ported so far: pose-graph mapping (``mapping``): the g2o parsers (native
C++ and Python), ``PoseGraph`` and Gauss-Newton / Levenberg-Marquardt on
every solver backend (``mapping.pgo``: one graph or a fleet, SE2 and SE3,
robust kernels, marginals), chordal initialization, the online fixed-lag
smoother, the SLAM-course loader (``data``) and front end, and the
plotting helpers (``utils.plot``). The banded assembly, factorization and
substitution, and the block-banded SpMV, are hand-written CUDA kernels for
Hopper (``ops.band_assemble_kernels``, ``ops.band_chol_kernels``,
``ops.banded_kernels``; sources in ``csrc/``).

Entry points take ``device=None`` and then run on ``"cuda"``; pass
``device="cpu"`` to run the plain PyTorch versions on the CPU.
"""

import torch

# The JAX package runs every f32 product at "highest" precision: reduced
# precision (TF32 here, bf16 passes on the TPU) turns the 1e7 gauge-prior
# normal equations into NaN.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
