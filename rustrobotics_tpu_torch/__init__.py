"""PyTorch/CUDA port of ``rustrobotics_tpu``.

The JAX package beside this one is the reference; every module here keeps
its counterpart's name and function names and is tested against it on the
same inputs. This package never imports JAX or ``rustrobotics_tpu``.

Ported so far: pose-graph Gauss-Newton / Levenberg-Marquardt over the
RCM-banded direct solver (``mapping.pgo.make_optimize``), with the banded
factorization and substitution as hand-written CUDA kernels for Hopper
(``ops.band_chol_kernels``, sources in ``csrc/``).

Entry points take ``device=None`` and then run on ``"cuda"``; pass
``device="cpu"`` to run the plain PyTorch versions on the CPU.
"""

import torch

# The JAX package runs every f32 product at "highest" precision: reduced
# precision (TF32 here, bf16 passes on the TPU) turns the 1e7 gauge-prior
# normal equations into NaN.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
