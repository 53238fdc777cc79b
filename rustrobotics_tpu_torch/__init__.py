"""PyTorch/CUDA port of ``rustrobotics_tpu``.

The JAX package beside this one is the reference; every module here keeps
its counterpart's name and function names and is tested against it on the
same inputs. This package never imports JAX or ``rustrobotics_tpu``.

Ported so far: pose-graph mapping (``mapping``): the g2o parsers (native
C++ and Python), ``PoseGraph`` and Gauss-Newton / Levenberg-Marquardt on
every solver backend (``mapping.pgo``: one graph or a fleet, SE2 and SE3,
robust kernels, marginals), chordal initialization, the online fixed-lag
smoother, the SLAM-course loader (``data``) and front end, and the
plotting helpers (``utils.plot``); and the Bayesian filters: the Gaussian
state and MVN (``utils``), the motion and measurement models (``models``),
EKF / UKF / PF / EIF / histogram filters, the banked fleet filters and the
parallel Kalman scan (``localization``), the UTIAS loader (``data``) and
both localization entry points (``localization.simulation.run_simulation``
and ``localization.landmark_replay.run_utias_localization[_fleet]``); the
SLAM families in ``mapping``: ICP, occupancy grids, the scan-matching
pipeline with loop closures, EKF-SLAM (known and unknown correspondences,
Schmidt updates), FastSLAM 1.0 / 2.0 and the SLAM-course replays
(``mapping.slam_replay``); camera geometry (``vision``: projection, DLT,
Zhang calibration and radial distortion, triangulation, P3P and RANSAC
PnP, bundle adjustment) and control (``control``: LQR, LQG, the inverted
pendulum). The banded assembly, factorization and substitution, and the block-banded
SpMV, are hand-written CUDA kernels for Hopper
(``ops.band_assemble_kernels``, ``ops.band_chol_kernels``,
``ops.banded_kernels``; sources in ``csrc/``); the filters, the SLAM
families, vision and control run no kernel of their own.

The measurement layer: the configuration dataclasses (``config``), card
timing (``utils.devtime``), phase timers and optimizer metrics
(``utils.metrics``), FLOP models and MFU against the H100's peak
(``roofline``), NaN sanitizers (``utils.debug``) and checkpoints in the
JAX package's file format (``utils.checkpoint``). The distributed tier
(``parallel``): edge-sharded Gauss-Newton / Levenberg-Marquardt and the
sharded particle filter over ``torch.distributed`` process groups.

Entry points take ``device=None`` and then run on ``"cuda"``; pass
``device="cpu"`` to run the plain PyTorch versions on the CPU.
"""

__version__ = "0.1.0"

import torch

# The JAX package runs every f32 product at "highest" precision: reduced
# precision (TF32 here, bf16 passes on the TPU) turns the 1e7 gauge-prior
# normal equations into NaN.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from rustrobotics_tpu_torch.utils.state import GaussianState  # noqa: E402,F401
