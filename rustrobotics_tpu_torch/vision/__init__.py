"""Camera geometry: calibration, triangulation, pose, bundle adjustment
(counterpart of ``rustrobotics_tpu/vision``).

Every solver is batched linear algebra (SVD, QR, closed forms) over
tensor axes; robust PnP scores a fixed batch of P3P hypotheses at once.
"""

from rustrobotics_tpu_torch.vision.cameras import (  # noqa: F401
    decompose_projection,
    project,
    projection_matrix,
)
from rustrobotics_tpu_torch.vision.calibrate import (  # noqa: F401
    dlt_camera,
    distort_points,
    estimate_radial_distortion,
    homography,
    zhang_calibrate,
)
from rustrobotics_tpu_torch.vision.triangulate import (  # noqa: F401
    triangulate,
    triangulate_pair,
)
from rustrobotics_tpu_torch.vision.p3p import (  # noqa: F401
    p3p,
    p3p_best,
    pnp_ransac,
)
