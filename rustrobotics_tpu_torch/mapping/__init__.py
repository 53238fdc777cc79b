"""SLAM (counterpart of ``rustrobotics_tpu/mapping``): the graph back end
(g2o parsing, native C++ or Python; pose-graph Gauss-Newton and
Levenberg-Marquardt on every solver backend, fleets of same-structure
graphs, chordal initialization, the online fixed-lag smoother and the
SLAM-course front end) and the filter and scan-matching families:
EKF-SLAM (known and unknown correspondences, Schmidt updates), FastSLAM
1.0 / 2.0, their SLAM-course replays, ICP, occupancy grids and the
scan-matching pipeline with loop closures."""

from rustrobotics_tpu_torch.mapping.ekf_slam import (  # noqa: F401
    EkfSlamKnownCorrespondences,
    EkfSlamState,
)
from rustrobotics_tpu_torch.mapping.fastslam import (  # noqa: F401
    FastSlam,
    FastSlamParticles,
)

from rustrobotics_tpu_torch.mapping.fixed_lag import (  # noqa: F401
    FixedLagSmoother,
    FixedLagState,
)
from rustrobotics_tpu_torch.mapping.frontend import (  # noqa: F401
    build_pose_graph_from_slam_course,
)
from rustrobotics_tpu_torch.mapping.g2o import (  # noqa: F401
    PoseGraphData,
    load_g2o,
)
from rustrobotics_tpu_torch.mapping.initialization import (  # noqa: F401
    chordal_init_se2,
    chordal_init_se3,
)
from rustrobotics_tpu_torch.mapping.pgo import (  # noqa: F401
    PoseGraph,
    global_error,
    make_optimize_batch,
    optimize,
    stack_graphs,
)
