from .camera import Camera, WORLD_POINTS, load_world_points
from .rotations import (
    quat_to_rotmat,
    rotmat_to_quat,
    quat_to_dcm,
    dcm_to_quat,
    rodrigues,
    inverse_rodrigues,
)
from .projection import project_points, project_points_quat
from .scoring import speed_score, speed_score_batch
from .p3p import p3p_solutions
from .ransac import ransac_p3p
from .refine import gauss_newton_pnp, huber_weighted_pnp
from .solvers import (
    SolverConfig,
    select_keypoints,
    solve_pose_self_assessed,
    solve_pose_sigma,
    solve_pose_simple,
)
from .multi_mean import solve_pose_multi_mean, solve_pose_multi_mean_batch
from .exhaustive import exhaustive_pnp
