"""The SLAM bridge's odometry and back end on tensors: the counterpart of
``pointcept_keypointdetection_tpu/slam/`` (not ported: ``ba.py``, ``rosbag.py``)."""

from . import se3
from .evaluate import absolute_trajectory_error, relative_pose_error, umeyama_alignment
from .imu import ImuState, propagate
from .pipeline import LidarOdometry, OdometryConfig
from .pose_graph import PoseGraph, optimize
from .registration import RegistrationResult, point_to_plane_icp
from .semantic_slam import SemanticSLAM, SlamConfig
from .voxel_map import VoxelMap
