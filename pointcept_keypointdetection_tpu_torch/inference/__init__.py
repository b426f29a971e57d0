from .keypoint import KeypointPredictor, OffsetKeypointPredictor, aggregate_keypoints  # noqa: F401
from .segment import SegmentPredictor  # noqa: F401
