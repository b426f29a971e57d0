from .keypoint import OffsetKeypointPredictor, aggregate_keypoints  # noqa: F401
from .segment import SegmentPredictor  # noqa: F401
