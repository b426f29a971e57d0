from .keypoint import OffsetKeypointPredictor, aggregate_keypoints  # noqa: F401
