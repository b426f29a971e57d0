from .builder import MODELS, build_model, init_weights
from .structure import PointBatch
from . import point_transformer_v3  # noqa: F401  (registers PT-v3m1)
from . import keypoint  # noqa: F401  (registers OffsetKeypointPTv3)
