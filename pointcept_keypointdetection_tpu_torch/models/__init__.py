from .builder import MODELS, build_model, cast_parameters, init_weights
from .structure import PointBatch
from . import point_transformer_v3  # noqa: F401  (registers PT-v3m1)
from . import keypoint  # noqa: F401  (registers OffsetKeypointPTv3)
from . import default  # noqa: F401  (registers DefaultSegmentor, DefaultSegmentorV2)
from . import sparse_unet  # noqa: F401  (registers SpUNet-v1m1, -v1m2, -v1m3)
from . import point_group  # noqa: F401  (registers PG-v1m1, PG-v1m2)
from . import octformer  # noqa: F401  (registers OctFormer-v1m1)
from . import swin3d  # noqa: F401  (registers Swin3D-v1m1)
from . import oacnns  # noqa: F401  (registers OA-CNNs)
from . import point_transformer_v2  # noqa: F401  (registers PT-v2m2, PT-v2m1)
from . import point_transformer  # noqa: F401  (registers PT-v1)
from . import stratified_transformer  # noqa: F401  (registers ST-v1m2, ST-v1m1)
