from cvsd_tpu_torch.models.gcae import (  # noqa: F401
    GCAE,
    GCAEDecoder,
    GCAEEncoder,
    GraphConvolution,
    STGCNBlock,
    TemporalConvolution,
)
from cvsd_tpu_torch.models.graph import (  # noqa: F401
    adaptive_pool_matrix,
    compute_strides,
    get_skeleton_adjacency,
    normalize_adjacency,
    normalized_skeleton_adjacency,
)
from cvsd_tpu_torch.models.detector import (  # noqa: F401
    PersonDetector,
    build_detector,
    decode_predictions,
    make_detect_fn,
)
from cvsd_tpu_torch.models.shopformer import Shopformer, build_shopformer, count_parameters  # noqa: F401
from cvsd_tpu_torch.models.transformer import (  # noqa: F401
    ShopformerTransformer,
    TransformerDecoderLayer,
    TransformerEncoderLayer,
    build_transformer,
    sinusoidal_positional_encoding,
)
