from .activation import gelu, relu, silu, tanh  # noqa: F401
from .attention import scaled_dot_product_attention  # noqa: F401
from .common import dropout  # noqa: F401
from .conv import conv2d  # noqa: F401
from .loss import cross_entropy  # noqa: F401
from .norm import batch_norm, fused_dropout_add_layer_norm, layer_norm, rms_norm  # noqa: F401
from .pooling import adaptive_avg_pool2d, max_pool2d  # noqa: F401
