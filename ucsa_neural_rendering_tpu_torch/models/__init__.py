from .activation import trunc_exp
from .convert import (deeplab_state_from_jax, load_deeplab_checkpoint,
                      params_from_jax, read_deeplab_checkpoint,
                      strip_lightning_prefix)
from .deeplabv3 import DeepLabV3, resize_bilinear, seg_compute_dtype
from .hash_encoding import (HashGridEncoding, HashGridSpec, hash_encode,
                            hash_encode_bwd, hash_encode_bwd_plain,
                            hash_encode_plain, hash_encode_sampled,
                            hash_encode_sampled_plain, make_spec,
                            ngp_per_level_scale, sampled_corner_indices)
from .packed_table import (PackedTable, PackedTableCache, build_packed_table,
                           build_packed_table_plain, choose_n_packed,
                           hash_encode_packed, hash_encode_packed_plain)
from .semantic_nerf import (SemanticNeRF, mlp_bwd, mlp_bwd_plain, mlp_fwd,
                            mlp_fwd_plain)
from .resnet import RESNET101_LAYOUT, TINY_LAYOUT, ResNet101Backbone
from .sh_encoding import sh_encoding

__all__ = [
    "trunc_exp", "params_from_jax", "deeplab_state_from_jax",
    "load_deeplab_checkpoint", "read_deeplab_checkpoint",
    "strip_lightning_prefix", "DeepLabV3",
    "resize_bilinear", "seg_compute_dtype", "RESNET101_LAYOUT", "TINY_LAYOUT",
    "ResNet101Backbone", "HashGridEncoding", "HashGridSpec",
    "hash_encode", "hash_encode_bwd", "hash_encode_bwd_plain",
    "hash_encode_plain", "hash_encode_sampled", "hash_encode_sampled_plain",
    "hash_encode_packed", "hash_encode_packed_plain", "PackedTable",
    "PackedTableCache", "build_packed_table", "build_packed_table_plain",
    "choose_n_packed",
    "make_spec", "ngp_per_level_scale", "sampled_corner_indices",
    "SemanticNeRF", "mlp_bwd", "mlp_bwd_plain", "mlp_fwd", "mlp_fwd_plain",
    "sh_encoding",
]
