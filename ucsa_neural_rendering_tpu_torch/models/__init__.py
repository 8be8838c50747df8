from .activation import trunc_exp
from .convert import params_from_jax
from .hash_encoding import (HashGridEncoding, HashGridSpec, hash_encode,
                            hash_encode_plain, make_spec, ngp_per_level_scale)
from .semantic_nerf import SemanticNeRF
from .sh_encoding import sh_encoding

__all__ = [
    "trunc_exp", "params_from_jax", "HashGridEncoding", "HashGridSpec",
    "hash_encode", "hash_encode_plain", "make_spec", "ngp_per_level_scale",
    "SemanticNeRF", "sh_encoding",
]
