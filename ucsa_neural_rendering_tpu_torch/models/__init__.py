from .activation import trunc_exp
from .convert import params_from_jax
from .hash_encoding import (HashGridEncoding, HashGridSpec, hash_encode,
                            hash_encode_bwd, hash_encode_bwd_plain,
                            hash_encode_plain, hash_encode_sampled,
                            hash_encode_sampled_plain, make_spec,
                            ngp_per_level_scale, sampled_corner_indices)
from .semantic_nerf import (SemanticNeRF, mlp_bwd, mlp_bwd_plain, mlp_fwd,
                            mlp_fwd_plain)
from .sh_encoding import sh_encoding

__all__ = [
    "trunc_exp", "params_from_jax", "HashGridEncoding", "HashGridSpec",
    "hash_encode", "hash_encode_bwd", "hash_encode_bwd_plain",
    "hash_encode_plain", "hash_encode_sampled", "hash_encode_sampled_plain",
    "make_spec", "ngp_per_level_scale", "sampled_corner_indices",
    "SemanticNeRF", "mlp_bwd", "mlp_bwd_plain", "mlp_fwd", "mlp_fwd_plain",
    "sh_encoding",
]
