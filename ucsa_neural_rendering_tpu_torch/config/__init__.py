from .flatten_dict import flatten_dict
from .key_audit import audit_exp_keys, ignored_reason
from .loading import (YAMLSubsetError, load_env, load_exp_and_env, load_yaml,
                      parse_yaml)
from .shipped import (SHIPPED_NERF_ENC, SHIPPED_NERF_SFWD, SHIPPED_PROPOSAL,
                      SHIPPED_TRAIN_BUDGET, shipped_enc_str)

__all__ = ["flatten_dict", "audit_exp_keys", "ignored_reason",
           "YAMLSubsetError", "load_env", "load_exp_and_env", "load_yaml",
           "parse_yaml", "SHIPPED_NERF_ENC", "SHIPPED_NERF_SFWD",
           "SHIPPED_PROPOSAL", "SHIPPED_TRAIN_BUDGET", "shipped_enc_str"]
