from .shipped import (SHIPPED_NERF_ENC, SHIPPED_NERF_SFWD, SHIPPED_PROPOSAL,
                      SHIPPED_TRAIN_BUDGET, shipped_enc_str)

__all__ = ["SHIPPED_NERF_ENC", "SHIPPED_NERF_SFWD", "SHIPPED_PROPOSAL",
           "SHIPPED_TRAIN_BUDGET", "shipped_enc_str"]
