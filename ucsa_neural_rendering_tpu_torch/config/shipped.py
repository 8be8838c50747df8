"""The shipped NeRF configuration knobs (a copy of the JAX package's
config/shipped.py constants; the port keeps its own copy so that it never
imports the JAX package)."""

# encoding geometry (n_levels, n_features)
SHIPPED_NERF_ENC = (8, 4)

# forward estimator: False = exact trilinear, "face" = stratified
# face-sampled fine levels, True = fully stochastic
SHIPPED_NERF_SFWD = False

# train-time sample budget (occupancy-guided coarse + importance)
SHIPPED_TRAIN_BUDGET = (24, 8)

# coarse placement: False = binary occupancy weights, True = graded
# grid-density proposal placement
SHIPPED_PROPOSAL = True


def shipped_enc_str() -> str:
    return f"{SHIPPED_NERF_ENC[0]}x{SHIPPED_NERF_ENC[1]}"
