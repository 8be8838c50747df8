"""ucsa_neural_rendering_tpu_torch — the PyTorch + CUDA port of
`ucsa_neural_rendering_tpu`, grown slice by slice for NVIDIA Hopper (H100).

Module paths and public names mirror the JAX package so every counterpart is
easy to find; the JAX package stays the numerical reference. This package
imports torch and never jax, and nothing of the JAX package.

Slice 1 (this tree): the deterministic full-frame Semantic-NeRF render.
  config/    shipped encoding constants
  data/      camera rays
  ops/       AABB, sampling, occupancy lookups, compositing, renderer
  models/    hash encoding, SH encoding, Semantic-NeRF MLPs, JAX→torch params
  train/     NeRFTrainer.render_image
  kernels/   build + ctypes binding + launch counters of the CUDA kernels
  csrc/      the hand-written CUDA kernels (sm_90a)

Entry points run on the card (device="cuda") unless the caller passes
device="cpu"; on CPU tensors every kernel wrapper takes its plain PyTorch
version.
"""
