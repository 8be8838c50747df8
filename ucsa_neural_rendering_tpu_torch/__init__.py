"""ucsa_neural_rendering_tpu_torch — the PyTorch + CUDA port of
`ucsa_neural_rendering_tpu`, grown slice by slice for NVIDIA Hopper (H100).

Module paths and public names mirror the JAX package so every counterpart is
easy to find; the JAX package stays the numerical reference. This package
imports torch and never jax, and nothing of the JAX package.

This tree: the deterministic full-frame Semantic-NeRF render, one training
step with the occupancy refresh, the fused MLP kernels on both, the
row-gather benchmark, the segmentation net (DeepLabV3-ResNet101) with its
trainer and its meter (cuDNN convolutions, no hand kernel), and the joint
adaptation step that composes the two with on-device augmentation.
  config/    shipped encoding constants
  data/      camera rays; augmentation (jitter, rotate, crop, flip)
  ops/       AABB, sampling, occupancy grid, compositing, renderer
  models/    hash encoding, SH encoding, Semantic-NeRF and its MLPs,
             ResNet-101 and DeepLabV3, JAX↔torch params, checkpoints
  metrics/   the confusion matrix and SemanticsMeter
  train/     NeRFTrainer: render_image, train_step, update_occupancy;
             SegTrainer: train_step, update, eval_step, infer (the BN
             trick); JointTrainer: seg_pseudo_labels, nerf_fit_step,
             nerf_fit_epoch, joint_step, render_frames, predict_frame
  parallel/  data parallelism over torch.distributed: the Mesh (one
             rank a device), synced BatchNorm, gradient all-reduce, and a
             dry run over spawned ranks
  bench/     card-side timing and the row-gather benchmark (dma_gather)
  kernels/   build + ctypes binding + launch counters of the CUDA kernels
  csrc/      the hand-written CUDA kernels (sm_90a)
  native/    the native image loader's C++ source (data/native_loader.py
             builds and binds it) and the headers it may need

Entry points run on the card (device="cuda") unless the caller passes
device="cpu"; on CPU tensors every kernel wrapper takes its plain PyTorch
version.
"""
