from .nerf_trainer import NeRFTrainer, make_nerf_optimizer, nerf_losses

__all__ = ["NeRFTrainer", "make_nerf_optimizer", "nerf_losses"]
