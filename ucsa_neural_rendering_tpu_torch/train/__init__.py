from .nerf_trainer import NeRFTrainer

__all__ = ["NeRFTrainer"]
