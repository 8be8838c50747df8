"""Device selection shared by the port's entry points."""

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. Entry points default to "cuda" and
    raise when no card is present, unless the caller asks for "cpu"."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return device
