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


def set_deterministic() -> None:
    """Make the card repeat a run bit for bit, as the JAX package does on
    its devices: cuDNN takes its deterministic algorithms (its default
    weight-gradient algorithms add in an order that changes from run to
    run) and does not time candidates to pick one (cudnn.benchmark off).
    The port's own kernels and the seg net's resize add in a fixed order
    anyway. The entry points call this; the trainers set no global flag."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
