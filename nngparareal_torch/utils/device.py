"""Device resolution shared by the port's entry points.

The port runs on a CUDA card unless the caller asks for the CPU: an entry
point given ``device=None`` takes ``cuda`` and raises when there is none,
so a run never drops to the CPU without being asked to.
"""

import torch


def resolve_device(device=None):
    """Return the torch.device for ``device`` (None means the CUDA card)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device

