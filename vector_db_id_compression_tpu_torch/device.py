"""Where the port's entry points run: on the card, unless the caller names
another device (``device="cpu"``, as the CPU tests do)."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device, data=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the device of
    ``data`` where that is a tensor, else ``DEFAULT_DEVICE``. Raises
    RuntimeError where the device is not available, as the card is not on a
    machine without one: an entry point never carries on on the CPU
    unasked."""
    if device is None:
        device = data.device if isinstance(data, torch.Tensor) else DEFAULT_DEVICE
    dev = torch.device(device)
    try:
        torch.empty(0, device=dev)
    except (AssertionError, RuntimeError) as e:
        raise RuntimeError(f"device {dev} is not available ({e}); pass device='cpu' "
                           "to run on the CPU") from e
    return dev
