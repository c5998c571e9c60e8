"""Device choice for the port's entry points (no reference module: the JAX
package takes its backend from ``JAX_PLATFORMS``).

Entry points run on CUDA unless the caller asks for the CPU; without a card
they raise rather than carry on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           f"available")
    return dev
