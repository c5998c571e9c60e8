"""Hand-written Hopper kernels for the three Pallas TPU kernels, their plain
PyTorch versions (``ref``) and the dispatch around them (``ops``).

Every wrapper counts its kernel launches in a plain integer attribute
(``bea_dense.launches`` …); :func:`launch_counts` and :func:`reset_launches`
read and clear them together.
"""

from __future__ import annotations

from repro_torch.kernels.bea_batched import bea_batched
from repro_torch.kernels.bea_fused import bea_dense, bea_dense_grouped
from repro_torch.kernels.flash_attention import flash_attention

WRAPPERS = {"bea_dense": bea_dense, "bea_dense_grouped": bea_dense_grouped,
            "bea_batched": bea_batched, "flash_attention": flash_attention}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
