"""Split-K scratch for the adapter kernels (no reference module: the TPU
kernels carry their partial sums in VMEM scratch across grid steps).

One grow-only byte buffer per (device, stream), used by ``bea_dense`` and
``bea_dense_grouped`` when they split K: launches on one stream run in
order, so a call never overwrites a buffer that an earlier, still pending
call reads.  ``bea_batched`` takes none in either type: it sums its
K-splits inside a thread-block cluster.
"""

from __future__ import annotations

import torch

_BUFFERS: dict[tuple[int, int], torch.Tensor] = {}


def workspace(nbytes: int, device: torch.device) -> torch.Tensor:
    """A uint8 CUDA buffer of at least ``nbytes`` for the current stream."""
    if torch.cuda.is_current_stream_capturing():
        # a CUDA-graph capture takes a buffer from the graph's own pool, so
        # replays never share scratch with eager calls
        return torch.empty(nbytes, dtype=torch.uint8, device=device)
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _BUFFERS.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = _BUFFERS[key] = torch.empty(nbytes, dtype=torch.uint8,
                                          device=device)
    return buf
