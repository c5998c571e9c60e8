"""Host-side pieces of the bf16 kernels that the CPU can check: the
``bea_dense`` tiling plan (``kernels/bea_fused.py:plan``) and the build's
content hash over the shared CUDA headers (``kernels/_build.py:target``)."""

import shutil

import pytest

from repro_torch.kernels import _build
from repro_torch.kernels.bea_fused import (BLOCK_K, MAX_SPLITS, MIN_STEPS,
                                           SMS, TARGET_BLOCKS, TILES, plan)

PATH_KN = [(896, 896), (896, 128), (896, 4864), (4864, 896)]  # Qwen2-0.5B
RAGGED = [(1, 30, 5), (33, 48, 65), (7, 896, 128), (100, 96, 80), (5, 0, 7),
          (300, 1000, 3000), (17, 4865, 129), (4096, 896, 896)]


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("m,k,n", [(m, k, n) for k, n in PATH_KN
                                   for m in (1, 64, 100, 128)] + RAGGED)
def test_plan_slices_cover_k_and_stay_in_bounds(m, k, n):
    p = plan(m, k, n)
    assert (p.block_m, p.block_n) in TILES
    assert p.k_slice > 0 and p.k_slice % BLOCK_K == 0
    assert 1 <= p.splits <= MAX_SPLITS
    # the slices cover K exactly and none is empty
    assert p.splits * p.k_slice >= k
    assert (p.splits - 1) * p.k_slice < max(k, 1)
    assert p.blocks == _cdiv(m, p.block_m) * _cdiv(n, p.block_n) * p.splits
    if p.splits == 1:
        assert p.workspace_bytes(m, n, 8) == 0
    else:
        assert p.workspace_bytes(m, n, 8) == 4 * p.splits * m * (n + 8)


@pytest.mark.parametrize("k,n", PATH_KN)
@pytest.mark.parametrize("m", [64, 128])
def test_plan_fills_the_card_on_every_path_linear(m, k, n):
    p = plan(m, k, n)
    assert p.blocks >= SMS, p


def test_plan_prefers_large_tiles_split_toward_two_blocks_per_sm():
    """The largest tile that reaches TARGET_BLOCKS by splitting K into
    slices of at least MIN_STEPS K-steps wins; a tile that reaches it alone
    is not split, so it needs no workspace and no reduce kernel."""
    w1 = plan(128, 896, 4864)
    assert (w1.block_m, w1.block_n, w1.splits) == (64, 64, 2)
    w2 = plan(128, 4864, 896)
    assert (w2.block_m, w2.block_n, w2.k_slice) == (64, 64, 8 * BLOCK_K)
    for p in (w1, w2):
        assert p.blocks >= TARGET_BLOCKS
        assert p.k_slice >= MIN_STEPS * BLOCK_K
    big = plan(4096, 896, 896)                   # a long prompt in one chunk
    assert (big.block_m, big.block_n, big.splits) == (64, 64, 1)
    assert big.workspace_bytes(4096, 896, 8) == 0


def test_editing_a_shared_header_changes_the_build_target(tmp_path,
                                                          monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    assert list(csrc.glob("*.cuh")), "the kernels share a header"
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {name: _build.target(name) for name in _build.SOURCES}
    header = sorted(csrc.glob("*.cuh"))[0]
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build.target(name) for name in _build.SOURCES}
    assert all(before[n] != after[n] for n in _build.SOURCES)
    (csrc / "bea_fused.cu").write_text(
        (csrc / "bea_fused.cu").read_text() + "\n")
    assert _build.target("bea_fused") != after["bea_fused"]
    assert _build.target("flash_attention") == after["flash_attention"]
