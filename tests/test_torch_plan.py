"""Host-side pieces of the kernels that the CPU can check: the bf16 and f32
plans of ``bea_dense`` (``kernels/bea_fused.py:plan``; the bf16 ``wgmma``
plan of training rows and the ``mma_kernel`` plans of serving rows), the
bf16 and f32
plans of ``bea_batched`` (``kernels/bea_batched.py:plan`` and
``f32_plan``), the flash body's plan (``kernels/flash_attention.py:plan``:
``wgmma_kernel`` or the mma.sync bodies), and the build's content hash over
the shared CUDA headers (``kernels/_build.py:target``)."""

import importlib
import shutil

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bea_fused import (F32_WIDE_MAX_RANK, MAX_SPLITS,
                                           SMS, TARGET_BLOCKS, TILINGS,
                                           WGMMA_BLOCK_M, WGMMA_BLOCK_NS,
                                           WGMMA_MIN_M, WGMMA_WIDE_MAX_RANK,
                                           mma_plan, plan, wgmma_plan)

BLOCK_K, TILES, MIN_STEPS, _ = TILINGS[torch.bfloat16]   # the bf16 instance
PATH_KN = [(896, 896), (896, 128), (896, 4864), (4864, 896)]  # Qwen2-0.5B
RAGGED = [(1, 30, 5), (33, 48, 65), (7, 896, 128), (100, 96, 80), (5, 0, 7),
          (300, 1000, 3000), (17, 4865, 129), (4096, 896, 896)]


def _cdiv(a, b):
    return -(-a // b)


WGMMA_TILES = [(WGMMA_BLOCK_M, bn) for bn in WGMMA_BLOCK_NS]


@pytest.mark.parametrize("m,k,n", [(m, k, n) for k, n in PATH_KN
                                   for m in (1, 64, 100, 128)] + RAGGED)
def test_plan_slices_cover_k_and_stay_in_bounds(m, k, n):
    """Serving rows take the mma.sync tiles; a call of training rows
    (RAGGED's 4096-row linear) takes the wgmma instance's 128-row tiles,
    its grid one block per SM at most."""
    p = plan(m, k, n)
    work = _cdiv(m, p.block_m) * _cdiv(n, p.block_n) * p.splits
    if p.kernel == "wgmma":
        assert (p.block_m, p.block_n) in WGMMA_TILES
        assert p.blocks == min(work, SMS)
    else:
        assert (p.block_m, p.block_n) in TILES
        assert p.blocks == work
    assert p.k_slice > 0 and p.k_slice % BLOCK_K == 0
    assert 1 <= p.splits <= MAX_SPLITS
    # the slices cover K exactly and none is empty
    assert p.splits * p.k_slice >= k
    assert (p.splits - 1) * p.k_slice < max(k, 1)
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
    big = mma_plan(4096, 896, 896)               # a long prompt in one chunk
    assert (big.block_m, big.block_n, big.splits) == (64, 64, 1)
    assert big.workspace_bytes(4096, 896, 8) == 0
    # ... which at 4096 rows runs the wgmma instance instead, unsplit
    big = plan(4096, 896, 896)
    assert (big.kernel, big.block_m, big.block_n, big.splits) == (
        "wgmma", 128, 224, 1)
    assert big.workspace_bytes(4096, 896, 8) == 0


# The plans of Qwen2-0.5B's serving rows as they were before the wgmma
# instance came: (block_m, block_n, splits, k_slice, blocks) on mma_kernel.
SERVING_PLANS = {
    (1, 896, 896): (16, 32, 7, 128, 196),
    (64, 896, 896): (16, 64, 5, 192, 280),
    (100, 896, 896): (32, 64, 5, 192, 280),
    (128, 896, 896): (32, 64, 5, 192, 280),
    (1, 896, 128): (16, 32, 14, 64, 56),
    (64, 896, 128): (16, 32, 14, 64, 224),
    (100, 896, 128): (16, 32, 7, 128, 196),
    (128, 896, 128): (16, 32, 7, 128, 224),
    (1, 896, 4864): (16, 64, 4, 256, 304),
    (64, 896, 4864): (64, 64, 4, 256, 304),
    (100, 896, 4864): (64, 64, 2, 448, 304),
    (128, 896, 4864): (64, 64, 2, 448, 304),
    (1, 4864, 896): (16, 64, 19, 256, 266),
    (64, 4864, 896): (64, 64, 19, 256, 266),
    (100, 4864, 896): (64, 64, 10, 512, 280),
    (128, 4864, 896): (64, 64, 10, 512, 280),
}


@pytest.mark.parametrize("m,k,n", sorted(SERVING_PLANS))
@pytest.mark.parametrize("r", [1, 8, 64])
def test_serving_rows_keep_their_mma_plans(m, k, n, r):
    p = plan(m, k, n, rank=r)
    assert p.kernel == "mma"
    assert (p.block_m, p.block_n, p.splits, p.k_slice, p.blocks) == \
        SERVING_PLANS[m, k, n]
    assert p == mma_plan(m, k, n) == plan(m, k, n, aligned=False)


def _wgmma_smem(block_n, rank):
    """Shared memory of a wgmma block (csrc/bea_fused.cu WTile): a ring of
    x (128 × 64), W (64-column boxes of 64 × 64) and A (RP × 64) bf16
    stages, 4 deep where they fit and else 3, beside two 64 × 32 bf16
    output boxes per consumer warpgroup, the B tile (block_n × RP bf16),
    e⊙mask (RP floats), the barriers and 1 KB of alignment."""
    rp = 16 if rank <= 16 else 32 if rank <= 32 else 64
    stage = 2 * 64 * (WGMMA_BLOCK_M + 64 * _cdiv(block_n, 64) + rp)
    fixed = 1024 + 4 * 64 * 32 * 2 + 2 * block_n * rp + 4 * rp + 64
    stages = 4 if fixed + 4 * stage <= 232448 else 3
    return stages, fixed + stages * stage


@pytest.mark.parametrize("k,n", PATH_KN)
@pytest.mark.parametrize("m", [4096, 4000, 4097, WGMMA_MIN_M])
def test_training_rows_take_the_wgmma_plan(m, k, n):
    """Every Qwen2 linear at a training step's rows: 128-row tiles (two
    warpgroups of 64), a column tile a multiple of 8 up to wgmma's 256,
    the ring within an H100 block's 227 KB at every rank bucket, slices of
    whole 64-deep K-steps covering K, one block per SM at most, and a
    workspace only when K is split."""
    for r in (1, 8, WGMMA_WIDE_MAX_RANK + 1, 64):
        p = plan(m, k, n, rank=r)
        assert p.kernel == "wgmma" and p == wgmma_plan(m, k, n, r)
        assert p.block_m % 64 == 0 and p.block_m == WGMMA_BLOCK_M
        assert p.block_n % 8 == 0 and p.block_n <= 256
        if r > WGMMA_WIDE_MAX_RANK:     # the one width built past rank 16
            assert p.block_n == 128
        stages, smem = _wgmma_smem(p.block_n, r)
        assert stages >= 3 and smem <= 227 * 1024
        assert p.k_slice % BLOCK_K == 0
        assert p.splits * p.k_slice >= k > (p.splits - 1) * p.k_slice
        work = _cdiv(m, p.block_m) * _cdiv(n, p.block_n) * p.splits
        assert p.blocks == min(work, SMS)
        want = 4 * p.splits * m * (n + r) if p.splits > 1 else 0
        assert p.workspace_bytes(m, n, r) == want


@pytest.mark.parametrize("k,n,bn,waves", [(896, 896, 224, 1),
                                          (4864, 896, 224, 1),
                                          (896, 4864, 256, 5),
                                          (896, 128, 128, 1)])
def test_wgmma_column_tile_fills_the_last_wave(k, n, bn, waves):
    """At 4096 rows (32 row tiles): N = 896 in four 224-wide tiles is one
    wave of 128 tiles on 132 SMs (256 would leave 128 columns of the last
    tile empty); N = 4864 in 19 tiles of 256."""
    p = plan(4096, k, n)
    assert p.block_n == bn
    tiles = 32 * _cdiv(n, bn)
    assert _cdiv(tiles * p.splits, SMS) <= waves


@pytest.mark.parametrize("m,k,n", [(4096, 900, 896), (4096, 896, 900),
                                   (4096, 4865, 129), (4096, 0, 896),
                                   (WGMMA_MIN_M - 1, 896, 896)])
def test_unaligned_or_short_calls_take_mma_kernel(m, k, n):
    """TMA needs K and N to be multiples of 8 (16-byte row pitches), and
    the wgmma tiles need rows enough; any other call keeps mma_kernel's
    plan, as do operands that do not start on 16-byte boundaries."""
    p = plan(m, k, n, rank=8)
    assert p.kernel == "mma" and (p.block_m, p.block_n) in TILES
    assert p == mma_plan(m, k, n, rank=8)
    assert plan(4096, 896, 896, aligned=False).kernel == "mma"
    assert plan(4096, 896, 896, torch.float32).kernel == "mma"


# ------------------------------------------------ f32 (training path) ----

F32 = TILINGS[torch.float32]
TRAIN_MKN = [(1024, 768, 768), (1024, 768, 3072), (1024, 3072, 768)]  # 8×128


@pytest.mark.parametrize("m,k,n", TRAIN_MKN
                         + [(256, k, n) for _, k, n in TRAIN_MKN]
                         + [(m, k, n) for k, n in PATH_KN for m in (1, 128)]
                         + RAGGED)
def test_f32_plan_slices_cover_k_and_the_workspace_matches(m, k, n):
    p = plan(m, k, n, torch.float32)
    assert (p.block_m, p.block_n) in F32.tiles
    assert p.k_slice > 0 and p.k_slice % F32.block_k == 0
    assert 1 <= p.splits <= MAX_SPLITS
    # the slices cover K exactly and none is empty
    assert p.splits * p.k_slice >= k
    assert (p.splits - 1) * p.k_slice < max(k, 1)
    assert p.blocks == _cdiv(m, p.block_m) * _cdiv(n, p.block_n) * p.splits
    # the wrapper asks for plan.workspace_bytes for both types, and the
    # launcher refuses less than 4·splits·M·(N + r) (csrc/bea_fused.cu)
    for r in (1, 12, 64):
        want = 4 * p.splits * m * (n + r) if p.splits > 1 else 0
        assert p.workspace_bytes(m, n, r) == want


@pytest.mark.parametrize("m,k,n", TRAIN_MKN + [(2048, 768, 3072),
                                               (3072, 3072, 768)])
def test_f32_wide_tile_takes_ranks_up_to_16(m, k, n):
    """The 128-row f32 tile spills past rank 16 (csrc/bea_fused.cu builds
    no such instance), so larger ranks get a 64-row tile with the same
    slicing rule; up to 16 the rank changes nothing."""
    for r in (0, 1, 12, F32_WIDE_MAX_RANK):
        assert plan(m, k, n, torch.float32, rank=r) == plan(
            m, k, n, torch.float32)
    for r in (F32_WIDE_MAX_RANK + 1, 33, 64):
        p = plan(m, k, n, torch.float32, rank=r)
        assert p.block_m < 128 and (p.block_m, p.block_n) in F32.tiles
        assert p.splits * p.k_slice >= k
        assert plan(m, k, n, torch.float32, clients=1, rank=r) == p


@pytest.mark.parametrize("m,k,n", TRAIN_MKN)
def test_f32_plan_fills_the_card_at_the_training_shapes(m, k, n):
    """Each of DistilBERT's linears at 8 × 128 tokens runs at least one
    block per SM, with at most ``fill_splits`` K-splits: the tilings that
    timed best on the card (PERF.md)."""
    p = plan(m, k, n, torch.float32)
    assert p.blocks >= SMS, p
    assert p.splits <= F32.fill_splits
    want = {(768, 768): (64, 64, 2), (768, 3072): (128, 64, 1),
            (3072, 768): (64, 64, 2)}
    assert (p.block_m, p.block_n, p.splits) == want[k, n]


def test_f32_plan_k_step_is_a_bf16_stage_in_bytes():
    """32 floats per K-step keep a stage's row at the bf16 instance's 128
    bytes; slices keep at least 128 of K in both."""
    bf = TILINGS[torch.bfloat16]
    assert F32.block_k * 4 == bf.block_k * 2 == 128
    assert F32.block_k * F32.min_steps == bf.block_k * bf.min_steps == 128
    assert plan(1024, 768, 768) == plan(1024, 768, 768, torch.bfloat16)


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


# ------------------------------------------------- bea_batched (decode) ----

# the package exports the wrapper under the module's name
bb = importlib.import_module("repro_torch.kernels.bea_batched")

BATCHED_M = (1, 4, 8, 64)


@pytest.mark.parametrize("k,n", PATH_KN)
@pytest.mark.parametrize("m", BATCHED_M)
def test_batched_plan_slices_cover_k_none_empty(m, k, n):
    p = bb.plan(m, k, n, 2, 8)
    assert p.k_slice > 0 and p.k_slice % bb.BLOCK_K == 0
    assert p.splits * p.k_slice >= k
    assert (p.splits - 1) * p.k_slice < k          # the last slice has rows
    assert 1 <= p.stages <= bb.STAGES[p.m_pad, p.block_n]
    assert p.stages <= p.k_slice // bb.BLOCK_K     # no ring slot left unused
    assert p.blocks == _cdiv(n, p.block_n) * p.splits * _cdiv(m, bb.M_TILE)


@pytest.mark.parametrize("k,n", PATH_KN)
@pytest.mark.parametrize("m", BATCHED_M)
def test_batched_plan_fills_the_card_or_says_why(m, k, n):
    """Every path linear reaches one block per SM except wk/wv (896 × 128),
    whose exception the plan's docstring gives: 14 K-steps over 8 column
    tiles of 16 cannot reach 132 blocks in clusters of at most 8."""
    p = bb.plan(m, k, n, 2, 8)
    if (k, n) == (896, 128):
        assert "wk/wv (896 × 128)" in bb.plan.__doc__
        assert p.block_n == min(bb.BLOCK_NS) and p.splits == 7
        assert p.blocks == 56
    else:
        assert p.blocks >= bb.SMS, p


@pytest.mark.parametrize("k,n", PATH_KN)
@pytest.mark.parametrize("m", BATCHED_M)
@pytest.mark.parametrize("g,r", [(1, 1), (2, 8), (6, 8), (6, 64)])
def test_batched_plan_cluster_and_shared_memory_fit(m, k, n, g, r):
    p = bb.plan(m, k, n, g, r)
    assert p.splits <= bb.MAX_CLUSTER        # a portable cluster size
    assert p.smem_bytes <= bb.SMEM_LIMIT
    # the most the kernel instance may be given, its smem attribute, fits
    most = max(bb.smem_bytes(p.m_pad, ut, bn, bb.STAGES[p.m_pad, bn], s,
                             bb.MAX_RANK)
               for bn in bb.BLOCK_NS for ut in (0, 1, 4)
               for s in range(1, bb.MAX_CLUSTER + 1))
    assert most <= bb.SMEM_LIMIT
    assert p.u_tiles == (0 if g * r > bb.MAX_STACKED_RANKS
                         else 1 if g * r <= 16 else 4)
    if p.u_tiles:
        assert 16 * p.u_tiles >= g * r


def test_batched_plan_does_not_depend_on_rows_or_adapters():
    """A row's arithmetic must not change with the rows batched beside it:
    the tiling and the K-splits are a function of K and N alone."""
    for k, n in PATH_KN + [(97, 1001), (4863, 129)]:
        tilings = {bb.plan(m, k, n, g, r)[:3] for m in (1, 5, 13, 64, 200)
                   for g, r in ((1, 1), (2, 8), (6, 64))}
        assert len(tilings) == 1, (k, n, tilings)


def test_batched_plan_rows_pad_and_chunk():
    assert [bb.m_pad(m) for m in (1, 8, 9, 16, 17, 33, 64, 65, 500)] == \
        [8, 8, 64, 64, 64, 64, 64, 64, 64]
    p = bb.plan(130, 896, 896, 2, 8)               # three chunks of ≤ 64
    assert p.blocks == 3 * bb.plan(64, 896, 896, 2, 8).blocks


def test_batched_plan_path_tilings():
    """The widths the plan picks on Qwen2-0.5B's linears (PERF.md)."""
    got = {(k, n): bb.plan(4, k, n, 2, 8)[:3] for k, n in PATH_KN}
    assert got == {(896, 896): (32, 7, 128), (896, 128): (16, 7, 128),
                   (896, 4864): (64, 4, 256), (4864, 896): (32, 8, 640)}


BART_DECODE_KN = [(768, 768), (768, 3072), (3072, 768)]   # q/k/v/o, fc1, fc2
F32_KN = BART_DECODE_KN + PATH_KN + [(97, 1001), (4863, 129), (30, 5),
                                     (0, 7)]


@pytest.mark.parametrize("k,n", F32_KN)
def test_f32_batched_plan_slices_cover_k_none_empty(k, n):
    """The float32 body's K-slices are whole stages of its tile width
    (8 KB of W: 2048 / block_n K-rows), cover K with none empty, form a
    portable cluster, and keep no more ring stages than a slice has."""
    for m in (1, 4, 8, 13, 64):
        p = bb.f32_plan(m, k, n, 2, 8)
        bk = bb.f32_block_k(p.block_n)
        assert p.block_n in bb.BLOCK_NS and bk * p.block_n == 2048
        assert p.k_slice >= bk and p.k_slice % bk == 0
        assert p.splits * p.k_slice >= k
        assert (p.splits - 1) * p.k_slice < max(k, 1)  # the last has rows
        assert 1 <= p.splits <= bb.MAX_CLUSTER
        assert 1 <= p.stages <= bb.F32_STAGES[p.u_tiles]
        assert p.stages <= p.k_slice // bk
        assert p.m_pad == (4 if m <= 4 else 8)
        assert p.blocks == _cdiv(n, p.block_n) * p.splits * _cdiv(m, p.m_pad)


@pytest.mark.parametrize("g,r", [(1, 1), (1, 12), (2, 8), (6, 12), (1, 64),
                                 (6, 64)])
def test_f32_batched_plan_shared_memory_fits(g, r):
    """Every call's plan fits the block's shared memory, and so does the
    most that any instance may be given (every row chunk, stacked-A tiling,
    tile width and cluster size at rank 64), which the kernel sets as its
    limit; the stack is staged up to 64 ranks and gathered above."""
    for k, n in F32_KN:
        for m in (1, 4, 8, 13):
            p = bb.f32_plan(m, k, n, g, r)
            assert p.smem_bytes <= bb.SMEM_LIMIT
            assert p.u_tiles == bb.u_tiles(g * r)
            assert 16 * p.u_tiles >= g * r or p.u_tiles == 0
    most = max(bb.f32_smem_bytes(mp, ut, bn, bb.F32_STAGES[ut], s,
                                 bb.MAX_RANK)
               for mp in (4, 8) for ut in (0, 1, 4) for bn in bb.BLOCK_NS
               for s in range(1, bb.MAX_CLUSTER + 1))
    assert most <= bb.SMEM_LIMIT


@pytest.mark.parametrize("k,n", BART_DECODE_KN)
def test_f32_batched_plan_fills_the_card_at_bart_decode(k, n):
    """At least one block per SM, and no more than one wave of clusters."""
    p = bb.f32_plan(4, k, n, 1, 12)
    assert bb.SMS <= p.blocks <= bb.F32_WAVE_BLOCKS, p


def test_f32_batched_plan_does_not_depend_on_rows_or_adapters():
    """A row served alone must equal the same row in a batch: the tiling
    and the K-splits are a function of K and N alone."""
    for k, n in F32_KN:
        tilings = {bb.f32_plan(m, k, n, g, r)[:3] for m in (1, 4, 5, 13, 64)
                   for g, r in ((1, 1), (1, 12), (2, 8), (6, 64))}
        assert len(tilings) == 1, (k, n, tilings)


def test_f32_batched_plan_bart_tilings():
    """The tilings at BART-base's decode linears (PERF.md): (block_n,
    splits, k_slice, stages, blocks) at M = 4, G = 1, r = 12."""
    got = {kn: bb.f32_plan(4, *kn, 1, 12)[:5] for kn in BART_DECODE_KN}
    assert got == {(768, 768): (32, 6, 128, 2, 144),
                   (768, 3072): (64, 4, 192, 6, 192),
                   (3072, 768): (32, 8, 384, 6, 192)}


def test_f32_batched_plan_rows_pad_and_chunk():
    assert [bb.f32_m_pad(m) for m in (1, 4, 5, 8, 9, 64)] == [4, 4, 8, 8, 8, 8]
    p = bb.f32_plan(13, 768, 768, 1, 12)             # two chunks of ≤ 8
    assert p.blocks == 2 * bb.f32_plan(8, 768, 768, 1, 12).blocks
    assert bb.f32_plan(4, 768, 768, 1, 12).blocks == \
        bb.f32_plan(8, 768, 768, 1, 12).blocks


@pytest.mark.parametrize("c", [2, 3, 4])
@pytest.mark.parametrize("m,k,n", TRAIN_MKN + [(800, 768, 768),
                                               (33, 3072, 768), (1, 30, 5)])
def test_grouped_f32_plan_tiles_each_client_and_slices_k(c, m, k, n):
    """The client-grouped instance: 64×64 tiles over every client's rows,
    K-slices of at most 48 f32 K-steps covering K with none empty, and a
    workspace of C times the single call's partials when it splits."""
    block_k = TILINGS[torch.float32].block_k
    p = plan(m, k, n, torch.float32, clients=c)
    assert (p.block_m, p.block_n) == (64, 64)
    assert p.k_slice % block_k == 0 and p.k_slice <= 48 * block_k
    assert p.splits * p.k_slice >= k > (p.splits - 1) * p.k_slice
    assert p.blocks == c * _cdiv(m, 64) * _cdiv(n, 64) * p.splits
    assert p.workspace_bytes(m, n, 12, clients=c) == (
        4 * p.splits * c * m * (n + 12) if p.splits > 1 else 0)
    assert plan(m, k, n, torch.float32, clients=1) == plan(m, k, n,
                                                           torch.float32)
    with pytest.raises(ValueError, match="float32"):
        plan(m, k, n, torch.bfloat16, clients=c)


# ------------------------------------------------------------- flash ----

fa = importlib.import_module("repro_torch.kernels.flash_attention")
QWEN = (14, 2, 64)                  # Qwen2-0.5B: 14 q / 2 kv heads of 64


def test_flash_qwen2_training_call_takes_the_widest_wgmma_tile():
    """Qwen2's causal GQA call at 8 × 512 in bf16: the wgmma body, 4
    consumer warpgroups (256-row query tiles, 224 of them), one block per
    SM walking them."""
    h, _, hd = QWEN
    p = fa.plan(torch.bfloat16, 8, h, 512, 512, hd)
    assert p == fa.Plan("wgmma", 4, SMS)
    assert p.code == 4 | SMS << 8


@pytest.mark.parametrize("s", [32, 37, 64, 128, 100])
def test_flash_serving_prefill_takes_the_narrowest_wgmma_tile(s):
    """One prompt chunk (B = 1, 14 heads): too few query tiles to fill the
    card at any width, so 2 consumer warpgroups (128 rows) and one block
    per tile; the chip's sweep timed it faster than mma_kernel there."""
    h, _, hd = QWEN
    p = fa.plan(torch.bfloat16, 1, h, s, s, hd)
    assert (p.kernel, p.consumers) == ("wgmma", 2)
    assert p.blocks == h * _cdiv(s, 128) <= SMS


@pytest.mark.parametrize("b,h,sq,sk,hd", [
    (8, 12, 256, 256, 64), (8, 12, 256, 384, 64), (8, 14, 512, 512, 64),
    (1, 14, 128, 128, 64), (2, 4, 300, 300, 128), (8, 12, 128, 128, 64)])
def test_flash_f32_calls_keep_the_tf32_body(b, h, sq, sk, hd):
    assert fa.plan(torch.float32, b, h, sq, sk, hd) == fa.Plan("mma")
    assert fa.Plan("mma").code == 0


@pytest.mark.parametrize("hd", [16, 32])
@pytest.mark.parametrize("s", [64, 512])
def test_flash_small_head_dims_keep_mma_kernel(hd, s):
    assert fa.plan(torch.bfloat16, 8, 4, s, s, hd) == fa.Plan("mma")


@pytest.mark.parametrize("s,sk", [(31, 31), (16, 512), (1, 1), (512, 0)])
def test_flash_short_or_keyless_calls_keep_mma_kernel(s, sk):
    assert fa.plan(torch.bfloat16, 1, 14, s, sk, 64) == fa.Plan("mma")


def _views(*shapes, offset=0, pad=0):
    """(tensor, (batch, head, seq) strides) of (B, S, H, hd) bf16 views."""
    out = []
    for b, s, h, hd in shapes:
        buf = torch.empty(b * s * h * (hd + pad) + offset, dtype=torch.bfloat16)
        t = buf[offset:].view(b, s, h, hd + pad)[..., :hd]
        out.append((t, (t.stride(0), t.stride(2), t.stride(1))))
    return out


@pytest.mark.parametrize("offset,pad,aligned", [(0, 0, True), (0, 8, True),
                                                (1, 0, False), (0, 4, False),
                                                (8, 0, True)])
def test_flash_unaligned_views_take_mma_kernel(offset, pad, aligned):
    """TMA needs 16-byte bases and strides: a view one element off a
    16-byte boundary, or with rows of hd + 4, goes to mma_kernel."""
    views = _views((8, 512, 14, 64), (8, 512, 2, 64), offset=offset, pad=pad)
    assert fa.tma_aligned(*views) is aligned
    p = fa.plan(torch.bfloat16, 8, 14, 512, 512, 64, aligned)
    assert p.kernel == ("wgmma" if aligned else "mma")


@pytest.mark.parametrize("b", [1, 2, 8])
@pytest.mark.parametrize("h,hd", [(14, 64), (12, 64), (8, 128), (4, 128)])
@pytest.mark.parametrize("s", [64, 100, 128, 192, 256, 384, 500, 512, 513,
                               1024])
def test_flash_wgmma_plans_are_built_instances_that_fit(b, h, hd, s):
    """Every wgmma plan names a built instance, no query tile is taller than
    the sequence unless it is the narrowest, a wider tile is taken only
    where its tiles fill WGMMA_FILL of the SMs, and the grid is at most one
    block per SM (and at most one per tile)."""
    p = fa.plan(torch.bfloat16, b, h, s, s, hd)
    assert p.kernel == "wgmma"
    assert p.consumers in fa.WGMMA_CONSUMERS[hd]
    narrowest = fa.WGMMA_CONSUMERS[hd][-1]
    tiles = b * h * _cdiv(s, 64 * p.consumers)
    if p.consumers != narrowest:
        assert 64 * p.consumers <= s and tiles >= fa.WGMMA_FILL * SMS
    wider = [c for c in fa.WGMMA_CONSUMERS[hd] if c > p.consumers]
    for c in wider:                 # a wider tile was not possible
        assert 64 * c > s or b * h * _cdiv(s, 64 * c) < fa.WGMMA_FILL * SMS
    assert p.blocks == min(tiles, SMS)


def test_flash_wgmma_plan_refuses_an_instance_not_built():
    with pytest.raises(ValueError, match="no wgmma instance"):
        fa.wgmma_plan(8, 8, 512, 128, consumers=4)
    with pytest.raises(ValueError, match="no wgmma instance"):
        fa.wgmma_plan(8, 14, 512, 64, consumers=1)


@pytest.mark.parametrize("header", ["mma.cuh", "tma_map.cuh", "wgmma.cuh"])
def test_each_shared_header_is_hashed_into_every_build_target(
        tmp_path, monkeypatch, header):
    """bea_fused.cu and flash_attention.cu both include tma_map.cuh and
    wgmma.cuh: an edit to any shared header rebuilds every library."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {name: _build.target(name) for name in _build.SOURCES}
    (csrc / header).write_text((csrc / header).read_text() + "\n// edited\n")
    assert all(_build.target(n) != before[n] for n in _build.SOURCES)


# ------------------------------------------------------------- Gemma ----
# LM training of Gemma2-2B at 8 × 512 and Gemma3-1B at 4 × 1024 tokens:
# 4096 rows through each of a layer's 7 linears (q, k/v, o, gate/up, down),
# and flash at head dim 256 (8 q / 4 kv heads; 4 q / 1 kv head).

GEMMA_PLANS = {  # (k, n): (block_n, splits, blocks) at 4096 rows, rank 8
    (2304, 2048): (256, 1, 132), (2304, 1024): (256, 1, 128),
    (2048, 2304): (128, 1, 132), (2304, 9216): (256, 1, 132),
    (9216, 2304): (128, 1, 132),                            # Gemma2-2B
    (1152, 1024): (256, 1, 128), (1152, 256): (128, 1, 64),
    (1024, 1152): (128, 1, 132), (1152, 6912): (256, 1, 132),
    (6912, 1152): (128, 1, 132)}                            # Gemma3-1B


@pytest.mark.parametrize("k,n", sorted(GEMMA_PLANS))
def test_gemma_linears_take_the_wgmma_plan(k, n):
    """Every Gemma linear at 4096 rows gets the wgmma plan under the same
    rules as Qwen2's (its tiles, ring, K slices and grid), pinned here at
    rank 8: K whole, one block per SM or one per tile."""
    test_training_rows_take_the_wgmma_plan(4096, k, n)
    p = plan(4096, k, n, rank=8)
    assert (p.block_m, p.block_n, p.splits, p.blocks) == (
        WGMMA_BLOCK_M, *GEMMA_PLANS[(k, n)])
    assert p.k_slice == k


@pytest.mark.parametrize("b,h,s,blocks", [(8, 8, 512, SMS), (4, 4, 1024, 128),
                                          (2, 8, 1024, 128), (1, 4, 64, 4)])
def test_flash_hd256_takes_the_two_consumer_wgmma_instance(b, h, s, blocks):
    """Head dim 256 has one wgmma instance, 2 consumer warpgroups (128-row
    query tiles): Gemma2's call (8 × 512, 8 heads), Gemma3's (4 × 1024, 4
    heads: 128 tiles), a binding-window call and a short one."""
    p = fa.plan(torch.bfloat16, b, h, s, s, 256)
    assert p == fa.Plan("wgmma", 2, blocks)
    assert p.code == 2 | blocks << 8
    test_flash_wgmma_plans_are_built_instances_that_fit(b, h, 256, s)


def test_flash_hd256_short_strided_and_f32_calls():
    """Under 32 query rows or through views TMA cannot load, head dim 256
    goes to mma_kernel<256>; float32 has no body at 256 and raises."""
    assert fa.plan(torch.bfloat16, 1, 4, 20, 20, 256) == fa.Plan("mma")
    assert fa.plan(torch.bfloat16, 4, 4, 1024, 1024, 256, False) == \
        fa.Plan("mma")
    with pytest.raises(ValueError, match="queue 2 item 1"):
        fa.plan(torch.float32, 4, 4, 1024, 1024, 256)
    with pytest.raises(ValueError, match="no wgmma instance"):
        fa.wgmma_plan(8, 8, 512, 256, consumers=4)
    assert 256 in fa.HEAD_DIMS and 256 not in fa.F32_HEAD_DIMS
