"""The CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch with CUDA:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Without a card every test skips with its reason (a skip is not a pass):
CUDA kernels have no CPU mode.  Inputs come from numpy with a seed; the
plain versions run in float32 on the same (rounded) inputs.
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.kernels import ref
from repro_torch.kernels.bea_batched import bea_batched
from repro_torch.kernels.bea_fused import bea_dense
from repro_torch.kernels.bea_fused import BeaDense
from repro_torch.kernels.flash_attention import (FlashAttention, Plan,
                                                 flash_attention, mha_flash)

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # relative to max |plain|


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rand(rng, *shape, scale=1.0, dtype=torch.float32, device="cpu"):
    a = rng.normal(size=shape).astype(np.float32) * scale
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _close(got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype] * max(want.abs().max().item(), 1e-6), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,r", [(128, 896, 4864, 8), (100, 4864, 896, 4),
                                     (33, 48, 65, 3), (1, 30, 5, 1),
                                     (7, 896, 128, 64)])
def test_bea_dense_matches_plain(cuda, dtype, m, k, n, r):
    rng = np.random.default_rng(m + k + n + r)
    x, w = _rand(rng, m, k, dtype=dtype, device=cuda), \
        _rand(rng, k, n, scale=k ** -0.5, dtype=dtype, device=cuda)
    a, b = _rand(rng, r, k, scale=k ** -0.5, dtype=dtype, device=cuda), \
        _rand(rng, n, r, dtype=dtype, device=cuda)
    e = _rand(rng, r, device=cuda)
    mask = torch.from_numpy(rng.integers(0, 2, r).astype(bool)).to(cuda)
    K.reset_launches()
    got = bea_dense(x, w, a, b, e, mask, 2.0)
    torch.cuda.synchronize()
    assert K.launch_counts()["bea_dense"] == 1
    want = ref.bea_dense_ref(x.float(), w.float(), a.float(), b.float(), e,
                             mask, 2.0)
    _close(got, want, dtype)


PATH_KN = [(896, 896), (896, 128), (896, 4864), (4864, 896)]


def _dense_operands(rng, m, k, n, r, dtype, device):
    x = _rand(rng, m, k, dtype=dtype, device=device)
    w = _rand(rng, k, n, scale=k ** -0.5, dtype=dtype, device=device)
    a = _rand(rng, r, k, scale=k ** -0.5, dtype=dtype, device=device)
    b = _rand(rng, n, r, dtype=dtype, device=device)
    e = _rand(rng, r, device=device)
    mask = torch.from_numpy(rng.integers(0, 2, r).astype(bool)).to(device)
    mask[0] = True
    return x, w, a, b, e, mask


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", PATH_KN)
@pytest.mark.parametrize("m,r", [(128, 8), (64, 4), (1, 8), (100, 64)])
def test_bea_dense_bf16_tensor_cores_at_path_shapes(cuda, m, k, n, r):
    """The bf16 kernel at every serving linear, under the plan's tilings
    (split and unsplit, 64×64 down to 16×32 tiles)."""
    rng = np.random.default_rng(m * 7 + k + n + r)
    ops = _dense_operands(rng, m, k, n, r, torch.bfloat16, cuda)
    got = bea_dense(*ops, 2.0)
    want = ref.bea_dense_ref(*(t.float() if t.dtype == torch.bfloat16 else t
                               for t in ops), 2.0)
    _close(got, want, torch.bfloat16)


def _graph_of(fn):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(128, 4864, 896), (64, 896, 128),
                                   (128, 896, 4864)])
def test_bea_dense_bf16_is_deterministic_and_graph_safe(cuda, m, k, n):
    """Repeated calls are bitwise equal (the K-splits are summed in a fixed
    order, no atomics); a CUDA-graph replay equals the eager call, and eager
    calls of other shapes between replays, which share the split-K
    workspace, do not disturb it."""
    rng = np.random.default_rng(11)
    ops = _dense_operands(rng, m, k, n, 8, torch.bfloat16, cuda)
    other = _dense_operands(rng, 100, 4864, 896, 4, torch.bfloat16, cuda)
    first = bea_dense(*ops, 2.0)
    bea_dense(*other, 1.0)                            # reuses the workspace
    assert torch.equal(bea_dense(*ops, 2.0), first)
    graph, captured = _graph_of(lambda: bea_dense(*ops, 2.0))
    for _ in range(3):
        graph.replay()
        bea_dense(*other, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(captured, first)


@pytest.mark.cuda
def test_bea_dense_shares_the_batched_workspace(cuda):
    """bea_dense draws on one grow-only buffer per stream, reused across
    calls; a capture takes its own.  bea_batched takes none in either type
    (both sum their K-splits inside a cluster): its calls between bea_dense
    calls neither draw, regrow nor replace that buffer."""
    from repro_torch.kernels import _scratch
    from repro_torch.kernels.bea_fused import plan

    rng = np.random.default_rng(5)
    ops = _dense_operands(rng, 128, 4864, 896, 8, torch.bfloat16, cuda)
    need = plan(128, 4864, 896).workspace_bytes(128, 896, 8)
    assert need > 0
    bea_dense(*ops, 2.0)
    key = (ops[0].device.index, torch.cuda.current_stream().cuda_stream)
    buf = _scratch._BUFFERS[key]
    assert buf.numel() >= need
    for dt in (torch.float32, torch.bfloat16):
        small = _batched_operands(rng, 4, 896, 128, 2, 8, dt, cuda)
        before = dict(_scratch._BUFFERS)
        bea_batched(*small, 1.5)
        assert _scratch._BUFFERS.keys() == before.keys()
        assert all(_scratch._BUFFERS[k] is v for k, v in before.items())
        bea_dense(*ops, 2.0)
        assert _scratch._BUFFERS[key] is buf            # shared, not regrown
    graph, _ = _graph_of(lambda: bea_dense(*ops, 2.0))
    assert _scratch._BUFFERS[key] is buf                # capture took its own
    del graph


@pytest.mark.cuda
def test_bea_dense_bf16_fully_masked_is_plain_matmul(cuda):
    rng = np.random.default_rng(3)
    x, w, a, b, e, _ = _dense_operands(rng, 64, 896, 896, 8, torch.bfloat16,
                                       cuda)
    got = bea_dense(x, w, a, b, e, torch.zeros(8, dtype=torch.bool,
                                               device=cuda), 3.0)
    _close(got, x.float() @ w.float(), torch.bfloat16)


def _batched_operands(rng, m, k, n, g, r, dtype, device):
    x = _rand(rng, m, k, dtype=dtype, device=device)
    w = _rand(rng, k, n, scale=k ** -0.5, dtype=dtype, device=device)
    a = _rand(rng, g, r, k, scale=k ** -0.5, dtype=dtype, device=device)
    b = _rand(rng, g, n, r, dtype=dtype, device=device)
    e = _rand(rng, g, r, device=device)
    mask = torch.from_numpy(rng.integers(0, 2, (g, r)).astype(bool)).to(device)
    mask[:, 0] = True
    if g >= 2:
        mask[1] = False                           # a fully pruned tenant
    idx = torch.from_numpy(rng.integers(0, g, m).astype(np.int32)).to(device)
    return x, w, a, b, e, mask, idx


def _batched_plain(ops, scaling):
    return ref.bea_batched_ref(*(t.float() if t.is_floating_point()
                                 and t.dtype != torch.float32 else t
                                 for t in ops), scaling)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,g,r", [(4, 896, 4864, 2, 8), (3, 4864, 896, 1, 4),
                                       (13, 896, 128, 3, 8), (5, 24, 40, 6, 64)])
def test_bea_batched_matches_plain(cuda, dtype, m, k, n, g, r):
    rng = np.random.default_rng(m + k + n + g + r)
    x, w = _rand(rng, m, k, dtype=dtype, device=cuda), \
        _rand(rng, k, n, scale=k ** -0.5, dtype=dtype, device=cuda)
    a = _rand(rng, g, r, k, scale=k ** -0.5, dtype=dtype, device=cuda)
    b = _rand(rng, g, n, r, dtype=dtype, device=cuda)
    e = _rand(rng, g, r, device=cuda)
    mask = torch.from_numpy(rng.integers(0, 2, (g, r)).astype(bool)).to(cuda)
    if g >= 2:
        mask[1] = False                           # a fully pruned tenant
    idx = torch.from_numpy(rng.integers(0, g, m).astype(np.int32)).to(cuda)
    K.reset_launches()
    got = bea_batched(x, w, a, b, e, mask, idx, 1.5)
    assert K.launch_counts()["bea_batched"] == 1
    want = ref.bea_batched_ref(x.float(), w.float(), a.float(), b.float(), e,
                               mask, idx, 1.5)
    _close(got, want, dtype)
    # a row's result does not depend on the rows batched with it
    solo = bea_batched(x[:1].contiguous(), w, a, b, e, mask, idx[:1], 1.5)
    assert torch.equal(solo, got[:1])


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", PATH_KN)
@pytest.mark.parametrize("m", [1, 4, 8, 13, 64])
def test_bea_batched_bf16_at_path_shapes(cuda, m, k, n):
    """The one-launch bf16 kernel at every serving linear, for every row
    count it pads to, over 1, 2 and 6 tenants at ranks 1 to 64 (G·r past
    64 gathers each row's adapter); every row equals itself served alone."""
    bf = torch.bfloat16
    for g in (1, 2, 6):
        for r in (1, 4, 8, 64):
            rng = np.random.default_rng(m * 31 + k + n + g * 7 + r)
            ops = _batched_operands(rng, m, k, n, g, r, bf, cuda)
            got = bea_batched(*ops, 1.5)
            _close(got, _batched_plain(ops, 1.5), bf)
            for i in {0, m // 2, m - 1}:
                solo = bea_batched(ops[0][i:i + 1].contiguous(), *ops[1:6],
                                   ops[6][i:i + 1].contiguous(), 1.5)
                assert torch.equal(solo, got[i:i + 1]), (g, r, i)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,g,r", [(4, 4864, 896, 2, 8), (64, 896, 4864, 2, 8),
                                       (8, 896, 128, 6, 64), (100, 896, 896, 3, 4)])
def test_bea_batched_bf16_is_deterministic_and_graph_safe(cuda, m, k, n, g, r):
    """Two calls give the same bits (the K-splits are summed in split
    order inside the cluster, no atomics) and a CUDA-graph replay equals
    the eager call, with eager calls of other shapes between replays."""
    rng = np.random.default_rng(13)
    ops = _batched_operands(rng, m, k, n, g, r, torch.bfloat16, cuda)
    other = _batched_operands(rng, 13, 4864, 896, 3, 8, torch.bfloat16, cuda)
    first = bea_batched(*ops, 1.5)
    _close(first, _batched_plain(ops, 1.5), torch.bfloat16)
    bea_batched(*other, 1.0)
    assert torch.equal(bea_batched(*ops, 1.5), first)
    graph, captured = _graph_of(lambda: bea_batched(*ops, 1.5))
    for _ in range(3):
        graph.replay()
        bea_batched(*other, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(captured, first)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bea_batched_idx_outside_the_stack_gets_no_adapter(cuda, dtype):
    rng = np.random.default_rng(17)
    x, w, a, b, e, mask, _ = _batched_operands(rng, 6, 896, 896, 3, 8, dtype,
                                               cuda)
    mask[:] = True
    idx = torch.tensor([0, -1, 3, 2, 7, 1], dtype=torch.int32, device=cuda)
    got = bea_batched(x, w, a, b, e, mask, idx, 2.0)
    dense = x.float() @ w.float()
    for i in (1, 2, 4):                           # outside [0, 3)
        _close(got[i], dense[i], dtype)
    for i in (0, 3, 5):
        want = ref.bea_dense_ref(x[i:i + 1].float(), w.float(),
                                 a[idx[i]].float(), b[idx[i]].float(),
                                 e[idx[i]], mask[idx[i]], 2.0)
        _close(got[i:i + 1], want, dtype)
        assert (got[i].float() - dense[i]).abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,g,r", [(5, 895, 131, 2, 8), (9, 97, 1001, 3, 5),
                                       (1, 30, 5, 1, 1), (64, 4863, 129, 2, 64)])
def test_bea_batched_bf16_ragged_and_offset(cuda, m, k, n, g, r):
    """Odd K and N take plain loads instead of cp.async; so does a W that
    starts 2 bytes past an aligned address (a view into a larger buffer)."""
    bf = torch.bfloat16
    rng = np.random.default_rng(m + k + n)
    ops = list(_batched_operands(rng, m, k, n, g, r, bf, cuda))
    _close(bea_batched(*ops, 1.5), _batched_plain(ops, 1.5), bf)
    kk, nn = 896, 896
    ops = list(_batched_operands(rng, m, kk, nn, g, r, bf, cuda))
    flat = torch.empty(kk * nn + 1, dtype=bf, device=cuda)
    off = flat[1:].view(kk, nn)
    off.copy_(ops[1])
    assert off.data_ptr() % 16 != 0
    want = bea_batched(*ops, 1.5)
    ops[1] = off
    got = bea_batched(*ops, 1.5)
    _close(got, _batched_plain(ops, 1.5), bf)
    assert torch.equal(got, want)


BART_DECODE_KN = [(768, 768), (768, 3072), (3072, 768)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", BART_DECODE_KN + PATH_KN)
@pytest.mark.parametrize("m", [1, 4, 8, 13, 64])
def test_bea_batched_f32_at_decode_shapes(cuda, m, k, n):
    """The f32 ``fma_kernel`` at BART-base's and Qwen2-0.5B's decode
    linears, for every row count (chunks of 4 or 8 rows), over 1, 2 and 6
    tenants at ranks 1 to 64 (G·r past 64 gathers each row's adapter),
    one launch a call; every checked row equals itself served alone."""
    for g in (1, 2, 6):
        for r in (1, 4, 12, 64):
            rng = np.random.default_rng(m * 31 + k + n + g * 7 + r)
            ops = _batched_operands(rng, m, k, n, g, r, torch.float32, cuda)
            K.reset_launches()
            got = bea_batched(*ops, 1.5)
            assert K.launch_counts()["bea_batched"] == 1
            _close(got, _batched_plain(ops, 1.5), torch.float32)
            for i in {0, m // 2, m - 1}:
                solo = bea_batched(ops[0][i:i + 1].contiguous(), *ops[1:6],
                                   ops[6][i:i + 1].contiguous(), 1.5)
                assert torch.equal(solo, got[i:i + 1]), (g, r, i)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,g,r", [(4, 3072, 768, 1, 12), (4, 768, 3072, 1, 12),
                                       (13, 4864, 896, 2, 8), (8, 896, 128, 6, 64)])
def test_bea_batched_f32_is_deterministic_and_graph_safe(cuda, m, k, n, g, r):
    """Two calls give the same bits (the K-splits are summed in split
    order inside the cluster, no atomics) and a CUDA-graph replay equals
    the eager call, with eager calls of other shapes between replays."""
    rng = np.random.default_rng(19)
    ops = _batched_operands(rng, m, k, n, g, r, torch.float32, cuda)
    other = _batched_operands(rng, 5, 768, 3072, 3, 12, torch.float32, cuda)
    first = bea_batched(*ops, 1.5)
    _close(first, _batched_plain(ops, 1.5), torch.float32)
    bea_batched(*other, 1.0)
    assert torch.equal(bea_batched(*ops, 1.5), first)
    graph, captured = _graph_of(lambda: bea_batched(*ops, 1.5))
    for _ in range(3):
        graph.replay()
        bea_batched(*other, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(captured, first)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,g,r", [(5, 895, 131, 2, 8), (9, 97, 1001, 3, 5),
                                       (1, 30, 5, 1, 1), (4, 767, 770, 1, 12),
                                       (64, 4863, 129, 2, 64)])
def test_bea_batched_f32_ragged_and_offset(cuda, m, k, n, g, r):
    """K or N not a multiple of 4 takes 4-byte copies instead of 16-byte
    ones; so does a W that starts 4 bytes past an aligned address (a view
    into a larger buffer), with the same bits."""
    f32 = torch.float32
    rng = np.random.default_rng(m + k + n)
    ops = list(_batched_operands(rng, m, k, n, g, r, f32, cuda))
    _close(bea_batched(*ops, 1.5), _batched_plain(ops, 1.5), f32)
    kk, nn = 768, 768
    ops = list(_batched_operands(rng, m, kk, nn, g, r, f32, cuda))
    flat = torch.empty(kk * nn + 1, dtype=f32, device=cuda)
    off = flat[1:].view(kk, nn)
    off.copy_(ops[1])
    assert off.data_ptr() % 16 == 4
    want = bea_batched(*ops, 1.5)
    ops[1] = off
    got = bea_batched(*ops, 1.5)
    _close(got, _batched_plain(ops, 1.5), f32)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_bea_batched_scratch_is_reused_and_graph_safe(cuda, monkeypatch):
    """Neither body takes scratch: eager calls of any shape on one stream,
    and a CUDA-graph capture, never ask ``kernels/_scratch.py`` for a
    buffer, and eager calls of other shapes between replays do not
    disturb the graph's result."""
    from repro_torch.kernels import _scratch

    drawn = []
    real = _scratch.workspace
    monkeypatch.setattr(_scratch, "workspace",
                        lambda *a, **kw: drawn.append(a) or real(*a, **kw))
    rng = np.random.default_rng(7)
    for dt in (torch.float32, torch.bfloat16):
        small = _batched_operands(rng, 4, 896, 128, 2, 8, dt, cuda)
        big = _batched_operands(rng, 8, 4864, 896, 2, 8, dt, cuda)
        before = dict(_scratch._BUFFERS)
        first = bea_batched(*small, 1.5)
        _close(bea_batched(*big, 1.5), _batched_plain(big, 1.5), dt)
        assert torch.equal(bea_batched(*small, 1.5), first)
        _close(first, _batched_plain(small, 1.5), dt)
        graph, captured = _graph_of(lambda: bea_batched(*small, 1.5))
        for _ in range(3):
            graph.replay()
            bea_batched(*big, 1.5)
        torch.cuda.synchronize()
        assert torch.equal(captured, first)
        assert _scratch._BUFFERS.keys() == before.keys()
        assert all(_scratch._BUFFERS[k] is v for k, v in before.items())
    assert drawn == []


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,hd,causal,window,cap", [
    (1, 128, 14, 2, 64, True, 0, 0.0), (1, 100, 14, 2, 64, True, 0, 0.0),
    (2, 37, 4, 2, 32, True, 0, 0.0), (1, 256, 4, 1, 64, True, 32, 0.0),
    (2, 128, 4, 4, 32, False, 0, 0.0), (1, 130, 6, 3, 16, True, 48, 30.0),
    (1, 300, 4, 2, 128, True, 0, 0.0), (1, 128, 14, 2, 64, True, 48, 0.0),
    (1, 100, 14, 2, 64, True, 0, 30.0), (2, 200, 8, 2, 128, False, 64, 20.0)])
def test_flash_matches_plain(cuda, dtype, b, s, h, kv, hd, causal, window,
                             cap):
    rng = np.random.default_rng(b * 1000 + s + hd)
    q = _rand(rng, b, s, h, hd, dtype=dtype, device=cuda)
    k = _rand(rng, b, s, kv, hd, dtype=dtype, device=cuda)
    v = _rand(rng, b, s, kv, hd, dtype=dtype, device=cuda)
    got = mha_flash(q, k, v, causal=causal, window=window, softcap=cap)
    g = h // kv
    want = ref.flash_attention_ref(
        q.float(), k.float().repeat_interleave(g, 2),
        v.float().repeat_interleave(g, 2), causal=causal, window=window,
        softcap=cap)
    _close(got, want, dtype)
    bh = flash_attention(q.transpose(1, 2).reshape(b * h, s, hd),
                         k.transpose(1, 2).reshape(b * kv, s, hd),
                         v.transpose(1, 2).reshape(b * kv, s, hd),
                         causal=causal, window=window, softcap=cap, group=g)
    assert torch.equal(bh.reshape(b, h, s, hd).transpose(1, 2), got)


@pytest.mark.cuda
def test_flash_bf16_is_deterministic_and_graph_safe(cuda):
    rng = np.random.default_rng(9)
    bf = torch.bfloat16
    q = _rand(rng, 1, 128, 14, 64, dtype=bf, device=cuda)
    k = _rand(rng, 1, 128, 2, 64, dtype=bf, device=cuda)
    v = _rand(rng, 1, 128, 2, 64, dtype=bf, device=cuda)
    first = mha_flash(q, k, v, causal=True)
    assert torch.equal(mha_flash(q, k, v, causal=True), first)
    graph, captured = _graph_of(lambda: mha_flash(q, k, v, causal=True))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)


@pytest.mark.cuda
@pytest.mark.parametrize("s,window,cap", [(512, 0, 0.0), (513, 128, 30.0)])
def test_flash_wgmma_is_deterministic_and_graph_safe(cuda, s, window, cap):
    """Qwen2's training call at 8 × 512 on the wgmma body (and a ragged,
    windowed, capped one): two calls give the same bits, and so does a
    CUDA-graph replay (its TMA maps captured by value)."""
    from repro_torch.kernels.flash_attention import plan
    rng = np.random.default_rng(s)
    bf = torch.bfloat16
    q = _rand(rng, 8, s, 14, 64, dtype=bf, device=cuda)
    k = _rand(rng, 8, s, 2, 64, dtype=bf, device=cuda)
    v = _rand(rng, 8, s, 2, 64, dtype=bf, device=cuda)
    assert plan(bf, 8, 14, s, s, 64).kernel == "wgmma"
    call = lambda: mha_flash(q, k, v, causal=True, window=window,  # noqa: E731
                             softcap=cap)
    first = call()
    assert torch.equal(call(), first)
    graph, captured = _graph_of(call)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)


@pytest.mark.cuda
def test_flash_strided_view_takes_mma_kernel(cuda):
    """Rows of hd + 4 elements are not 16-byte strides: TMA cannot load
    them, the plan leaves the call to mma_kernel, which still matches."""
    from repro_torch.kernels.flash_attention import plan, tma_aligned
    rng = np.random.default_rng(4)
    bf = torch.bfloat16
    q, k, v = (_rand(rng, 2, 512, n, 68, dtype=bf, device=cuda)[..., :64]
               for n in (14, 2, 2))
    views = [(t, (t.stride(0), t.stride(2), t.stride(1))) for t in (q, k, v)]
    assert not tma_aligned(*views)
    assert plan(bf, 2, 14, 512, 512, 64, False).kernel == "mma"
    want = ref.flash_attention_ref(q.float(), k.float().repeat_interleave(7, 2),
                                   v.float().repeat_interleave(7, 2))
    _close(mha_flash(q, k, v), want, bf)


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(4, 8, device=cuda)
    w = torch.zeros(8, 6, device=cuda)
    a, b = torch.zeros(2, 8, device=cuda), torch.zeros(6, 2, device=cuda)
    e, m = torch.zeros(2, device=cuda), torch.ones(2, dtype=torch.bool,
                                                    device=cuda)
    with pytest.raises(TypeError):
        bea_dense(x, w.double(), a, b, e, m)
    with pytest.raises(ValueError):
        bea_dense(x, w.T.contiguous().T, a, b, e, m)     # not contiguous
    with pytest.raises(ValueError):
        bea_dense(x, w[:7], a, b, e, m)                  # shapes disagree
    with pytest.raises(TypeError):
        bea_batched(x, w, a[None], b[None], e[None], m[None],
                    torch.zeros(4, dtype=torch.int64, device=cuda))
    q = torch.zeros(1, 8, 4, 48, device=cuda)
    with pytest.raises(ValueError):
        mha_flash(q, q[:, :, :2], q[:, :, :2])           # head dim 48


# ---- the training slice: f32 instances at its shapes, and one step --------

@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(768, 768), (768, 3072), (3072, 768)])
@pytest.mark.parametrize("m", [256, 100, 2048, 3072])
def test_bea_dense_f32_at_training_shapes(cuda, m, k, n):
    """r = 12 (the 3xTF32 body's 16-rank instance), one rank masked, and a
    fully masked adapter that must add exactly nothing; M = 2048 and 3072
    are BART-base's LM rows (8 × 256, and an encoder of 8 × 384), where
    the plan takes 128-row tiles with and without a K-split."""
    rng = np.random.default_rng(m + k + n)
    x, w = _rand(rng, m, k, device=cuda), \
        _rand(rng, k, n, scale=k ** -0.5, device=cuda)
    a = _rand(rng, 12, k, scale=k ** -0.5, device=cuda)
    b, e = _rand(rng, n, 12, device=cuda), _rand(rng, 12, device=cuda)
    mask = torch.ones(12, dtype=torch.bool, device=cuda)
    mask[5] = False
    got = bea_dense(x, w, a, b, e, mask, 16 / 12)
    _close(got, ref.bea_dense_ref(x, w, a, b, e, mask, 16 / 12),
           torch.float32)
    none = bea_dense(x, w, a, b, e, torch.zeros_like(mask), 16 / 12)
    _close(none, x @ w, torch.float32)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("s", [32, 100, 128])
def test_flash_f32_non_causal_at_training_shapes(cuda, s):
    rng = np.random.default_rng(s)
    q, k, v = (_rand(rng, 2, s, 12, 64, device=cuda) for _ in range(3))
    _close(mha_flash(q, k, v, causal=False),
           ref.flash_attention_ref(q, k, v, causal=False), torch.float32)


# ---- the f32 instances on 3xTF32 tensor cores ------------------------------

@pytest.mark.cuda
def test_bea_dense_f32_identity_weight_returns_x(cuda):
    """A unit case of the fragment layouts on 32-bit data: with W = I and no
    adapter y must be x, each value in its own place (ldmatrix of f32 rows
    hands each lane its m16n8k8 A fragment; a wrong lane mapping permutes
    y), and big + small must give x to f32 accuracy."""
    rng = np.random.default_rng(21)
    for m, k in ((16, 8), (128, 64), (1024, 768)):
        x = _rand(rng, m, k, device=cuda)
        a, b = torch.zeros(12, k, device=cuda), torch.zeros(k, 12, device=cuda)
        got = bea_dense(x, torch.eye(k, device=cuda), a, b,
                        torch.zeros(12, device=cuda),
                        torch.ones(12, dtype=torch.bool, device=cuda), 1.0)
        assert (got - x).abs().max().item() <= 1e-6 * x.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 100, 1024])
@pytest.mark.parametrize("k,n,r", [(768, 768, 12), (3072, 768, 12),
                                   (768, 3072, 16), (90, 70, 1),
                                   (770, 130, 33), (766, 768, 64)])
def test_bea_dense_f32_tensor_cores(cuda, m, k, n, r):
    """Every f32 tile and rank bucket under the plan, split and unsplit,
    K (and N) not a multiple of 4 among them (plain loads, no cp.async)."""
    from repro_torch.kernels.bea_fused import plan

    rng = np.random.default_rng(m + 3 * k + n + r)
    ops = _dense_operands(rng, m, k, n, r, torch.float32, cuda)
    K.reset_launches()
    got = bea_dense(*ops, 16 / 12)
    torch.cuda.synchronize()
    assert K.launch_counts()["bea_dense"] == 1
    _close(got, ref.bea_dense_ref(*ops, 16 / 12), torch.float32)
    p = plan(m, k, n, torch.float32)
    assert (p.block_m, p.block_n) in ((128, 64), (64, 64), (64, 32))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1024, 768, 768), (1024, 3072, 768),
                                   (1024, 768, 3072), (7, 90, 70)])
def test_bea_dense_f32_fully_masked_is_plain_matmul(cuda, m, k, n):
    rng = np.random.default_rng(4)
    x, w, a, b, e, mask = _dense_operands(rng, m, k, n, 12, torch.float32,
                                          cuda)
    got = bea_dense(x, w, a, b, e, torch.zeros_like(mask), 3.0)
    _close(got, x @ w, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1024, 768, 768), (1024, 3072, 768),
                                   (1024, 768, 3072), (2048, 768, 768),
                                   (2048, 3072, 768), (3072, 768, 768)])
def test_bea_dense_f32_is_deterministic_and_graph_safe(cuda, m, k, n):
    """As for bf16: the f32 K-splits go through the same workspace and are
    summed in a fixed order."""
    rng = np.random.default_rng(12)
    ops = _dense_operands(rng, m, k, n, 12, torch.float32, cuda)
    other = _dense_operands(rng, 100, 3072, 768, 4, torch.float32, cuda)
    first = bea_dense(*ops, 2.0)
    bea_dense(*other, 1.0)                            # reuses the workspace
    assert torch.equal(bea_dense(*ops, 2.0), first)
    graph, captured = _graph_of(lambda: bea_dense(*ops, 2.0))
    for _ in range(3):
        graph.replay()
        bea_dense(*other, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(captured, first)


def _bias(got, want):
    """How far ``got`` is scaled against ``want`` as a whole."""
    got = got.double()
    return ((got * want).sum() / (want * want).sum() - 1.0).item()


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(3072, 3072, 768), (2048, 768, 768),
                                   (2048, 768, 3072)])
def test_bea_dense_f32_sum_is_unbiased(cuda, m, k, n):
    """The tensor cores' accumulation truncates: fed the running sum, each
    MMA shrank it, by 1.9e-5 over K = 3072, within the 1e-4 tolerance of
    each value but compounding over layers.  Against float64 the output
    may not be scaled by more than 1e-6 as a whole."""
    rng = np.random.default_rng(m + k + n)
    ops = _dense_operands(rng, m, k, n, 12, torch.float32, cuda)
    want = ref.bea_dense_ref(*(t.double() if t.is_floating_point() else t
                               for t in ops), 16 / 12)
    assert abs(_bias(bea_dense(*ops, 16 / 12), want)) <= 1e-6


@pytest.mark.cuda
def test_flash_f32_sum_is_unbiased(cuda):
    rng = np.random.default_rng(23)
    q = _rand(rng, 8, 256, 12, 64, device=cuda)
    k, v = (_rand(rng, 8, 384, 12, 64, device=cuda) for _ in range(2))
    want = ref.flash_attention_ref(q.double(), k.double(), v.double(),
                                   causal=False)
    assert abs(_bias(mha_flash(q, k, v, causal=False), want)) <= 1e-6


@pytest.mark.cuda
def test_flash_f32_is_deterministic_and_graph_safe(cuda):
    rng = np.random.default_rng(10)
    q, k, v = (_rand(rng, 8, 128, 12, 64, device=cuda) for _ in range(3))
    first = mha_flash(q, k, v, causal=False)
    assert torch.equal(mha_flash(q, k, v, causal=False), first)
    graph, captured = _graph_of(lambda: mha_flash(q, k, v, causal=False))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)


@pytest.mark.cuda
def test_training_step_kernels_match_plain_on_mini(cuda):
    """One MINI forward + backward through the kernels and through the plain
    versions on the same weights: loss within 1e-5, every trainable grad
    within 1e-3 of its largest plain value, and 6 adapted linears and one
    attention per layer launched in the forward."""
    from repro_torch.configs.distilbert import MINI
    from repro_torch.models import Model
    from repro_torch.pytree import flatten_with_paths, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    kern, plain = Model(MINI), Model(MINI, use_kernels=False)
    base, tr = kern.init(0, cuda)
    tr = tree_map(lambda t: t + 0.1 * torch.randn_like(t), tr)
    masks = kern.init_masks(cuda)
    masks["dec"]["layers"][0]["attn"]["wq"][3] = False
    batch = {"tokens": torch.from_numpy(rng.integers(
                 0, MINI.vocab_size, (8, 128))).to(cuda),
             "labels": torch.from_numpy(rng.integers(0, 20, 8)).to(cuda)}

    def step(model):
        flat = []

        def leaf(t):
            flat.append(t.detach().requires_grad_(True))
            return flat[-1]

        req = tree_map(leaf, tr)
        K.reset_launches()
        loss, _ = model.cls_loss(base, req, masks, batch)
        launches = K.launch_counts()
        it = iter(torch.autograd.grad(loss, flat))
        return loss.item(), tree_map(lambda _: next(it), req), launches

    lk, gk, nk = step(kern)
    lp, gp, np_ = step(plain)
    assert nk["bea_dense"] == 6 * MINI.n_layers
    assert nk["flash_attention"] == MINI.n_layers
    assert not any(np_.values())
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    for (path, a), (_, b) in zip(flatten_with_paths(gk),
                                 flatten_with_paths(gp)):
        err = (a - b).abs().max().item()
        assert err <= 1e-3 * max(b.abs().max().item(), 1e-12), path


@pytest.mark.cuda
def test_autograd_functions_launch_their_kernels(cuda):
    rng = np.random.default_rng(3)
    x = _rand(rng, 64, 96, device=cuda).requires_grad_(True)
    w = _rand(rng, 96, 40, device=cuda)
    a = _rand(rng, 12, 96, device=cuda).requires_grad_(True)
    b = _rand(rng, 40, 12, device=cuda).requires_grad_(True)
    e = _rand(rng, 12, device=cuda).requires_grad_(True)
    mask = torch.ones(12, dtype=torch.bool, device=cuda)
    K.reset_launches()
    y = BeaDense.apply(x, w, a, b, e, mask, 2.0)
    grads = torch.autograd.grad(y.square().sum(), [x, a, b, e])
    q = _rand(rng, 2, 40, 4, 32, device=cuda).requires_grad_(True)
    o = FlashAttention.apply(q, q, q, False)
    torch.autograd.grad(o.sum(), [q])
    assert K.launch_counts()["bea_dense"] == 1
    assert K.launch_counts()["flash_attention"] == 1
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(768, 768), (768, 3072), (3072, 768)])
def test_bea_dense_w_grad_matches_plain_autograd(cuda, k, n):
    """``BeaDense`` with W needing a gradient (SLoRA's full fine-tuning
    stage) at the DistilBERT/BERT shapes, M = 1024, r = 12: the kernel
    forward (one launch) and every grad, dW included, against the autograd
    of the plain form."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(k + n)
    m, r = 1024, 12
    ops = [_rand(rng, m, k, device=cuda),
           _rand(rng, k, n, scale=k ** -0.5, device=cuda),
           _rand(rng, r, k, scale=k ** -0.5, device=cuda),
           _rand(rng, n, r, device=cuda), _rand(rng, r, device=cuda)]
    mask = torch.ones(r, dtype=torch.bool, device=cuda)
    mask[5] = False
    g = _rand(rng, m, n, device=cuda)

    def grads(fn):
        lv = [t.clone().requires_grad_(True) for t in ops]
        y = fn(*lv, mask, 16.0 / r)
        return y, torch.autograd.grad(y, lv, g)

    K.reset_launches()
    yk, gk = grads(BeaDense.apply)
    torch.cuda.synchronize()
    assert K.launch_counts()["bea_dense"] == 1
    yp, gp = grads(ref.bea_dense_ref)
    _close(yk, yp, torch.float32)
    for got, want in zip(gk, gp):
        _close(got, want, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [12, 24])
@pytest.mark.parametrize("k,n", [(768, 768), (768, 3072), (3072, 768)])
def test_bea_dense_lora_form_matches_lora_dense_ref(cuda, k, n, r):
    """LoRA through the fused kernel with E = 1 and a full mask (the LoRA
    baselines; r = 24 is FFA-LoRA-dr's doubled rank) against
    ``lora_dense_ref``."""
    rng = np.random.default_rng(k + n + r)
    x, w = _rand(rng, 1024, k, device=cuda), \
        _rand(rng, k, n, scale=k ** -0.5, device=cuda)
    a, b = _rand(rng, r, k, scale=k ** -0.5, device=cuda), \
        _rand(rng, n, r, device=cuda)
    ones = torch.ones(r, device=cuda)
    full = torch.ones(r, dtype=torch.bool, device=cuda)
    got = bea_dense(x, w, a, b, ones, full, 16.0 / r)
    _close(got, ref.lora_dense_ref(x, w, a, b, full, 16.0 / r),
           torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("peft", ["adapter_h", "adapter_p"])
def test_fedadapter_forward_launches_no_bea_dense(cuda, peft):
    """FedAdapter's base linears carry no adapter, so they stay ``x @ w``:
    its forward launches flash once per layer and ``bea_dense`` never."""
    from repro_torch.configs.distilbert import MINI
    from repro_torch.models import Model

    model = Model(MINI, peft=peft)
    base, tr = model.init(0, cuda)
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(
                 0, MINI.vocab_size, (4, 64))).to(cuda),
             "labels": torch.from_numpy(rng.integers(0, 20, 4)).to(cuda)}
    K.reset_launches()
    loss, _ = model.cls_loss(base, tr, None, batch)
    torch.cuda.synchronize()
    assert K.launch_counts()["bea_dense"] == 0
    assert K.launch_counts()["flash_attention"] == MINI.n_layers
    assert bool(torch.isfinite(loss))


# ------------------------------------------- the client-grouped instance ----

def _grouped_operands(rng, c, m, k, n, r, device):
    """C clients' x, A, B and E on one W and a mask with ranks off."""
    mask = torch.ones(r, dtype=torch.bool, device=device)
    mask[::3] = False
    return (_rand(rng, c, m, k, device=device),
            _rand(rng, k, n, scale=k ** -0.5, device=device),
            _rand(rng, c, r, k, scale=k ** -0.5, device=device),
            _rand(rng, c, n, r, device=device), _rand(rng, c, r, device=device),
            mask)


@pytest.mark.cuda
@pytest.mark.parametrize("c,m", [(3, 1024), (3, 800), (1, 1024), (4, 33)])
@pytest.mark.parametrize("k,n", [(768, 768), (768, 3072), (3072, 768)])
def test_bea_dense_grouped_matches_plain(cuda, c, m, k, n):
    """The grouped f32 instance at DistilBERT's linears, ragged rows a
    client (800, 33) and one client included, against the plain grouped
    form and against C single-client kernel calls."""
    from repro_torch.kernels.bea_fused import bea_dense_grouped

    rng = np.random.default_rng(c * m + k + n)
    ops = _grouped_operands(rng, c, m, k, n, 12, cuda)
    K.reset_launches()
    got = bea_dense_grouped(*ops, 16.0 / 12)
    torch.cuda.synchronize()
    assert K.launch_counts()["bea_dense_grouped"] == 1
    _close(got, ref.bea_dense_grouped_ref(*ops, 16.0 / 12), torch.float32)
    x, w, a, b, e, mask = ops
    for i in range(c):
        _close(got[i], bea_dense(x[i], w, a[i], b[i], e[i], mask, 16.0 / 12),
               torch.float32)


@pytest.mark.cuda
def test_bea_dense_grouped_is_deterministic_and_graph_safe(cuda):
    from repro_torch.kernels.bea_fused import bea_dense_grouped

    rng = np.random.default_rng(13)
    ops = _grouped_operands(rng, 3, 1024, 3072, 768, 12, cuda)
    other = _grouped_operands(rng, 2, 100, 768, 3072, 12, cuda)
    first = bea_dense_grouped(*ops, 2.0)
    bea_dense_grouped(*other, 1.0)                    # reuses the workspace
    assert torch.equal(bea_dense_grouped(*ops, 2.0), first)
    graph, captured = _graph_of(lambda: bea_dense_grouped(*ops, 2.0))
    for _ in range(3):
        graph.replay()
        bea_dense_grouped(*other, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(captured, first)


@pytest.mark.cuda
def test_captured_cohort_round_replays_equal_eager_rounds(cuda):
    """One FedLoRA cohort round (3 clients × 2 steps on MINI) captured as a
    CUDA graph and replayed twice equals two eager rounds of the same body
    from the same carry, bit for bit."""
    from repro_torch.configs.distilbert import MINI
    from repro_torch.fedsim.fused import CohortRound
    from repro_torch.models import Model
    from repro_torch.optim import adam, linear_decay
    from repro_torch.pytree import leaves, tree_map

    model = Model(MINI, peft="lora")
    base, tr = model.init(0, cuda)
    rng = np.random.default_rng(3)
    c, t = 3, 2
    batches = {"tokens": torch.from_numpy(rng.integers(
                   0, MINI.vocab_size, (c, t, 4, 32))).to(cuda),
               "labels": torch.from_numpy(rng.integers(
                   0, 20, (c, t, 4))).to(cuda)}
    smask = torch.ones(c, t, dtype=torch.bool, device=cuda)
    smask[2, 1] = False
    weights = torch.tensor([40.0, 25.0, 10.0], device=cuda)

    def rounds(graph: bool):
        carry = tree_map(torch.clone, tr)
        rd = CohortRound(model, adam(linear_decay(3e-3, 8)), base, carry,
                         None, None, batches, smask, weights)
        losses = [(rd.run() if graph else rd.body()).clone()
                  for _ in range(2)]
        torch.cuda.synchronize()
        return rd, losses, carry

    rd, lg, cg = rounds(True)
    _, le, ce = rounds(False)
    assert rd.captures == 1 and rd.replays == 2
    assert rd.capture_launches["bea_dense_grouped"] == t * 6 * MINI.n_layers
    for a, b in zip(lg, le):
        assert torch.equal(a, b)
    for a, b in zip(leaves(cg), leaves(ce)):
        assert torch.equal(a, b)
    assert not torch.equal(leaves(cg)[0], leaves(tr)[0])


@pytest.mark.cuda
def test_traced_fused_run_records_one_capture_and_memory_per_round(cuda):
    """A traced fused FedLoRA run on MINI (4 rounds in blocks of 2): one
    ``graph_capture`` compile span, under the first block's dispatch span
    (round 0) and none after; a ``memory`` event at every round's end whose
    peak is > 0 and within ``max_memory_allocated``; the trace summarizes
    to the history exactly."""
    from repro_torch import obs
    from repro_torch.configs.distilbert import MINI
    from repro_torch.data.synthetic import make_classification
    from repro_torch.federated.baselines import FedLoRA
    from repro_torch.federated.partition import iid_partition
    from repro_torch.federated.server import FedConfig, run_federated
    from repro_torch.models import Model
    from repro_torch.obs import profile as P

    cfg = MINI.with_(n_layers=1, layer_pattern=("attn",))
    train = make_classification(240, 4, cfg.vocab_size, 32, seed=1)
    parts = iid_partition(train.labels, 4, seed=0)
    fc = FedConfig(rounds=4, clients_per_round=3, batch_size=8,
                   max_local_batches=2, eval_every=4, eval_batches=2,
                   runner="cohort", fuse_rounds=2)
    torch.cuda.reset_peak_memory_stats()
    try:
        obs.configure(None, health=False)
        h = run_federated(Model(cfg, peft="lora"), FedLoRA(), parts, train,
                          train, fc, device=cuda)
        evs = obs.close()
    finally:
        obs.disable()
    caps = [e for e in evs if e.get("kind") == "compile"]
    assert [e["name"] for e in caps] == ["graph_capture"]
    parent = next(e for e in evs if e.get("id") == caps[0]["parent"])
    assert parent["kind"] == "dispatch" and parent["attrs"]["rnd"] == 0
    assert caps[0]["attrs"]["launches"] == h["graph"]["launches_per_capture"]
    cs = P.compile_stats(evs)
    assert cs["by_round"] == {0: 1} and cs["after_first_round"] == 0
    mems = [e for e in evs if e.get("name") == "memory"]
    assert len(mems) == fc.rounds
    for m in mems:
        peak = m["attrs"]["devices"]["0"]["peak_bytes_in_use"]
        assert 0 < peak <= torch.cuda.max_memory_allocated()
    s = obs.summarize(evs)
    assert (s["comm_gb"], s["sim_time_s"], s["n_rounds"]) == \
        (h["comm_gb"], h["sim_time_s"], len(h["rounds"]))


# --------------------------------------------------------------------------
# the LM fine-tuning path's instances (Qwen2 bf16, BART f32)
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("k,n", PATH_KN)
def test_bea_dense_bf16_at_lm_training_rows(cuda, k, n):
    """bf16 ``bea_dense`` at a Qwen2 training step's rows (8 × 512 tokens)
    under its plan, r = 8, and its backward through ``BeaDense``."""
    rng = np.random.default_rng(k + n)
    x, w, a, b, e, mask = _dense_operands(rng, 4096, k, n, 8, torch.bfloat16,
                                          cuda)
    K.reset_launches()
    got = bea_dense(x, w, a, b, e, mask, 2.0)
    torch.cuda.synchronize()
    assert K.launch_counts()["bea_dense"] == 1
    want = ref.bea_dense_ref(x.float(), w.float(), a.float(), b.float(), e,
                             mask, 2.0)
    _close(got, want, torch.bfloat16)
    leaves = [t.clone().requires_grad_(True) for t in (x, a, b, e)]
    y = BeaDense.apply(leaves[0], w, leaves[1], leaves[2], leaves[3], mask,
                       2.0)
    g = _rand(rng, 4096, n, dtype=torch.bfloat16, device=cuda)
    gk = torch.autograd.grad(y, leaves, g)
    plain = [t.clone().requires_grad_(True) for t in (x, a, b, e)]
    gp = torch.autograd.grad(ref.bea_dense_ref(plain[0], w, plain[1],
                                               plain[2], plain[3], mask, 2.0),
                             plain, g)
    for got_g, want_g in zip(gk, gp):
        assert torch.equal(got_g, want_g)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", PATH_KN)
@pytest.mark.parametrize("m,r", [(4096, 1), (4096, 8), (4096, 64),
                                 (4097, 8)])
def test_bea_dense_bf16_wgmma_matches_plain(cuda, m, k, n, r):
    """The wgmma instance (128-row tiles, TMA, warp-specialised) at every
    Qwen2 linear at training rows, every rank bucket (RP 16 and 64) and a
    ragged last row tile; one launch."""
    from repro_torch.kernels.bea_fused import plan

    assert plan(m, k, n, rank=r).kernel == "wgmma"
    rng = np.random.default_rng(m + 3 * k + n + r)
    ops = _dense_operands(rng, m, k, n, r, torch.bfloat16, cuda)
    K.reset_launches()
    got = bea_dense(*ops, 2.0)
    torch.cuda.synchronize()
    assert K.launch_counts()["bea_dense"] == 1
    _close(got, ref.bea_dense_ref(*(t.float() if t.dtype == torch.bfloat16
                                    else t for t in ops), 2.0),
           torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", PATH_KN)
def test_bea_dense_bf16_wgmma_fully_masked_is_plain_matmul(cuda, k, n):
    rng = np.random.default_rng(k * n)
    x, w, a, b, e, _ = _dense_operands(rng, 4096, k, n, 8, torch.bfloat16,
                                       cuda)
    got = bea_dense(x, w, a, b, e, torch.zeros(8, dtype=torch.bool,
                                               device=cuda), 3.0)
    _close(got, x.float() @ w.float(), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", PATH_KN)
def test_bea_dense_bf16_wgmma_is_deterministic_and_graph_safe(cuda, k, n):
    """Each output element comes from one block in a fixed order (no
    atomics), and the TMA maps are kernel parameters, captured by value:
    repeated calls are bitwise equal, and a CUDA-graph replay equals the
    eager call after calls of another shape."""
    rng = np.random.default_rng(17 + k + n)
    ops = _dense_operands(rng, 4096, k, n, 8, torch.bfloat16, cuda)
    other = _dense_operands(rng, 4000, 4864, 896, 4, torch.bfloat16, cuda)
    first = bea_dense(*ops, 2.0)
    bea_dense(*other, 1.0)
    assert torch.equal(bea_dense(*ops, 2.0), first)
    graph, captured = _graph_of(lambda: bea_dense(*ops, 2.0))
    for _ in range(3):
        graph.replay()
        bea_dense(*other, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(captured, first)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,shift", [(4096, 900, 896, 0),
                                         (4096, 896, 900, 0),
                                         (4096, 896, 896, 1)])
def test_bea_dense_bf16_unaligned_takes_mma_kernel(cuda, m, k, n, shift):
    """TMA takes 16-byte aligned bases and row pitches: K or N not a
    multiple of 8, or x one element off a boundary, run mma_kernel."""
    from repro_torch.kernels.bea_fused import plan

    rng = np.random.default_rng(m + k + n + shift)
    x, w, a, b, e, mask = _dense_operands(rng, m, k, n, 8, torch.bfloat16,
                                          cuda)
    if shift:
        x = torch.empty(m * k + 8, dtype=x.dtype, device=cuda)[
            shift:shift + m * k].view(m, k).copy_(x)
    assert plan(m, k, n, rank=8,
                aligned=x.data_ptr() % 16 == 0).kernel == "mma"
    got = bea_dense(x, w, a, b, e, mask, 2.0)
    _close(got, ref.bea_dense_ref(x.float(), w.float(), a.float(), b.float(),
                                  e, mask, 2.0), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,sq,sk,h,kv,causal,hd,window,cap", [
    (torch.bfloat16, 8, 512, 512, 14, 2, True, 64, 0, 0.0),   # Qwen2's call
    (torch.float32, 8, 256, 256, 12, 12, True, 64, 0, 0.0),   # BART's decoder
    (torch.float32, 8, 256, 256, 12, 12, False, 64, 0, 0.0),  # BART's encoder
    (torch.float32, 8, 256, 384, 12, 12, False, 64, 0, 0.0),  # cross, Sq ≠ Sk
    (torch.float32, 2, 100, 37, 12, 12, False, 64, 0, 0.0),   # ragged Sq > Sk
    (torch.float32, 2, 37, 300, 4, 4, False, 64, 0, 0.0),     # ragged Sq < Sk
    (torch.bfloat16, 2, 65, 129, 4, 2, False, 64, 0, 0.0),
    # the bf16 wgmma body off Qwen2's call: ragged S, non-causal, Sq ≠ Sk
    # both ways, window with soft-cap (no grads: FlashAttention takes
    # neither), head dim 128
    (torch.bfloat16, 2, 500, 500, 14, 2, True, 64, 0, 0.0),
    (torch.bfloat16, 2, 513, 513, 14, 2, True, 64, 0, 0.0),
    (torch.bfloat16, 2, 512, 512, 14, 2, False, 64, 0, 0.0),
    (torch.bfloat16, 2, 384, 640, 14, 2, True, 64, 0, 0.0),
    (torch.bfloat16, 2, 640, 384, 14, 2, False, 64, 0, 0.0),
    (torch.bfloat16, 2, 512, 512, 14, 2, True, 64, 128, 30.0),
    (torch.bfloat16, 2, 512, 512, 8, 2, True, 128, 0, 0.0)])
def test_flash_lm_training_instances_match_plain(cuda, dtype, b, sq, sk, h,
                                                 kv, causal, hd, window, cap):
    """The flash instances of LM training against the plain version, and
    ``FlashAttention``'s grads against the plain form's autograd."""
    # hd 64 without a window: the seed sq * 7 + sk of the first seven cases
    rng = np.random.default_rng(sq * 7 + sk + hd - 64 + window)
    q = _rand(rng, b, sq, h, hd, dtype=dtype, device=cuda)
    k = _rand(rng, b, sk, kv, hd, dtype=dtype, device=cuda)
    v = _rand(rng, b, sk, kv, hd, dtype=dtype, device=cuda)
    g = h // kv
    K.reset_launches()
    got = mha_flash(q, k, v, causal=causal, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert K.launch_counts()["flash_attention"] == 1
    want = ref.flash_attention_ref(
        q.float(), k.float().repeat_interleave(g, 2),
        v.float().repeat_interleave(g, 2), causal=causal, window=window,
        softcap=cap)
    _close(got, want, dtype)
    if dtype == torch.bfloat16 and not cap:     # wgmma gives mma_kernel's bits
        assert torch.equal(got, mha_flash(q, k, v, causal=causal,
                                          window=window, body=Plan("mma")))
    if window or cap:
        return
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = FlashAttention.apply(*leaves, causal)
    go = _rand(rng, b, sq, h, hd, dtype=dtype, device=cuda)
    gk = torch.autograd.grad(o, leaves, go)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    op = ref.flash_attention_ref(plain[0],
                                 plain[1].repeat_interleave(g, 2),
                                 plain[2].repeat_interleave(g, 2),
                                 causal=causal)
    for got_g, want_g in zip(gk, torch.autograd.grad(op, plain, go)):
        assert torch.equal(got_g, want_g)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2_0p5b", "bart"])
def test_lm_step_kernels_match_plain_on_smoke(cuda, arch):
    """One SMOKE ``lm_loss`` step (f32) through the kernels and the plain
    versions: loss within 1e-5, every adapter grad within 1e-3 of its
    largest plain value, one ``bea_dense`` per adapted linear and one flash
    per attention (the encoder-decoder's cross-attention included, its
    encoder longer than the decoder) in the forward."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.pytree import flatten_with_paths, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch, smoke=True)
    rng = np.random.default_rng(1)
    kern, plain = Model(cfg), Model(cfg, use_kernels=False)
    base, tr = kern.init(0, cuda)
    tr = tree_map(lambda t: t + 0.1 * torch.randn_like(t), tr)
    masks = kern.init_masks(cuda)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 48)))
             .to(cuda) for k in ("tokens", "targets")}
    batch["targets"][0, :6] = -1
    if cfg.is_encoder_decoder:
        batch["enc_tokens"] = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (4, 80))).to(cuda)

    def step(model):
        flat = []

        def leaf(t):
            flat.append(t.detach().requires_grad_(True))
            return flat[-1]

        req = tree_map(leaf, tr)
        K.reset_launches()
        loss, _ = model.lm_loss(base, req, masks, batch)
        launches = K.launch_counts()
        it = iter(torch.autograd.grad(loss, flat))
        return loss.item(), tree_map(lambda _: next(it), req), launches

    lk, gk, nk = step(kern)
    lp, gp, np_ = step(plain)
    enc = cfg.n_encoder_layers if cfg.is_encoder_decoder else 0
    per_dec = 10 if enc else 7
    assert nk["bea_dense"] == 6 * enc + per_dec * cfg.n_layers
    assert nk["flash_attention"] == enc + (2 if enc else 1) * cfg.n_layers
    assert not any(np_.values())
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    for (path, a), (_, b) in zip(flatten_with_paths(gk),
                                 flatten_with_paths(gp)):
        err = (a - b).abs().max().item()
        assert err <= 1e-3 * max(b.abs().max().item(), 1e-12), path


# ---- Gemma: flash at head dim 256 under window and soft-cap ---------------

GEMMA_FLASH = [  # b, sq, h, kv, window, cap
    (8, 512, 8, 4, 4096, 50.0),     # Gemma2-2B's call (the window cannot bind)
    (2, 1024, 8, 4, 256, 50.0),     # a binding window with Gemma2's cap
    (4, 1024, 4, 1, 512, 0.0),      # Gemma3-1B's local layers
    (4, 1024, 4, 1, 0, 0.0),        # Gemma3-1B's global layers
    (1, 20, 4, 1, 16, 50.0)]        # under WGMMA_MIN_SQ rows: mma_kernel<256>


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,h,kv,window,cap", GEMMA_FLASH)
def test_flash_hd256_matches_plain(cuda, b, sq, h, kv, window, cap):
    """bf16 flash at head dim 256 against the plain version, causal, on the
    body its plan names (wgmma_kernel<256, 2> from 32 rows); without a
    soft-cap the wgmma body gives mma_kernel<256>'s bits."""
    from repro_torch.kernels.flash_attention import plan
    rng = np.random.default_rng(sq + window + h)
    bf = torch.bfloat16
    q = _rand(rng, b, sq, h, 256, dtype=bf, device=cuda)
    k = _rand(rng, b, sq, kv, 256, dtype=bf, device=cuda)
    v = _rand(rng, b, sq, kv, 256, dtype=bf, device=cuda)
    p = plan(bf, b, h, sq, sq, 256)
    assert p.kernel == ("wgmma" if sq >= 32 else "mma")
    K.reset_launches()
    got = mha_flash(q, k, v, causal=True, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert K.launch_counts()["flash_attention"] == 1
    g = h // kv
    want = ref.flash_attention_ref(
        q.float(), k.float().repeat_interleave(g, 2),
        v.float().repeat_interleave(g, 2), causal=True, window=window,
        softcap=cap)
    _close(got, want, bf)
    if p.kernel == "wgmma" and not cap:
        assert torch.equal(got, mha_flash(q, k, v, causal=True, window=window,
                                          body=Plan("mma")))


@pytest.mark.cuda
def test_flash_hd256_strided_view_takes_mma_kernel(cuda):
    """Rows of 260 elements are not 16-byte strides: mma_kernel<256>."""
    from repro_torch.kernels.flash_attention import plan, tma_aligned
    rng = np.random.default_rng(256)
    bf = torch.bfloat16
    q, k, v = (_rand(rng, 2, 512, n, 260, dtype=bf, device=cuda)[..., :256]
               for n in (8, 4, 4))
    views = [(t, (t.stride(0), t.stride(2), t.stride(1))) for t in (q, k, v)]
    assert not tma_aligned(*views)
    assert plan(bf, 2, 8, 512, 512, 256, False).kernel == "mma"
    want = ref.flash_attention_ref(
        q.float(), k.float().repeat_interleave(2, 2),
        v.float().repeat_interleave(2, 2), window=256, softcap=50.0)
    _close(mha_flash(q, k, v, window=256, softcap=50.0), want, bf)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,window,cap", [(512, 4096, 50.0), (1024, 512, 0.0),
                                           (20, 16, 50.0)])
def test_flash_hd256_is_deterministic_and_graph_safe(cuda, sq, window, cap):
    rng = np.random.default_rng(sq)
    bf = torch.bfloat16
    q = _rand(rng, 2, sq, 8, 256, dtype=bf, device=cuda)
    k = _rand(rng, 2, sq, 4, 256, dtype=bf, device=cuda)
    v = _rand(rng, 2, sq, 4, 256, dtype=bf, device=cuda)
    call = lambda: mha_flash(q, k, v, causal=True, window=window,  # noqa: E731
                             softcap=cap)
    first = call()
    assert torch.equal(call(), first)
    graph, captured = _graph_of(call)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)


@pytest.mark.cuda
def test_flash_hd256_f32_raises(cuda):
    """No f32 body at head dim 256 (ROADMAP.md queue 2 item 1): the
    wrapper raises, and no plain fallback runs."""
    q = torch.zeros(1, 64, 2, 256, device=cuda)
    K.reset_launches()
    with pytest.raises(ValueError, match="queue 2 item 1"):
        mha_flash(q, q[:, :, :1], q[:, :, :1])
    assert K.launch_counts()["flash_attention"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("window,cap", [(256, 50.0), (512, 0.0)])
def test_flash_hd256_grads_with_window_and_softcap_match_plain(cuda, window,
                                                               cap):
    """``FlashAttention`` at head dim 256 with window and soft-cap: the
    kernel forward, and grads equal to the plain form's autograd."""
    from repro_torch.kernels.flash_attention import FlashAttention
    rng = np.random.default_rng(window)
    bf = torch.bfloat16
    q = _rand(rng, 2, 1024, 4, 256, dtype=bf, device=cuda)
    k = _rand(rng, 2, 1024, 1, 256, dtype=bf, device=cuda)
    v = _rand(rng, 2, 1024, 1, 256, dtype=bf, device=cuda)
    go = _rand(rng, 2, 1024, 4, 256, dtype=bf, device=cuda)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    K.reset_launches()
    o = FlashAttention.apply(*leaves, True, window, cap)
    assert K.launch_counts()["flash_attention"] == 1
    gk = torch.autograd.grad(o, leaves, go)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    op = ref.flash_attention_ref(plain[0], plain[1].repeat_interleave(4, 2),
                                 plain[2].repeat_interleave(4, 2),
                                 window=window, softcap=cap)
    _close(o, op, bf)
    for got_g, want_g in zip(gk, torch.autograd.grad(op, plain, go)):
        assert torch.equal(got_g, want_g)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma2_2b", "gemma3_1b"])
def test_gemma_lm_step_kernels_match_plain_on_smoke(cuda, arch):
    """Gemma SMOKE (head dim 32, window 16 over 48 tokens, Gemma2's caps):
    the Qwen2 / BART step check above."""
    test_lm_step_kernels_match_plain_on_smoke(cuda, arch)


# ---- MoE: Granite-3.0-1B-A400M (bf16) and Kimi-K2 SMOKE (f32) -------------

GRANITE_KN = [(1024, 1024), (1024, 512)]     # wq/wo, wk/wv


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", GRANITE_KN)
def test_bea_dense_bf16_at_granite_linears(cuda, k, n):
    """bf16 ``bea_dense`` at Granite's attention linears, 8 × 512 tokens,
    r = 8, against the plain version (the expert FFN and the router are
    batched products, not this kernel)."""
    rng = np.random.default_rng(k + 3 * n)
    x, w, a, b, e, mask = _dense_operands(rng, 4096, k, n, 8, torch.bfloat16,
                                          cuda)
    K.reset_launches()
    got = bea_dense(x, w, a, b, e, mask, 2.0)
    torch.cuda.synchronize()
    assert K.launch_counts()["bea_dense"] == 1
    _close(got, ref.bea_dense_ref(x.float(), w.float(), a.float(), b.float(),
                                  e, mask, 2.0), torch.bfloat16)


def _granite_block(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import blocks as BK
    from repro_torch.pytree import materialize, tree_map

    cfg = get_config("granite_moe_1b_a400m")
    p = materialize(BK.block_meta(cfg, "moe"), 0, cuda)
    ad = tree_map(lambda t: t + 0.1 * torch.randn_like(t),
                  materialize(BK.block_adapter_meta(cfg, "moe", "bea"), 1,
                              cuda))
    return cfg, p, ad


@pytest.mark.cuda
def test_granite_moe_block_kernels_match_plain(cuda):
    """One full-width Granite MoE block at 8 × 512 bf16 tokens, attention
    through the kernels (4 ``bea_dense``, 1 flash), the MoE plain, against
    the all-plain block routed as the kernel block routed: the output
    within bf16's tolerance of the largest value, the aux within 1e-2."""
    from repro_torch.models import blocks as BK

    cfg, p, ad = _granite_block(cuda)
    rng = np.random.default_rng(5)
    x = _rand(rng, 8, 512, cfg.d_model, dtype=torch.bfloat16, device=cuda)
    rec = []
    K.reset_launches()
    with torch.no_grad():
        yk, auxk, _ = BK.block_apply(p, x, cfg, mode="train", kind="moe",
                                     ad=ad, use_kernel=True, record=rec)
        torch.cuda.synchronize()
        launches = K.launch_counts()
        yp, auxp, _ = BK.block_apply(p, x, cfg, mode="train", kind="moe",
                                     ad=ad, route=rec[0]["top_ids"])
    assert launches["bea_dense"] == 4 and launches["flash_attention"] == 1
    assert yk.dtype == torch.bfloat16 and torch.isfinite(yk).all()
    _close(yk, yp, torch.bfloat16)
    assert abs(auxk.item() - auxp.item()) <= 1e-2 * abs(auxp.item())


@pytest.mark.cuda
def test_granite_forward_launches_96_bea_dense_and_24_flash(cuda):
    """Full-width Granite's forward at 8 × 512: one ``bea_dense`` per
    attention linear (4 × 24) and one flash per layer, nothing else; the
    logits finite and the aux of 24 layers near 24 (a balanced router's
    E · Σ f · p̄ is 1 a layer)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = get_config("granite_moe_1b_a400m")
    model = Model(cfg)
    base, tr = model.init(0, cuda)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (8, 512))).to(cuda)
    K.reset_launches()
    with torch.no_grad():
        logits, aux = model._forward(base, tr, model.init_masks(cuda),
                                     {"tokens": toks})
    torch.cuda.synchronize()
    launches = K.launch_counts()
    assert launches["bea_dense"] == 96 and launches["flash_attention"] == 24
    assert not launches["bea_batched"] and not launches["bea_dense_grouped"]
    assert logits.shape == (8, 512, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    assert 20.0 < aux.item() < 48.0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "kimi_k2_1t_a32b"])
def test_moe_lm_step_kernels_match_plain_on_smoke(cuda, arch):
    """One MoE SMOKE ``lm_loss`` step (f32) through the kernels and, routed
    as it routed, through the plain versions: loss within 1e-5, every
    adapter grad within 1e-3 of its largest plain value, 4 ``bea_dense``
    and 1 flash a layer in the forward."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.pytree import flatten_with_paths, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch, smoke=True)
    rng = np.random.default_rng(1)
    kern, plain = Model(cfg), Model(cfg, use_kernels=False)
    base, tr = kern.init(0, cuda)
    tr = tree_map(lambda t: t + 0.1 * torch.randn_like(t), tr)
    masks = kern.init_masks(cuda)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 48)))
             .to(cuda) for k in ("tokens", "targets")}
    batch["targets"][0, :6] = -1
    rec = []

    def step(model, **kw):
        flat = []

        def leaf(t):
            flat.append(t.detach().requires_grad_(True))
            return flat[-1]

        req = tree_map(leaf, tr)
        K.reset_launches()
        loss, _ = model.lm_loss(base, req, masks, batch, **kw)
        launches = K.launch_counts()
        it = iter(torch.autograd.grad(loss, flat))
        return loss.item(), tree_map(lambda _: next(it), req), launches

    lk, gk, nk = step(kern, record=rec)
    lp, gp, np_ = step(plain, route=[r["top_ids"] for r in rec])
    assert nk["bea_dense"] == 4 * cfg.n_layers
    assert nk["flash_attention"] == cfg.n_layers
    assert not any(np_.values())
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    for (path, a), (_, b) in zip(flatten_with_paths(gk),
                                 flatten_with_paths(gp)):
        err = (a - b).abs().max().item()
        assert err <= 1e-3 * max(b.abs().max().item(), 1e-12), path


# ---- MiniCPM-2B (MHA, f32 SMOKE at head dim 36) and Mamba2-780M -----------

HD36_FLASH = [  # b, sq, sk, h, kv, causal
    (4, 48, 48, 4, 4, True),        # MiniCPM SMOKE's training call
    (8, 512, 512, 4, 4, True),
    (2, 128, 128, 4, 4, False),
    (2, 100, 100, 4, 4, True),      # a ragged last tile
    (2, 96, 160, 4, 4, False),      # Sq != Sk
    (2, 128, 128, 4, 2, True),      # GQA 4/2
    (1, 20, 20, 4, 4, True)]        # under 32 query rows


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,kv,causal", HD36_FLASH)
def test_flash_f32_hd36_matches_plain(cuda, b, sq, sk, h, kv, causal):
    """f32 flash at head dim 36 (tf32_kernel on a tile padded to 40, only
    36 columns stored) against the plain version; repeatable; its grads
    through ``FlashAttention`` the plain form's autograd."""
    from repro_torch.kernels.flash_attention import plan
    rng = np.random.default_rng(sq * 5 + sk + h + kv)
    q = _rand(rng, b, sq, h, 36, device=cuda)
    k = _rand(rng, b, sk, kv, 36, device=cuda)
    v = _rand(rng, b, sk, kv, 36, device=cuda)
    assert plan(torch.float32, b, h, sq, sk, 36) == Plan("mma")
    K.reset_launches()
    got = mha_flash(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert K.launch_counts()["flash_attention"] == 1
    assert got.shape == (b, sq, h, 36) and got.is_contiguous()
    g = h // kv
    want = ref.flash_attention_ref(q, k.repeat_interleave(g, 2),
                                   v.repeat_interleave(g, 2), causal=causal)
    _close(got, want, torch.float32)
    assert torch.equal(got, mha_flash(q, k, v, causal=causal))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    go = _rand(rng, b, sq, h, 36, device=cuda)
    gk = torch.autograd.grad(FlashAttention.apply(*leaves, causal), leaves, go)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    op = ref.flash_attention_ref(plain[0], plain[1].repeat_interleave(g, 2),
                                 plain[2].repeat_interleave(g, 2),
                                 causal=causal)
    for got_g, want_g in zip(gk, torch.autograd.grad(op, plain, go)):
        assert torch.equal(got_g, want_g)


@pytest.mark.cuda
def test_flash_bf16_hd36_raises(cuda):
    q = torch.zeros(1, 48, 4, 36, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="queue 2 item 1"):
        mha_flash(q, q, q, causal=True)


@pytest.mark.cuda
def test_flash_minicpm_mha_call_matches_plain(cuda):
    """MiniCPM-2B's training call, 8 × 512, 36 query over 36 kv heads of 64
    (group 1), causal, bf16: the wgmma body against the plain version and
    bit for bit mma_kernel's."""
    from repro_torch.kernels.flash_attention import plan
    rng = np.random.default_rng(36)
    bf = torch.bfloat16
    q, k, v = (_rand(rng, 8, 512, 36, 64, dtype=bf, device=cuda)
               for _ in range(3))
    assert plan(bf, 8, 36, 512, 512, 64).kernel == "wgmma"
    got = mha_flash(q, k, v, causal=True)
    _close(got, ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                        causal=True), bf)
    assert torch.equal(got, mha_flash(q, k, v, causal=True, body=Plan("mma")))


MINICPM_KN = [(2304, 2304), (2304, 5760), (5760, 2304)]
MAMBA2_KN = [(1536, 6448), (3072, 1536)]      # in_proj, out_proj


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", MINICPM_KN + MAMBA2_KN)
def test_bea_dense_bf16_at_minicpm_and_mamba2_linears(cuda, k, n):
    """bf16 ``bea_dense`` at MiniCPM-2B's and Mamba2-780M's adapted linears,
    8 × 512 tokens, r = 8, on the wgmma instance, against the plain version
    (N = 6448 is 50 column tiles of 128 and 48 columns: the masked edge)."""
    from repro_torch.kernels.bea_fused import plan
    rng = np.random.default_rng(k + 5 * n)
    x, w, a, b, e, mask = _dense_operands(rng, 4096, k, n, 8, torch.bfloat16,
                                          cuda)
    assert plan(4096, k, n, rank=8).kernel == "wgmma"
    got = bea_dense(x, w, a, b, e, mask, 2.0)
    _close(got, ref.bea_dense_ref(x.float(), w.float(), a.float(), b.float(),
                                  e, mask, 2.0), torch.bfloat16)
    assert torch.equal(got, bea_dense(x, w, a, b, e, mask, 2.0))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(192, 128, 552), (192, 256, 128)])
def test_bea_dense_f32_at_mamba2_smoke_linears(cuda, m, k, n):
    rng = np.random.default_rng(m + k + n)
    ops = _dense_operands(rng, m, k, n, 4, torch.float32, cuda)
    _close(bea_dense(*ops, 4.0), ref.bea_dense_ref(*ops, 4.0), torch.float32)


def _ssd_recurrence(x, dt, a, b, c):
    """The reference's decode formula one position at a time in float64
    (repro/models/ssm.py:171-176): h ← exp(dt·a)·h + dt·x⊗b, y = h·c."""
    x, dt, a, b, c = (t.double() for t in (x, dt, a, b, c))
    bs, s, h, p = x.shape
    state = x.new_zeros(bs, h, p, b.shape[-1])
    ys = []
    for t in range(s):
        state = (torch.exp(dt[:, t] * a)[..., None, None] * state
                 + (dt[:, t, :, None] * x[:, t])[..., None]
                 * b[:, t, None, None, :])
        ys.append(torch.einsum("bn,bhpn->bhp", c[:, t], state))
    return torch.stack(ys, 1)


@pytest.mark.cuda
def test_ssd_chunked_at_full_width_equals_the_recurrence(cuda):
    """One Mamba2-780M layer's SSD (S = 512, chunk 256, 48 heads of 64,
    state 128) in f32 at the reference's init (a = −e): finite, and within
    1e-4 of the largest |y| of a float64 sequential recurrence."""
    from repro_torch.models.ssm import ssd_chunked
    rng = np.random.default_rng(48)
    x = _rand(rng, 1, 512, 48, 64, device=cuda)
    dt = torch.nn.functional.softplus(_rand(rng, 1, 512, 48, device=cuda))
    a = -torch.full((48,), np.e, device=cuda)
    b, c = (_rand(rng, 1, 512, 128, scale=128 ** -0.5, device=cuda)
            for _ in range(2))
    y, _ = ssd_chunked(x, dt, a, b, c, 256)
    want = _ssd_recurrence(x, dt, a, b, c)
    assert torch.isfinite(y).all()
    assert (y.double() - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
def test_mamba2_block_kernels_match_plain(cuda):
    """One full-width Mamba2-780M block at 8 × 512 bf16 tokens, in_proj and
    out_proj through ``bea_dense`` (2 launches, no flash), against the
    plain block: finite, within bf16's tolerance of the largest value."""
    from repro_torch.configs import get_config
    from repro_torch.models import blocks as BK
    from repro_torch.pytree import materialize, tree_map

    cfg = get_config("mamba2_780m")
    p = materialize(BK.block_meta(cfg, "mamba"), 0, cuda)
    ad = tree_map(lambda t: t + 0.1 * torch.randn_like(t),
                  materialize(BK.block_adapter_meta(cfg, "mamba", "bea"), 1,
                              cuda))
    x = _rand(np.random.default_rng(7), 8, 512, cfg.d_model,
              dtype=torch.bfloat16, device=cuda)
    K.reset_launches()
    with torch.no_grad():
        yk, _, _ = BK.block_apply(p, x, cfg, mode="train", kind="mamba",
                                  ad=ad, use_kernel=True)
        torch.cuda.synchronize()
        launches = K.launch_counts()
        yp, _, _ = BK.block_apply(p, x, cfg, mode="train", kind="mamba",
                                  ad=ad)
    assert launches["bea_dense"] == 2 and launches["flash_attention"] == 0
    assert yk.dtype == torch.bfloat16 and torch.isfinite(yk).all()
    _close(yk, yp, torch.bfloat16)


@pytest.mark.cuda
def test_minicpm_lm_step_kernels_match_plain_on_smoke(cuda):
    """MiniCPM SMOKE (f32, 4 q / 4 kv heads of 36): the Qwen2 / BART step
    check above, its flash on the head-dim-36 instance."""
    test_lm_step_kernels_match_plain_on_smoke(cuda, "minicpm_2b")


@pytest.mark.cuda
def test_mamba2_lm_step_kernels_match_plain_on_smoke(cuda):
    """One Mamba2 SMOKE ``lm_loss`` step (f32): loss within 1e-5, every
    adapter grad within 1e-3 of its largest plain value, 2 ``bea_dense``
    a layer and no flash in the forward."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.pytree import flatten_with_paths, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("mamba2_780m", smoke=True)
    rng = np.random.default_rng(1)
    kern, plain = Model(cfg), Model(cfg, use_kernels=False)
    base, tr = kern.init(0, cuda)
    tr = tree_map(lambda t: t + 0.1 * torch.randn_like(t), tr)
    masks = kern.init_masks(cuda)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 48)))
             .to(cuda) for k in ("tokens", "targets")}

    def step(model):
        flat = []

        def leaf(t):
            flat.append(t.detach().requires_grad_(True))
            return flat[-1]

        req = tree_map(leaf, tr)
        K.reset_launches()
        loss, _ = model.lm_loss(base, req, masks, batch)
        launches = K.launch_counts()
        it = iter(torch.autograd.grad(loss, flat))
        return loss.item(), tree_map(lambda _: next(it), req), launches

    lk, gk, nk = step(kern)
    lp, gp, np_ = step(plain)
    assert nk["bea_dense"] == 2 * cfg.n_layers
    assert nk["flash_attention"] == 0 and not any(np_.values())
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    for (path, a), (_, b) in zip(flatten_with_paths(gk),
                                 flatten_with_paths(gp)):
        err = (a - b).abs().max().item()
        assert err <= 1e-3 * max(b.abs().max().item(), 1e-12), path


# ---- Zamba2-1.2B: a mamba backbone with one shared attention block --------

ZAMBA2_KN = [(2048, 8384), (4096, 2048),      # in_proj (ragged), out_proj
             (2048, 2048), (2048, 8192), (8192, 2048)]   # q/k/v/o, w1/w3, w2


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", ZAMBA2_KN)
def test_bea_dense_bf16_at_zamba2_linears(cuda, k, n):
    """bf16 ``bea_dense`` at Zamba2-1.2B's adapted linears, 8 × 512 tokens,
    r = 8, on the wgmma instance, against the plain version and repeatable
    (N = 8384 is 64 past a multiple of 128 and of 256: the plan's last
    column tile is ragged, the masked edge)."""
    from repro_torch.kernels.bea_fused import plan
    rng = np.random.default_rng(k + 3 * n)
    x, w, a, b, e, mask = _dense_operands(rng, 4096, k, n, 8, torch.bfloat16,
                                          cuda)
    assert plan(4096, k, n, rank=8).kernel == "wgmma"
    got = bea_dense(x, w, a, b, e, mask, 2.0)
    _close(got, ref.bea_dense_ref(x.float(), w.float(), a.float(), b.float(),
                                  e, mask, 2.0), torch.bfloat16)
    assert torch.equal(got, bea_dense(x, w, a, b, e, mask, 2.0))


@pytest.mark.cuda
def test_flash_zamba2_shared_call_matches_plain(cuda):
    """The shared block's training call, 8 × 512, 32 q over 32 kv heads of
    64, causal under a window of 4096 that cannot bind at 512 tokens,
    bf16: the wgmma body against the plain version, and bit for bit the
    same call without the window."""
    from repro_torch.kernels.flash_attention import plan
    rng = np.random.default_rng(32)
    bf = torch.bfloat16
    q, k, v = (_rand(rng, 8, 512, 32, 64, dtype=bf, device=cuda)
               for _ in range(3))
    assert plan(bf, 8, 32, 512, 512, 64).kernel == "wgmma"
    got = mha_flash(q, k, v, causal=True, window=4096)
    _close(got, ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                        causal=True, window=4096), bf)
    assert torch.equal(got, mha_flash(q, k, v, causal=True))


@pytest.mark.cuda
def test_flash_f32_hd32_binding_window_matches_plain(cuda):
    """Zamba2 SMOKE's f32 call: 8 × 512, 4 heads of 32, causal, window 16
    (binding), against the plain version."""
    rng = np.random.default_rng(16)
    q, k, v = (_rand(rng, 8, 512, 4, 32, device=cuda) for _ in range(3))
    got = mha_flash(q, k, v, causal=True, window=16)
    _close(got, ref.flash_attention_ref(q, k, v, causal=True, window=16),
           torch.float32)


@pytest.mark.cuda
def test_zamba2_shared_block_kernels_match_plain(cuda):
    """Zamba2-1.2B's shared block at full width, 8 × 512 bf16 tokens, run
    as ``shared_attn`` (a ``local`` block under window 4096): 7
    ``bea_dense`` and one flash launch, against the plain block."""
    from repro_torch.configs import get_config
    from repro_torch.models import blocks as BK
    from repro_torch.pytree import materialize, tree_map

    cfg = get_config("zamba2_1p2b")
    p = materialize(BK.block_meta(cfg, "shared_attn"), 0, cuda)
    ad = tree_map(lambda t: t + 0.1 * torch.randn_like(t),
                  materialize(BK.block_adapter_meta(cfg, "shared_attn", "bea"),
                              1, cuda))
    x = _rand(np.random.default_rng(9), 8, 512, cfg.d_model,
              dtype=torch.bfloat16, device=cuda)
    K.reset_launches()
    with torch.no_grad():
        yk, _, _ = BK.block_apply(p, x, cfg, mode="train", kind="shared_attn",
                                  ad=ad, use_kernel=True)
        torch.cuda.synchronize()
        launches = K.launch_counts()
        yp, _, _ = BK.block_apply(p, x, cfg, mode="train", kind="shared_attn",
                                  ad=ad)
    assert launches["bea_dense"] == 7 and launches["flash_attention"] == 1
    assert torch.isfinite(yk).all()
    _close(yk, yp, torch.bfloat16)


@pytest.mark.cuda
def test_zamba2_lm_step_kernels_match_plain_on_smoke(cuda):
    """One Zamba2 SMOKE ``lm_loss`` step (f32, 48 tokens, window 16
    binding): loss within 1e-5, every adapter grad (the shared block's
    summed over its two occurrences) within 1e-3 of its largest plain
    value, 2 ``bea_dense`` per mamba layer, 7 and one flash per shared
    occurrence in the forward."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.pytree import flatten_with_paths, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("zamba2_1p2b", smoke=True)
    rng = np.random.default_rng(2)
    kern, plain = Model(cfg), Model(cfg, use_kernels=False)
    base, tr = kern.init(0, cuda)
    tr = tree_map(lambda t: t + 0.1 * torch.randn_like(t), tr)
    masks = kern.init_masks(cuda)
    masks["dec"]["shared"]["attn"]["wq"][1] = False
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 48)))
             .to(cuda) for k in ("tokens", "targets")}

    def step(model):
        flat = []

        def leaf(t):
            flat.append(t.detach().requires_grad_(True))
            return flat[-1]

        req = tree_map(leaf, tr)
        K.reset_launches()
        loss, _ = model.lm_loss(base, req, masks, batch)
        launches = K.launch_counts()
        it = iter(torch.autograd.grad(loss, flat))
        return loss.item(), tree_map(lambda _: next(it), req), launches

    lk, gk, nk = step(kern)
    lp, gp, np_ = step(plain)
    assert nk["bea_dense"] == 2 * 2 + 7 * 2 and nk["flash_attention"] == 2
    assert not any(np_.values())
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    for (path, a), (_, b) in zip(flatten_with_paths(gk),
                                 flatten_with_paths(gp)):
        err = (a - b).abs().max().item()
        assert err <= 1e-3 * max(b.abs().max().item(), 1e-12), path


# ---- InternVL2-1B and the static-batch loop (BART-base's f32 decode) ------

INTERNVL2_KN = [(896, 896), (896, 128), (896, 4864), (4864, 896)]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [6144, 1536, 384])
@pytest.mark.parametrize("k,n", INTERNVL2_KN)
def test_bea_dense_bf16_at_internvl2_rows(cuda, m, k, n):
    """bf16 ``bea_dense`` at InternVL2-1B's linears, r = 8: a training
    step's 8 × (512 + 256) rows, a prefill's 4 × (128 + 256) and one
    request's 384, against the plain version and repeatable."""
    rng = np.random.default_rng(m + k + 7 * n)
    x, w, a, b, e, mask = _dense_operands(rng, m, k, n, 8, torch.bfloat16,
                                          cuda)
    got = bea_dense(x, w, a, b, e, mask, 2.0)
    _close(got, ref.bea_dense_ref(x.float(), w.float(), a.float(), b.float(),
                                  e, mask, 2.0), torch.bfloat16)
    assert torch.equal(got, bea_dense(x, w, a, b, e, mask, 2.0))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(8, 768), (4, 384), (4, 356)])
def test_flash_internvl2_calls_match_plain(cuda, b, s):
    """InternVL2-1B's causal GQA calls (14 q over 2 kv heads of 64, bf16):
    the training call over 256 patch rows and 512 tokens, a prefill of 128
    prompt tokens, and one of 100 (a ragged last tile)."""
    from repro_torch.kernels.flash_attention import plan
    rng = np.random.default_rng(b * s)
    bf = torch.bfloat16
    q = _rand(rng, b, s, 14, 64, dtype=bf, device=cuda)
    k, v = (_rand(rng, b, s, 2, 64, dtype=bf, device=cuda) for _ in range(2))
    assert plan(bf, b, 14, s, s, 64).kernel == "wgmma"
    got = mha_flash(q, k, v, causal=True)
    _close(got, ref.flash_attention_ref(
        q.float(), k.float().repeat_interleave(7, 2),
        v.float().repeat_interleave(7, 2), causal=True), bf)
    assert torch.equal(got, mha_flash(q, k, v, causal=True))


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(768, 768), (768, 3072), (3072, 768)])
def test_bea_batched_f32_at_bart_decode(cuda, k, n):
    """The f32 ``bea_batched`` (``fma_kernel``: one launch, the K-splits
    summed inside a cluster, no workspace) at BART-base's decode linears: 4
    rows of one adapter at rank 12, against the plain version, repeatable,
    and drawing no scratch buffer."""
    from repro_torch.kernels import _scratch

    before = dict(_scratch._BUFFERS)
    rng = np.random.default_rng(k + n)
    x = _rand(rng, 4, k, device=cuda)
    w = _rand(rng, k, n, scale=k ** -0.5, device=cuda)
    a = _rand(rng, 1, 12, k, scale=k ** -0.5, device=cuda)
    b = _rand(rng, 1, n, 12, device=cuda)
    e = _rand(rng, 1, 12, device=cuda)
    mask = torch.ones(1, 12, dtype=torch.bool, device=cuda)
    mask[0, 5] = False
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    K.reset_launches()
    got = bea_batched(x, w, a, b, e, mask, idx, 1.5)
    torch.cuda.synchronize()
    assert K.launch_counts()["bea_batched"] == 1
    _close(got, ref.bea_batched_ref(x, w, a, b, e, mask, idx, 1.5),
           torch.float32)
    assert torch.equal(got, bea_batched(x, w, a, b, e, mask, idx, 1.5))
    assert _scratch._BUFFERS.keys() == before.keys()
    assert all(_scratch._BUFFERS[k] is v for k, v in before.items())


@pytest.mark.cuda
@pytest.mark.parametrize("arch,per_step", [("internvl2_1b", 14), ("bart", 16)])
def test_static_batch_loop_kernels_match_plain_on_smoke(cuda, arch,
                                                        per_step):
    """``legacy_static_batch`` at SMOKE (f32) through the kernels and,
    teacher-forced on its tokens, through the plain versions: every step's
    logits within 1e-4 of plain, each decode step ``per_step``
    ``bea_batched`` launches (7 a layer for InternVL2; self q/k/v/o, cross
    q/o, fc1, fc2 for BART) and no flash."""
    import argparse

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import legacy_static_batch
    from repro_torch.models import Model
    from repro_torch.pytree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch, smoke=True)
    model = Model(cfg)
    base, tr = model.init(0, cuda)
    tr = tree_map(lambda t: t + 0.1 * torch.randn_like(t), tr)
    params = (base, tr, model.init_masks(cuda))
    args = argparse.Namespace(batch=3, prompt_len=12, gen=5, device="cuda")
    K.reset_launches()
    kern = legacy_static_batch(cfg, args, params=params)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    plain = legacy_static_batch(cfg, args, params=params, use_kernels=False,
                                force=kern["tokens"])
    assert launches["bea_batched"] == per_step * (args.gen - 1)
    assert launches["bea_dense"] > 0 and launches["flash_attention"] == (
        6 if arch == "bart" else 2)
    for a, b in zip(kern["logits"], plain["logits"]):
        assert torch.isfinite(a).all()
        _close(a, b, torch.float32)
