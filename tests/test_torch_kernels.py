"""Port parity for the kernel slice, on the CPU: each kernel wrapper's plain
version against the JAX oracle (``repro.kernels.ref``) and the Pallas kernel
in interpret mode, on the same numpy inputs, at the reference tests'
tolerances.  The CUDA kernels themselves run only on the card
(``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.bea_batched import bea_batched as pallas_batched
from repro.kernels.bea_fused import bea_dense as pallas_dense
from repro.kernels.flash_attention import mha_flash as pallas_mha
from repro_torch import kernels as K
from repro_torch.kernels import ops
from repro_torch.kernels.bea_batched import bea_batched
from repro_torch.kernels.bea_fused import bea_dense
from repro_torch.kernels.flash_attention import flash_attention, mha_flash

# ------------------------------------------------------------- bea_dense ---

SHAPES = [(8, 16, 8, 2), (64, 64, 64, 4), (100, 96, 80, 8),
          (256, 512, 128, 16), (33, 48, 65, 3)]        # tests/test_kernels.py


def _dense_inputs(m, k, n, r, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, k)).astype(np.float32),
            (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32),
            (rng.normal(size=(r, k)) / np.sqrt(k)).astype(np.float32),
            rng.normal(size=(n, r)).astype(np.float32),
            rng.normal(size=(r,)).astype(np.float32),
            rng.integers(0, 2, (r,)).astype(bool))


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("m,k,n,r", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bea_dense_plain_matches_reference_and_pallas(m, k, n, r, dtype):
    x, w, a, b, e, msk = _dense_inputs(m, k, n, r)
    tdt = getattr(torch, dtype)
    got = bea_dense(_t(x, tdt), _t(w, tdt), _t(a, tdt), _t(b, tdt), _t(e),
                    _t(msk), scaling=1.5).float().numpy()
    want = np.asarray(jref.bea_dense_ref(x, w, a, b, e, msk.astype(np.float32),
                                         1.5))
    tol = 5e-5 if dtype == "float32" else 0.05
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())
    jdt = getattr(jnp, dtype)
    pallas = pallas_dense(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                          jnp.asarray(a, jdt), jnp.asarray(b, jdt), e,
                          msk.astype(np.float32), scaling=1.5, block_m=32,
                          block_n=32, block_k=32)
    pallas = np.asarray(pallas.astype(jnp.float32))
    np.testing.assert_allclose(got, pallas, rtol=tol,
                               atol=tol * np.abs(want).max())


def test_bea_dense_fully_masked_adapter_is_plain_matmul():
    x, w, a, b, e, _ = _dense_inputs(32, 32, 32, 4)
    got = bea_dense(_t(x), _t(w), _t(a), _t(b), _t(e),
                    torch.zeros(4, dtype=torch.bool), scaling=3.0)
    np.testing.assert_allclose(got.numpy(), x @ w, rtol=1e-5, atol=1e-5)


def test_adapted_dense_paths_agree_and_cpu_launches_nothing():
    x, w, a, b, e, msk = _dense_inputs(16, 24, 20, 4)
    x3 = _t(x).reshape(2, 8, 24)
    K.reset_launches()
    unfused = ops.adapted_dense(x3, _t(w), _t(a), _t(b), _t(e), _t(msk), 1.3,
                                use_kernel=False)
    fused = ops.adapted_dense(x3, _t(w), _t(a), _t(b), _t(e), _t(msk), 1.3,
                              use_kernel=True)
    assert fused.shape == (2, 8, 20)
    np.testing.assert_allclose(unfused.numpy(), fused.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert K.launch_counts() == {"bea_dense": 0, "bea_dense_grouped": 0,
                                 "bea_batched": 0, "flash_attention": 0}


# ----------------------------------------------------------- bea_batched ---

def _batched_inputs(m, k, n, g, r, seed=0):             # tests/test_serving.py
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, k)).astype(np.float32),
            (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32),
            (rng.normal(size=(g, r, k)) / np.sqrt(max(k, 1))).astype(np.float32),
            rng.normal(size=(g, n, r)).astype(np.float32),
            rng.normal(size=(g, r)).astype(np.float32),
            rng.integers(0, 2, (g, r)).astype(np.float32),
            rng.integers(0, g, (m,)).astype(np.int32))


@pytest.mark.parametrize("m,k,n,g,r", [
    (8, 16, 8, 2, 4), (33, 48, 65, 4, 8), (16, 64, 32, 1, 4),
    (5, 24, 40, 6, 8), (12, 30, 20, 3, 4)])
def test_bea_batched_plain_matches_reference_and_pallas(m, k, n, g, r):
    x, w, a, b, e, msk, idx = _batched_inputs(m, k, n, g, r, seed=m + r)
    if g >= 2:
        msk[1] = 0.0                           # one fully-pruned adapter
    got = bea_batched(_t(x), _t(w), _t(a), _t(b), _t(e), _t(msk).bool(),
                      _t(idx), scaling=1.5).numpy()
    want = np.asarray(jref.bea_batched_ref(x, w, a, b, e, msk, idx, 1.5))
    assert np.abs(got - want).max() <= 1e-5
    pallas = np.asarray(pallas_batched(x, w, a, b, e, msk, idx, scaling=1.5,
                                       block_m=32, block_n=32, block_k=32))
    assert np.abs(got - pallas).max() <= 1e-5


def test_bea_batched_rank_zero_bucket_is_dense():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(7, 24)).astype(np.float32)
    w = rng.normal(size=(24, 16)).astype(np.float32)
    got = bea_batched(_t(x), _t(w), torch.zeros(2, 0, 24),
                      torch.zeros(2, 16, 0), torch.zeros(2, 0),
                      torch.zeros(2, 0, dtype=torch.bool),
                      torch.zeros(7, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), x @ w, rtol=1e-6, atol=1e-6)


def test_bea_batched_fully_pruned_rows_equal_dense():
    x, w, a, b, e, msk, _ = _batched_inputs(9, 16, 12, 3, 4)
    msk[2] = 0.0
    idx = np.full((9,), 2, np.int32)           # every row → pruned adapter
    got = bea_batched(_t(x), _t(w), _t(a), _t(b), _t(e), _t(msk).bool(),
                      _t(idx), scaling=3.0)
    np.testing.assert_allclose(got.numpy(), x @ w, rtol=1e-5, atol=1e-5)


def test_adapted_dense_multi_paths_agree():
    x, w, a, b, e, msk, idx = _batched_inputs(10, 20, 14, 3, 8, seed=7)
    args = (_t(x), _t(w), _t(a), _t(b), _t(e), _t(msk).bool(), _t(idx), 1.3)
    unfused = ops.adapted_dense_multi(*args, use_kernel=False)
    fused = ops.adapted_dense_multi(*args, use_kernel=True)
    np.testing.assert_allclose(unfused.numpy(), fused.numpy(), rtol=1e-4,
                               atol=1e-4)


# ----------------------------------------------------------------- flash ---

CASES = [                                        # tests/test_flash_kernel.py
    # B, S, H, KV, hd, causal, window, softcap
    (2, 128, 4, 4, 32, True, 0, 0.0),
    (2, 128, 4, 2, 32, True, 0, 0.0),
    (1, 256, 4, 1, 64, True, 32, 0.0),
    (2, 128, 4, 4, 32, False, 0, 0.0),
    (2, 128, 8, 2, 32, True, 0, 50.0),
    (1, 384, 6, 3, 16, True, 128, 30.0),
]


def _qkv(b, s, h, kv, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, hd)).astype(np.float32),
            rng.normal(size=(b, s, kv, hd)).astype(np.float32),
            rng.normal(size=(b, s, kv, hd)).astype(np.float32))


@pytest.mark.parametrize("b,s,h,kv,hd,causal,window,cap", CASES)
def test_flash_plain_matches_oracle_and_pallas(b, s, h, kv, hd, causal,
                                               window, cap):
    q, k, v = _qkv(b, s, h, kv, hd, b * 100 + s)
    got = mha_flash(_t(q), _t(k), _t(v), causal=causal, window=window,
                    softcap=cap).numpy()
    g = h // kv
    want = np.asarray(jref.flash_attention_ref(
        q, np.repeat(k, g, 2), np.repeat(v, g, 2), causal=causal,
        window=window, softcap=cap))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    pallas = np.asarray(pallas_mha(q, k, v, causal=causal, window=window,
                                   softcap=cap, block_q=64, block_k=64))
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("s,window", [(37, 0), (100, 0), (130, 48)])
def test_flash_ragged_lengths_match_oracle(s, window):
    """Sequences that divide no block — the Pallas kernel refuses them; the
    port's kernel masks the tail (here: its plain version)."""
    q, k, v = _qkv(1, s, 14, 2, 64, s)
    got = mha_flash(_t(q), _t(k), _t(v), causal=True, window=window).numpy()
    want = np.asarray(jref.flash_attention_ref(
        q, np.repeat(k, 7, 2), np.repeat(v, 7, 2), causal=True,
        window=window))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_flash_attention_bh_layout_matches_mha():
    q, k, v = _qkv(2, 40, 4, 2, 32, 3)
    want = mha_flash(_t(q), _t(k), _t(v))
    qf = _t(q).permute(0, 2, 1, 3).reshape(8, 40, 32)
    kf = _t(k).permute(0, 2, 1, 3).reshape(4, 40, 32)
    vf = _t(v).permute(0, 2, 1, 3).reshape(4, 40, 32)
    got = flash_attention(qf, kf, vf, group=2)
    got = got.reshape(2, 4, 40, 32).permute(0, 2, 1, 3)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_flash_bf16():
    q, k, v = _qkv(1, 128, 2, 2, 32, 0)
    got = mha_flash(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                    _t(v, torch.bfloat16)).float().numpy()
    want = np.asarray(jref.flash_attention_ref(q, k, v))
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05)
