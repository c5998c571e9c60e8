"""Why the f32 kernels run 3xTF32, checked on the CPU.

The f32 instances of ``bea_dense`` and ``flash_attention``
(``src/repro_torch/csrc``) split every f32 operand into a TF32 "big" and
"small" part (``csrc/mma.cuh:split_tf32``) and run three tensor-core
products, dropping small·small.  This file emulates that split bit for bit
in torch (big: add 0x1000 to the bits and clear the low 13, round to
nearest with ties away from zero, as ``cvt.rna`` rounds; small: v − big,
exact in f32, with the low 13 bits cleared) and shows, at DistilBERT's
training shapes and on inputs drawn as ``chip_smoke.py`` draws them, that
3xTF32 holds the kernels' f32 tolerance of 1e-4 (relative to the largest
exact value) while one TF32 product does not.  The emulated adapter linear
is also held against the JAX reference (``repro.kernels.ref``).

A product of two TF32 values is exact in f32 (11 + 11 significant bits), so
an f32 matmul of split parts computes what the tensor cores compute, up to
the order of the f32 sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref

TOL = 1e-4                 # the f32 kernels' tolerance, relative to max |exact|
MASK13 = ~0x1FFF           # the 13 low mantissa bits that TF32 drops


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round to TF32, nearest, ties away from zero (``cvt.rna``)."""
    return ((x.view(torch.int32) + 0x1000) & MASK13).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    return (x.view(torch.int32) & MASK13).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    big = tf32_round(x)
    return big, tf32_trunc(x - big)


def mm_1x(a, b):
    return tf32_round(a) @ tf32_round(b)


def mm_3x(a, b):
    (ab, asm), (bb, bsm) = split(a), split(b)
    return asm @ bb + ab @ bsm + ab @ bb


def _rel(got: torch.Tensor, exact: torch.Tensor) -> float:
    return ((got.double() - exact).abs().max() / exact.abs().max()).item()


def _linear(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(k, n)) / np.sqrt(k))
                         .astype(np.float32))
    return x, w


def test_split_keeps_f32_precision():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=100_000)
                          * 10.0 ** rng.integers(-20, 20, 100_000))
                         .astype(np.float32))
    big, small = split(x)
    for part in (big, small):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert (small.abs() <= big.abs() * 2.0 ** -11).all()
    # what 3xTF32 drops: the small part's own rounding, ≤ 2^-21 of |x|
    err = (x.double() - big.double() - small.double()).abs()
    assert (err <= x.abs().double() * 2.0 ** -21).all()
    assert torch.equal(tf32_round(torch.tensor([1.0 + 2.0 ** -11])),
                       torch.tensor([1.0 + 2.0 ** -10]))   # a tie, away


@pytest.mark.parametrize("k,n", [(768, 768), (768, 3072), (3072, 768)])
def test_3xtf32_holds_the_f32_tolerance_where_1xtf32_misses(k, n):
    """x·W at M = 1024 (8 × 128 tokens) for each DistilBERT linear."""
    x, w = _linear(1024, k, n, seed=k + n)
    exact = x.double() @ w.double()
    one, three = _rel(mm_1x(x, w), exact), _rel(mm_3x(x, w), exact)
    assert three <= TOL / 20, three
    assert one > 2 * TOL, one
    assert _rel(x @ w, exact) <= TOL / 20        # f32 FMAs, for scale


def _attention(q, k, v, mm):
    """softmax(q·kᵀ/√hd)·v with both products through ``mm``, f32 softmax."""
    s = mm(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    return mm(torch.softmax(s, dim=-1), v)


def test_attention_3xtf32_holds_the_f32_tolerance_where_1xtf32_misses():
    """Non-causal attention at the training shape: B = 8, S = 128, 12 heads
    of 64 (as (B·H, S, hd))."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=(96, 128, 64))
                                .astype(np.float32)) for _ in range(3))
    exact = _attention(q.double(), k.double(), v.double(), torch.matmul)
    one = _rel(_attention(q, k, v, mm_1x), exact)
    three = _rel(_attention(q, k, v, mm_3x), exact)
    assert three <= TOL / 20, three
    assert one > 2 * TOL, one


def test_3xtf32_adapter_linear_matches_the_jax_reference():
    """The f32 ``bea_dense`` kernel's arithmetic, emulated: acc = x·W, the
    rank accumulator u = x·Aᵀ, then acc += (s·u⊙e⊙m)·Bᵀ, every product
    3xTF32, against ``repro.kernels.ref.bea_dense_ref`` at the width of a
    DistilBERT layer (r = 12, one rank masked).  One TF32 product instead
    misses the tolerance."""
    m, k, n, r, s = 1024, 768, 768, 12, 16 / 12
    x, w = _linear(m, k, n, seed=3)
    rng = np.random.default_rng(4)
    a = torch.from_numpy((rng.normal(size=(r, k)) / np.sqrt(k))
                         .astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(n, r)).astype(np.float32))
    e = torch.from_numpy(rng.normal(size=(r,)).astype(np.float32))
    mask = np.ones(r, bool)
    mask[r // 2] = False
    want = torch.from_numpy(np.array(jref.bea_dense_ref(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
        jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
        jnp.asarray(e.numpy()), jnp.asarray(mask), s)))
    em = s * e * torch.from_numpy(mask)

    def kernel(mm):
        return mm(x, w) + mm(mm(x, a.T) * em, b.T)

    assert _rel(kernel(mm_3x), want.double()) <= TOL / 20
    assert _rel(kernel(mm_1x), want.double()) > 2 * TOL
