"""The port's weighted Gram (mlease_tpu_torch.ops.gram) against the TPU
kernel's interpret run and a float64 einsum, on the same numpy inputs.

On the CPU the wrapper runs its plain version; the CUDA kernel itself is
held against that plain version on the card (tests/test_torch_cuda.py and
chip_smoke.py). Tolerances: float32 and bfloat16 inputs to rtol 1e-5 (atol
1e-4, as tests/test_kernels.py holds the TPU kernel) against the TPU
kernel and the float64 einsum, which add the same float32 products in other
orders; float64 to rtol 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlease_tpu.ops.pallas import gram as jgram
from mlease_tpu_torch.ops import gram as tgram

torch.set_num_threads(1)


def inputs(seed, B, R, F, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, R, F)).astype(dtype)
    d = rng.uniform(0.1, 1.0, size=(B, R)).astype(dtype)
    d[:, ::5] = 0                                   # rows with d = 0
    pvi = rng.uniform(0.5, 2.0, size=(B, F)).astype(dtype)
    return x, d, pvi


def einsum64(x, d, pvi):
    G = np.einsum("bri,br,brj->bij", x.astype(np.float64),
                  d.astype(np.float64), x.astype(np.float64))
    return G + np.stack([np.diag(p.astype(np.float64)) for p in pvi])


@pytest.mark.parametrize("R,F,tile_r", [(300, 24, 64), (100, 16, 32),
                                        (1, 8, 8), (37, 13, 8)])
def test_gram_matrix_matches_tpu_kernel_and_einsum(R, F, tile_r):
    x, d, pvi = inputs(R, 1, R, F)
    got = tgram.gram_matrix(torch.as_tensor(x[0]), torch.as_tensor(d[0]),
                            torch.as_tensor(pvi[0])).numpy()
    assert got.dtype == np.float32 and got.shape == (F, F)
    want = jgram.gram_matrix(jnp.asarray(x[0]), jnp.asarray(d[0]),
                             jnp.asarray(pvi[0]), tile_r=tile_r,
                             interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, einsum64(x, d, pvi)[0], rtol=1e-5,
                               atol=1e-4)


def test_gram_batched_ragged_rows_matches_tpu_kernel():
    x, d, pvi = inputs(1, 3, 100, 16)       # R is no multiple of the TPU tile
    got = tgram.gram_batched(torch.as_tensor(x), torch.as_tensor(d),
                             torch.as_tensor(pvi)).numpy()
    want = jgram.gram_batched(jnp.asarray(x), jnp.asarray(d),
                              jnp.asarray(pvi), tile_r=32, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, einsum64(x, d, pvi), rtol=1e-5, atol=1e-4)


def test_bf16_inputs_accumulate_in_float32():
    x, d, pvi = inputs(2, 2, 96, 16)
    xb = torch.as_tensor(x).to(torch.bfloat16)
    db = torch.as_tensor(d).to(torch.bfloat16)
    got = tgram.gram_batched(xb, torch.as_tensor(d), torch.as_tensor(pvi))
    assert got.dtype == torch.float32
    # only the accumulation is judged: the float64 einsum of the rounded x, d
    want = einsum64(xb.float().numpy(), db.float().numpy(), pvi)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    for b in range(2):
        tpu = jgram.gram_matrix(jnp.asarray(x[b]).astype(jnp.bfloat16),
                                jnp.asarray(d[b]), jnp.asarray(pvi[b]),
                                tile_r=32, interpret=True)
        # the TPU kernel rounds d*x to bf16 before the product: 2^-8 relative
        np.testing.assert_allclose(got[b].numpy(), np.asarray(tpu),
                                   rtol=2e-2, atol=0.3)


def test_float64_and_shared_x():
    x, d, pvi = inputs(3, 4, 50, 12, np.float64)
    got = tgram.gram_batched(torch.as_tensor(x), torch.as_tensor(d),
                             torch.as_tensor(pvi))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), einsum64(x, d, pvi), rtol=1e-12)
    # one X shared by every batch entry (the head-block build)
    shared = tgram.gram_batched(torch.as_tensor(x[0]), torch.as_tensor(d),
                                None).numpy()
    want = einsum64(np.broadcast_to(x[0], x.shape), d, np.zeros_like(pvi))
    np.testing.assert_allclose(shared, want, rtol=1e-12, atol=1e-13)


def test_wrapper_checks_bounds_and_launch_policy():
    x = torch.ones((2, 5, 3))
    d = torch.ones((2, 5))
    before = tgram.gram_batched.launches
    tgram.gram_batched(x, d)
    assert tgram.gram_batched.launches == before       # no kernel on the CPU
    with pytest.raises(ValueError, match="expected x"):
        tgram.gram_batched(x, d[:, :4])
    with pytest.raises(ValueError, match="expected x"):
        tgram.gram_batched(x, d[:1])
    with pytest.raises(ValueError, match="prior_var_inv"):
        tgram.gram_batched(x, d, torch.ones((2, 4)))
    assert tgram.min_bytes(2, 5, 3, 4, 4) == (30 + 10) * 4 + 18 * 4
    assert tgram.min_bytes(2, 5, 3, 2, 4, shared_x=True) == 25 * 2 + 18 * 4
    # symmetric: the upper triangle's multiply-adds, plus folding d in
    assert tgram.min_flops(2, 5, 3) == 2 * 5 * 3 * 4 + 2 * 5 * 3
    assert tgram.min_flops(1, 131_072, 512) < 2 * 131_072 * 512 * 512 * 0.51
    # many tiny problems with F <= 16 go to the item variant: a warp per
    # entry, no row split, no workspace
    assert tgram.launch_config(20_000, 64, 16, torch.float32) == \
        ("item", 16, 1, 1)
    assert tgram.launch_config(20_000, 64, 16, torch.float64).variant == "item"
    # the mid buckets: tensor cores on a 64 tile, still no row split
    assert tgram.launch_config(20_000, 256, 64, torch.float32) == \
        ("mma", 64, 1, 1)
    # one long problem: split over rows; three lanes sharing X in one block
    cfg = tgram.launch_config(3, 1_562_500, 128, torch.float32, shared_x=True)
    assert cfg.variant == "mma" and cfg.lanes == 3 and cfg.tile == 64
    assert cfg.nsplit > 1 and 3 * cfg.nsplit >= 264
    cfg = tgram.launch_config(3, 1_562_500, 128, torch.float32)   # own X each
    assert (cfg.variant, cfg.tile, cfg.lanes) == ("mma", 128, 1)
    cfg = tgram.launch_config(1, 131_072, 512, torch.float64)
    assert (cfg.variant, cfg.tile) == ("mma", 64) and cfg.nsplit > 1
    assert tgram.launch_config(1, 131_072, 512, torch.bfloat16).tile == 128
    assert tgram.launch_config(1, 100, 512, torch.float32).nsplit == 1
    # ragged float32 / float64 rows and an unaligned x stay on the tensor
    # cores (staged element by element); ragged bf16 rows, F <= 16 with
    # ragged rows and few long entries with F <= 16 go, in the open, to the
    # plain FMA kernel
    assert tgram.launch_config(1, 50_001, 130, torch.float32).variant == "mma"
    assert tgram.launch_config(2, 4_099, 200, torch.float32,
                               aligned=False).variant == "mma"
    assert tgram.launch_config(2, 4_099, 200, torch.bfloat16).variant == "mma"
    assert tgram.launch_config(2, 4_099, 203, torch.bfloat16).variant == "fma"
    assert tgram.launch_config(5, 37, 13, torch.float32).variant == "fma"
    assert tgram.launch_config(500, 64, 16, torch.float32,
                               aligned=False).variant == "fma"
    cfg = tgram.launch_config(3, 100_000, 16, torch.float32)
    assert cfg.variant == "fma" and cfg.nsplit > 1
    assert tgram.launch_config(300, 33, 16, torch.float32).variant == "item"
    assert "TF32" in tgram.route("mma", torch.float32)
    assert "bf16" in tgram.route("mma", torch.bfloat16)
    assert "DMMA" in tgram.route("mma", torch.float64)
    assert "FMA" in tgram.route("item", torch.float32)


# ---------------------------------------------------------------------------
# The split arithmetic of the tensor-core variant, emulated in plain PyTorch.
# These functions live here and on no path of the port: they repeat, value
# by value, what csrc/gram_mma_f32.cu and gram_mma_bf16.cu do to an operand
# before the mma, so that the routes' accuracy is held on the CPU too.
# ---------------------------------------------------------------------------

TF32_MASK = -8192            # 0xffffe000 as int32: 10 explicit mantissa bits


def tf32_split(v):
    """float32 -> (hi, lo): hi = v cut to TF32, lo = v - hi cut to TF32 (the
    kernel's `split`)."""
    bits = v.contiguous().view(torch.int32)
    hi = (bits & TF32_MASK).view(torch.float32)
    lo = ((v - hi).view(torch.int32) & TF32_MASK).view(torch.float32)
    return hi, lo


def gram_3xtf32(x, d, kstep=8):
    """G = X' diag(d) X as the kernel's float32 route forms it: A = d * x and
    B = x split into TF32 hi + lo, the products lo*hi + hi*lo + hi*hi of
    every 8 rows summed from zero, then added to a float32 accumulator."""
    a_hi, a_lo = tf32_split(d[:, :, None] * x)
    b_hi, b_lo = tf32_split(x)
    B, R, F = x.shape
    acc = torch.zeros((B, F, F), dtype=torch.float32)
    for r0 in range(0, R, kstep):
        s = slice(r0, r0 + kstep)
        c = torch.einsum("bri,brj->bij", a_lo[:, s], b_hi[:, s])
        c = c + torch.einsum("bri,brj->bij", a_hi[:, s], b_lo[:, s])
        c = c + torch.einsum("bri,brj->bij", a_hi[:, s], b_hi[:, s])
        acc = acc + c
    return acc


@pytest.mark.parametrize("R,F", [(64, 16), (300, 64), (4_099, 200)])
def test_3xtf32_emulation_meets_the_card_tolerance(R, F):
    rng = np.random.default_rng(R + F)
    x = rng.normal(size=(2, R, F)).astype(np.float32)
    # a wide dynamic range in d (12 decades), and rows with d = 0
    d = (10.0 ** rng.uniform(-6, 6, size=(2, R))).astype(np.float32)
    d[:, ::5] = 0
    got = gram_3xtf32(torch.as_tensor(x), torch.as_tensor(d)).numpy()
    x64, d64 = x.astype(np.float64), d.astype(np.float64)
    want = np.einsum("bri,br,brj->bij", x64, d64, x64)
    scale = np.einsum("bri,br,brj->bij", np.abs(x64), d64, np.abs(x64))
    assert np.all(np.abs(got - want) <= 1e-5 * scale)
    # TF32 alone (hi * hi only) keeps three digits and would not do
    a_hi, _ = tf32_split(torch.as_tensor(d)[:, :, None] * torch.as_tensor(x))
    b_hi, _ = tf32_split(torch.as_tensor(x))
    one = torch.einsum("bri,brj->bij", a_hi.double(), b_hi.double()).numpy()
    assert np.any(np.abs(one - want) > 1e-5 * scale)


def test_tf32_split_keeps_21_bits():
    rng = np.random.default_rng(0)
    v = torch.as_tensor((rng.normal(size=100_000)
                         * 10.0 ** rng.uniform(-20, 20, size=100_000))
                        .astype(np.float32))
    hi, lo = tf32_split(v)
    for part in (hi, lo):          # both are TF32 values: low 13 bits clear
        assert bool(((part.view(torch.int32) & 0x1fff) == 0).all())
    err = (v.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -20 * v.double().abs()).all())
    assert bool((hi.abs() <= v.abs()).all())             # hi is cut, not rounded


@pytest.mark.parametrize("R,F", [(64, 16), (300, 64), (4_099, 200)])
def test_bf16_in_product_is_exactly_hi_plus_lo(R, F):
    """d and x are bf16, so d * x has 16 significant bits: hi = bf16(d * x)
    and lo = bf16(d * x - hi) lose nothing, and two bf16 products with
    float32 accumulation meet the float32 tolerance."""
    rng = np.random.default_rng(R * F)
    x = torch.as_tensor(rng.normal(size=(2, R, F)).astype(np.float32)
                        ).to(torch.bfloat16)
    d = torch.as_tensor((10.0 ** rng.uniform(-6, 6, size=(2, R)))
                        .astype(np.float32)).to(torch.bfloat16)
    d[:, ::5] = 0
    p = d.float()[:, :, None] * x.float()              # exact in float32
    assert bool((p.double() == d.double()[:, :, None] * x.double()).all())
    hi = p.to(torch.bfloat16)
    lo = (p - hi.float()).to(torch.bfloat16)
    assert bool((hi.float() + lo.float() == p).all())
    # the kernel's arithmetic: per 16 rows, lo * x + hi * x from zero
    acc = torch.zeros((2, F, F), dtype=torch.float32)
    xf = x.float()
    for r0 in range(0, R, 16):
        s = slice(r0, r0 + 16)
        c = torch.einsum("bri,brj->bij", lo.float()[:, s], xf[:, s])
        c = c + torch.einsum("bri,brj->bij", hi.float()[:, s], xf[:, s])
        acc = acc + c
    x64, d64 = x.double().numpy(), d.double().numpy()
    want = np.einsum("bri,br,brj->bij", x64, d64, x64)
    scale = np.einsum("bri,br,brj->bij", np.abs(x64), d64, np.abs(x64))
    assert np.all(np.abs(acc.numpy() - want) <= 1e-5 * scale)
