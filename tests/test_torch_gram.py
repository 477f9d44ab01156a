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
    # many tiny problems: no row split; one long problem: split over rows
    assert tgram.launch_config(20_000, 64, 16, torch.float32) == (16, 1)
    assert tgram.launch_config(20_000, 256, 64, torch.float32) == (64, 1)
    tile, nsplit = tgram.launch_config(3, 1_562_500, 128, torch.float32)
    assert tile == 128 and nsplit > 1 and 3 * nsplit >= 264
    tile, nsplit = tgram.launch_config(1, 131_072, 512, torch.float64)
    assert tile == 64 and nsplit > 1
    assert tgram.launch_config(1, 100, 512, torch.float32)[1] == 1
