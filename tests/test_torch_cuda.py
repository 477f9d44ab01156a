"""The port's CUDA kernel on the card: `segment_sum_sorted` against its plain
version, and the trainer on the card against the same trainer on the CPU.

Every test here needs a CUDA device and skips without one. The file imports
neither JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: per segment |kernel - ref64| <= 1e-5 * sum|contrib| in float32
(a float32 sum of k terms in another order differs by a few k*eps relative
to the sum of magnitudes) and 1e-12 in float64; the trainer's float64 z to
1e-8, as the CPU port is held to the JAX trainer.
"""

import numpy as np
import pytest
import torch

from mlease_tpu_torch.ops.segment_sum import (segment_sum_sorted,
                                              segment_sum_sorted_reference)

# one kernel block's chunk of entries (kThreads * kItems in the source)
CHUNK = 256 * 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def check(contrib, seg, S, tol):
    got = segment_sum_sorted(contrib, seg, S)
    ref = segment_sum_sorted_reference(contrib.double(), seg, S)
    scale = segment_sum_sorted_reference(contrib.double().abs(), seg, S)
    torch.cuda.synchronize()
    assert got.dtype == contrib.dtype and got.shape == (contrib.shape[0], S)
    err = (got.double() - ref).abs()
    assert bool((err <= tol * scale).all()), float(err.max())
    return got


def zipf_stream(rng, T, S):
    return np.sort(rng.zipf(1.3, size=T) % S).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,L,tol", [(torch.float32, 1, 1e-5),
                                         (torch.float32, 3, 1e-5),
                                         (torch.float32, 6, 1e-5),
                                         (torch.float64, 6, 1e-12)])
def test_zipf_stream(cuda, dtype, L, tol):
    rng = np.random.default_rng(L)
    seg = torch.as_tensor(zipf_stream(rng, 200_000, 50_000), device=cuda)
    contrib = torch.as_tensor(rng.normal(size=(L, seg.numel())), dtype=dtype,
                              device=cuda)
    before = segment_sum_sorted.launches
    check(contrib, seg, 50_000, tol)
    assert segment_sum_sorted.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 31, CHUNK - 1, CHUNK, CHUNK + 1,
                               3 * CHUNK + 7])
def test_chunk_edges(cuda, T):
    """Streams ending inside, at and just past a block's chunk, with runs
    that cross thread, warp and chunk boundaries."""
    rng = np.random.default_rng(T)
    seg = torch.as_tensor(np.sort(rng.integers(0, max(T // 40, 1), T))
                          .astype(np.int32), device=cuda)
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        contrib = torch.as_tensor(rng.normal(size=(3, T)), dtype=dtype,
                                  device=cuda)
        check(contrib, seg, max(T // 40, 1) + 5, tol)


@pytest.mark.cuda
def test_empty_segments_exact_zero_and_one_giant_segment(cuda):
    rng = np.random.default_rng(7)
    ids = np.sort(rng.choice(np.arange(0, 100_000, 97), 50_000))
    seg = torch.as_tensor(ids.astype(np.int32), device=cuda)
    got = check(torch.randn((3, seg.numel()), device=cuda, dtype=torch.float64),
                seg, 100_000, 1e-12)
    empty = torch.ones(100_000, dtype=torch.bool, device=cuda)
    empty[seg.long()] = False
    assert bool((got[:, empty] == 0).all())

    seg = torch.full((1_000_000,), 12, dtype=torch.int32, device=cuda)
    contrib = torch.randn((6, seg.numel()), device=cuda)
    got = check(contrib, seg, 40, 1e-5)
    assert bool((got[:, :12] == 0).all()) and bool((got[:, 13:] == 0).all())


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    seg = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="float32 or float64"):
        segment_sum_sorted(torch.ones((2, 8), dtype=torch.float16,
                                      device=cuda), seg, 4)
    with pytest.raises(ValueError, match="one device"):
        segment_sum_sorted(torch.ones((2, 8)), seg, 4)


def blocked_data(seed, B=4, R=2000, n_features=3000, nnz=8):
    from mlease_tpu_torch.core.dataset import BlockedData

    rng = np.random.default_rng(seed)
    n = n_features + 1
    cols = (rng.zipf(1.3, size=(B, R, nnz)) - 1) % n_features
    indices = np.concatenate([cols, np.full((B, R, 1), n_features)],
                             axis=2).astype(np.int32)
    values = np.concatenate([rng.normal(size=(B, R, nnz)) * 0.5,
                             np.ones((B, R, 1))], axis=2)
    w = rng.normal(size=n) * 0.3
    p = 1.0 / (1.0 + np.exp(-np.einsum("brk,brk->br", values, w[indices])))
    y = np.where(rng.random((B, R)) < p, 1.0, -1.0)
    present = np.zeros((B, n), dtype=bool)
    for b in range(B):
        present[b, np.unique(indices[b])] = True
    return BlockedData(indices=indices, values=values, y=y,
                       weight=np.ones((B, R)), offset=np.zeros((B, R)),
                       present=present, nrows=np.full(B, R, np.int32),
                       nblocks=B, dim=n)


@pytest.mark.cuda
def test_trainer_on_card_matches_cpu(cuda):
    from mlease_tpu_torch.core.vocab import FeatureVocab
    from mlease_tpu_torch.train.admm import AdmmConfig, AdmmTrainer

    data = blocked_data(11)
    vocab = FeatureVocab.from_names(f"f{i}" for i in range(3000))
    cfg = AdmmConfig(lambdas=[1.0, 10.0, 100.0], num_iters=3, head_size=64,
                     dtype=torch.float64)
    want = AdmmTrainer(data, vocab, cfg, device="cpu").run()
    before = segment_sum_sorted.launches
    got = AdmmTrainer(data, vocab, cfg, device=cuda).run()
    assert segment_sum_sorted.launches > before
    np.testing.assert_allclose(got.z, want.z, rtol=0, atol=1e-8)
    assert got.solver_stats == want.solver_stats
