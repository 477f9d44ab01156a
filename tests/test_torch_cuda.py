"""The port's CUDA kernels on the card: `segment_sum_sorted` and
`gram_batched` against their plain versions, and the trainers on the card
against the same trainers on the CPU.

Every test here needs a CUDA device and skips without one. The file imports
neither JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: per segment |kernel - ref64| <= 1e-5 * sum|contrib| in float32
(a float32 sum of k terms in another order differs by a few k*eps relative
to the sum of magnitudes) and 1e-12 in float64; the trainer's float64 z to
1e-8, as the CPU port is held to the JAX trainer. The Gram kernel likewise:
per entry |G - G64| <= 1e-5 * sum_r |d x_i x_j| for float32 and bfloat16
inputs (the float64 reference is taken from the bf16-rounded inputs, so
only the accumulation is judged), 1e-12 for float64, and G == G' exactly.
"""

import numpy as np
import pytest
import torch

from mlease_tpu_torch.ops import _build
from mlease_tpu_torch.ops import gram as gram_mod
from mlease_tpu_torch.ops.gram import gram_batched, gram_batched_reference
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


# ---------------------------------------------------------------------------
# K2: the weighted Gram kernel
# ---------------------------------------------------------------------------

def check_gram(x, d, pvi, tol):
    got = gram_batched(x, d, pvi)
    x64, d64 = x.double(), d.to(x.dtype).double()
    ref = gram_batched_reference(x64, d64, None if pvi is None
                                 else pvi.double())
    scale = gram_batched_reference(x64.abs(), d64.abs())
    torch.cuda.synchronize()
    assert got.dtype == gram_mod.accumulate_dtype(x.dtype)
    assert got.shape == ref.shape
    err = (got.double() - ref).abs()
    assert bool((err <= tol * scale + 1e-300).all()), float(err.max())
    assert bool((got == got.transpose(1, 2)).all())      # exactly symmetric
    return got


def gram_inputs(cuda, seed, B, R, F, dtype, shared=False):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    shape = (R, F) if shared else (B, R, F)
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    d = torch.rand((B, R), generator=gen, device=cuda).to(dtype)
    pvi = torch.rand((B, F), generator=gen, device=cuda).to(
        gram_mod.accumulate_dtype(dtype)) + 0.5
    return x, d, pvi


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,F,dtype,tol", [
    (20_000, 64, 16, torch.float32, 1e-5),
    (20_000, 64, 16, torch.float64, 1e-12),
    (20_000, 256, 64, torch.float32, 1e-5)])
def test_gram_item_bucket_shapes(cuda, B, R, F, dtype, tol):
    x, d, pvi = gram_inputs(cuda, F, B, R, F, dtype)
    before = gram_batched.launches
    check_gram(x, d, pvi, tol)
    assert gram_batched.launches == before + 1
    cfg = gram_mod.launch_config(B, R, F, dtype)
    assert cfg.nsplit == 1                                  # no row split
    assert cfg.variant == ("item" if F <= 16 else "mma")


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,F,dtype,shared", [
    (3, 1_562_500, 128, torch.float32, True),      # the head block
    (3, 16_384, 512, torch.float32, True),         # ... at the bench shape
    (1, 131_072, 512, torch.float32, False),       # the TPU docstring's shape
    (1, 131_072, 512, torch.bfloat16, False),
    (1, 131_072, 256, torch.float32, False),
    (1, 131_072, 192, torch.float64, False)])
def test_gram_long_problems_split_over_rows(cuda, B, R, F, dtype, shared):
    x, d, pvi = gram_inputs(cuda, R % 97, B, R, F, dtype, shared)
    cfg = gram_mod.launch_config(B, R, F, dtype, shared)
    assert cfg.nsplit > 1 and cfg.variant == "mma"
    assert cfg.lanes == (3 if shared else 1)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    got = check_gram(x, d, pvi, tol)
    again = gram_batched(x, d, pvi)          # no atomics: the same bits
    assert bool((got == again).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,F", [(7, 1, 8), (5, 37, 13), (3, 100, 24),
                                   (2, 300, 70), (2, 4099, 200),
                                   (1, 2049, 130), (300, 33, 16)])
def test_gram_edge_shapes(cuda, B, R, F):
    """R = 1, ragged last row chunks, F off the tile sizes, rows with
    d = 0, no prior, and one shared X."""
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12),
                       (torch.bfloat16, 1e-5)):
        x, d, pvi = gram_inputs(cuda, B + R, B, R, F, dtype)
        d[:, ::3] = 0
        check_gram(x, d, pvi, tol)
        check_gram(x[0], d, None, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,R,F,shared,variant", [
    (500, 64, 16, False, "item"),       # a warp per entry
    (500, 200, 8, False, "item"),       # ... over several row chunks
    (200, 70, 12, True, "item"),        # ... all reading one X
    (6, 9_000, 16, False, "fma"),       # few long entries with F <= 16
    (200, 256, 64, False, "mma"),       # the mid buckets, no row split
    (5, 3_000, 200, False, "mma"),      # F off the tile, rows split
    (4, 3_000, 96, True, "mma"),        # lanes sharing X, 3 + 1
    (2, 777, 24, True, "mma"),
    (3, 2_049, 130, False, "mma"),      # rows of 520 bytes: element copies
    (3, 2_049, 130, True, "mma"),
    (2, 1_000, 203, False, "mma"),      # odd F: ragged in every type
    (5, 37, 13, False, "fma")])
def test_gram_variants(cuda, B, R, F, shared, variant):
    """Every variant at aligned and ragged F, shared and batched X, each
    type: tolerance, exact symmetry, the launch policy's choice, and a
    second call that gives the same bits (no atomics anywhere)."""
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12),
                       (torch.bfloat16, 1e-5)):
        x, d, pvi = gram_inputs(cuda, B + R + F, B, R, F, dtype, shared)
        d[:, ::4] = 0
        cfg = gram_mod.launch_config(B, R, F, dtype, shared,
                                     x.data_ptr() % 16 == 0)
        # `variant` is float32's; rows of another type may be 16-byte
        # multiples where float32's are not, and the other way round
        rows16 = (F * x.element_size()) % 16 == 0
        if F > 16:
            want = "mma" if rows16 or x.element_size() >= 4 else "fma"
        else:
            want = variant if rows16 else "fma"
        assert cfg.variant == want, (dtype, cfg)
        before = gram_batched.launches
        got = check_gram(x, d, pvi, tol)
        assert gram_batched.launches == before + 1
        assert bool((got == gram_batched(x, d, pvi)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("F,variant", [(32, "mma"), (16, "fma")])
def test_gram_unaligned_x(cuda, F, variant):
    """A view whose first element is off a 16-byte boundary: no 16-byte
    copies. Above the item width the tensor-core variant stages it element
    by element and gives the same bits as for an aligned x; at the item
    width the FMA kernel takes it, equal to the tolerance."""
    x, d, pvi = gram_inputs(cuda, 3, 200, 60, F, torch.float32)
    flat = torch.empty(x.numel() + 1, device=cuda)
    off = flat[1:].view_as(x).copy_(x)
    assert off.data_ptr() % 16 != 0 and off.is_contiguous()
    assert gram_mod.launch_config(200, 60, F, torch.float32, False,
                                  False).variant == variant
    got = check_gram(off, d, pvi, 1e-5)
    want = check_gram(x, d, pvi, 1e-5)
    if variant == "mma":
        assert bool((got == want).all())
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_gram_lanes_sharing_x_equal_one_lane_at_a_time(cuda, dtype):
    """Three lanes over one staged X against one call per lane. Where
    neither call splits the rows (R below the smallest split) every entry
    sums the same k-steps in the same order: bit for bit. Where the row
    splits differ, to the tolerance."""
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for R, F, exact in ((400, 64, True), (400, 160, True),
                        (40_000, 160, False)):
        x, d, pvi = gram_inputs(cuda, R, 3, R, F, dtype, shared=True)
        together = check_gram(x, d, pvi, tol)
        assert gram_mod.launch_config(3, R, F, dtype, True).lanes == 3
        alone = torch.cat([gram_batched(x, d[b:b + 1], pvi[b:b + 1])
                           for b in range(3)])
        if exact:
            assert gram_mod.launch_config(3, R, F, dtype, True).nsplit == 1
            assert bool((together == alone).all())
        else:
            scale = gram_batched_reference(x.double().abs(),
                                           d.double().abs())
            assert bool(((together - alone).abs().double()
                         <= 2 * tol * scale).all())


@pytest.mark.cuda
def test_gram_wrapper_raises_rather_than_falling_back(cuda, monkeypatch,
                                                      tmp_path):
    x, d, pvi = gram_inputs(cuda, 0, 4, 16, 8, torch.float32)
    with pytest.raises(TypeError, match="float32, float64 or bfloat16"):
        gram_batched(x.half(), d.half(), pvi)
    with pytest.raises(ValueError, match="one device"):
        gram_batched(x, d.cpu(), pvi)
    # no library and no compiler: the call raises, it does not take the
    # plain version
    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(gram_mod, "_fns", {})
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc", no_nvcc)
    before = gram_batched.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        gram_batched(x, d, pvi)
    assert gram_batched.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["cholesky", "tron"])
def test_item_trainer_on_card_matches_cpu(cuda, solver):
    from mlease_tpu_torch.train.item import ItemConfig, train_item_models

    rng = np.random.default_rng(5)
    keyed = {}
    for i in range(40):
        n = int(rng.integers(20, 90))
        keyed[f"it{i}"] = [{
            "response": int(rng.integers(0, 2)), "weight": 1.0, "offset": 0.0,
            "features": [(f"f{int(j)}", float(rng.normal()))
                         for j in rng.choice(9, 3, replace=False)]}
            for _ in range(n)]
    cfg = ItemConfig(intercept_lambdas=[1.0], default_lambdas=[1.0, 10.0],
                     compute_var=True, full_cov=True, solver=solver,
                     liblinear_epsilon=1e-8, dtype=torch.float64)
    want = train_item_models(keyed, cfg, device="cpu")
    before = gram_batched.launches
    got = train_item_models(keyed, cfg, device=cuda)
    trips = sum(s["newton_trips"] for s in got.solver_stats)
    expected = len(got.solver_stats) + (trips if solver == "cholesky" else 0)
    assert gram_batched.launches - before == expected
    assert set(got.models) == set(want.models)
    for key, m in want.models.items():
        assert got.models[key].intercept == pytest.approx(m.intercept,
                                                          rel=1e-6, abs=1e-8)
        for name, v in m.coefficients.items():
            assert got.models[key].coefficients[name] == pytest.approx(
                v, rel=1e-6, abs=1e-8)
        pv, pw = got.posterior_var[key], want.posterior_var[key]
        assert pv.intercept == pytest.approx(pw.intercept, rel=1e-5)


@pytest.mark.cuda
def test_item_scoring_on_card_matches_cpu(cuda):
    from mlease_tpu_torch.core.linear_model import LinearModel
    from mlease_tpu_torch.eval.item_score import score_item_batch

    rng = np.random.default_rng(6)
    models = {f"{p}#it{i}": LinearModel(
        {f"f{j}": float(rng.normal()) for j in range(6)},
        intercept=float(rng.normal())) for i in range(50) for p in ("1", "2")}
    rows = [{"offset": float(rng.normal()), "features": [
        (f"f{int(j)}", float(rng.normal()))
        for j in rng.choice(7, 3, replace=False)]} for _ in range(5000)]
    items = [f"it{int(rng.integers(0, 60))}" for _ in rows]
    want = score_item_batch(models, rows, items, ["1", "2"], device="cpu")
    before = segment_sum_sorted.launches
    got = score_item_batch(models, rows, items, ["1", "2"], device=cuda)
    assert segment_sum_sorted.launches == before + 1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.cuda
def test_head_block_solve_on_card_matches_cpu(cuda):
    import mlease_tpu_torch.ops.tron_multi as tm

    rng = np.random.default_rng(9)
    R, H, n, K = 3000, 16, 400, 4
    head_x = rng.normal(size=(R, H)) * (rng.random((R, H)) < 0.4)
    idx = rng.integers(H, n, size=(R, K)).astype(np.int64)
    vals = rng.normal(size=(R, K))
    w = rng.normal(size=n) * 0.3
    score = head_x @ w[:H] + (vals * w[idx]).sum(1)
    y = np.where(rng.random(R) < 1 / (1 + np.exp(-score)), 1.0, -1.0)

    def problem(dev):
        t = lambda a: torch.as_tensor(a, device=dev)    # noqa: E731
        return tm.MultiProblem(
            indices=t(idx), values=t(vals), y=t(y), weight=t(np.ones(R)),
            offset=t(np.zeros(R)), prior_mean=t(np.zeros((n, 2))),
            prior_var_inv=t(np.tile([1.0, 10.0], (n, 1))), head_x=t(head_x),
            head_ids=t(np.arange(H)))

    W0 = torch.zeros((n, 2), dtype=torch.float64)
    want = tm.tron_multi(problem("cpu"), W0, 1e-6, precondition="head_block")
    before = gram_batched.launches
    got = tm.tron_multi(problem(cuda), W0.to(cuda), 1e-6,
                        precondition="head_block")
    assert gram_batched.launches - before == got.newton_trips + 1
    np.testing.assert_allclose(got.w.cpu().numpy(), want.w.numpy(), rtol=0,
                               atol=1e-7)
    assert (got.newton_trips, got.cg_trips) == (want.newton_trips,
                                                want.cg_trips)
