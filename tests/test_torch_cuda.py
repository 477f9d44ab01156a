"""The port's CUDA kernels on the card: `segment_sum_gather` (and its
contrib form `segment_sum_sorted`) and `gram_batched` against their plain
versions, and the trainers on the card
against the same trainers on the CPU.

Every test here needs a CUDA device and skips without one. The file imports
neither JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: per segment |kernel - ref64| <= 1e-5 * (|out0| + sum|contrib|)
in float32 and for bfloat16 inputs into a float32 accumulator, plus
2^-8 * |ref64| (one rounding) into a bfloat16 one (a float32 sum of k
terms in another order differs by a few k*eps relative to the sum of
magnitudes; out0 is the accumulator's value before the call) and 1e-12 in
float64; segments the stream does not touch
keep their bits; the trainer's float64 z to
1e-8, as the CPU port is held to the JAX trainer. The Gram kernel likewise:
per entry |G - G64| <= 1e-5 * sum_r |d x_i x_j| for float32 and bfloat16
inputs (the float64 reference is taken from the bf16-rounded inputs, so
only the accumulation is judged), 1e-12 for float64, and G == G' exactly.
"""

import contextlib

import numpy as np
import pytest
import torch

from mlease_tpu_torch.ops import _build
from mlease_tpu_torch.ops import gram as gram_mod
from mlease_tpu_torch.ops.gram import gram_batched, gram_batched_reference
from mlease_tpu_torch.ops.segment_sum import (CHUNK, segment_sum_gather,
                                              segment_sum_gather_reference,
                                              segment_sum_sorted,
                                              segment_sum_sorted_reference)


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
def test_segment_sum_zipf_stream(cuda, dtype, L, tol):
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
def test_segment_sum_chunk_edges(cuda, T):
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
def test_segment_sum_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    seg = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="float32, float64 or bfloat16"):
        segment_sum_sorted(torch.ones((2, 8), dtype=torch.float16,
                                      device=cuda), seg, 4)
    with pytest.raises(ValueError, match="one device"):
        segment_sum_sorted(torch.ones((2, 8)), seg, 4)


def check_gather(vals, V, idx, seg, S, tol, out0=None, square_from=None,
                 rel=0.0):
    """The fused call against the float64 plain version, accumulator
    included: per segment |got - ref64| <= tol * scale + rel * |ref64|
    (rel: the one rounding of a bfloat16 result); returns the result."""
    got = segment_sum_gather(
        vals, V, idx, seg, S, square_from=square_from,
        out=None if out0 is None else out0.clone())
    f64 = (lambda t: None if t is None else t.double())       # noqa: E731
    absf = (lambda t: None if t is None else t.double().abs())  # noqa: E731
    ref = segment_sum_gather_reference(f64(vals), f64(V), idx, seg, S,
                                       out=None if out0 is None
                                       else f64(out0).clone(),
                                       square_from=square_from)
    scale = segment_sum_gather_reference(absf(vals), absf(V), idx, seg, S,
                                         out=None if out0 is None
                                         else absf(out0),
                                         square_from=square_from)
    torch.cuda.synchronize()
    L = (V if V is not None else vals).shape[0]
    assert got.dtype == (vals.dtype if out0 is None else out0.dtype)
    assert got.shape == (L, S)
    err = (got.double() - ref).abs()
    assert bool((err <= tol * scale + rel * ref.abs()).all()), \
        float(err.max())
    if out0 is not None:                  # untouched segments keep their bits
        hit = torch.zeros(S, dtype=torch.bool, device=seg.device)
        hit[seg.long()] = True
        assert torch.equal(got[:, ~hit], out0[:, ~hit])
    return got


def gather_inputs(rng, T, S, m, L, dtype, cuda, zipf=True):
    seg = (zipf_stream(rng, T, S) if zipf
           else np.sort(rng.integers(0, S, T)).astype(np.int32))
    t = lambda a, dt=dtype: torch.as_tensor(a, dtype=dt, device=cuda)  # noqa
    return (t(rng.normal(size=T)), t(rng.normal(size=(L, m))),
            t(rng.integers(0, m, T), torch.int32), t(seg, torch.int32),
            t(rng.normal(size=(L, S))))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,L,tol", [(torch.float32, 1, 1e-5),
                                         (torch.float32, 3, 1e-5),
                                         (torch.float32, 6, 1e-5),
                                         (torch.float64, 3, 1e-12),
                                         (torch.float64, 6, 1e-12)])
@pytest.mark.parametrize("lanes_minor", [False, True])
def test_segment_gather_zipf_stream_into_accumulator(cuda, dtype, L, tol,
                                                     lanes_minor):
    """The fused gather + weight + reduce into a non-zero accumulator, with
    the last L // 2 lanes squared, as the gradient + diagonal pass calls it,
    from V lanes-major or a lanes-minor view (the same bits); untouched
    segments keep their bits."""
    rng = np.random.default_rng(100 + L)
    vals, V, idx, seg, out0 = gather_inputs(rng, 300_000, 60_000, 40_000, L,
                                            dtype, cuda)
    Vm = V.t().contiguous().t()
    before = segment_sum_sorted.launches
    got = check_gather(vals, Vm if lanes_minor else V, idx, seg, 60_000, tol,
                       out0=out0, square_from=L - L // 2)
    assert segment_sum_sorted.launches == before + 1
    other = segment_sum_gather(vals, V if lanes_minor else Vm, idx, seg,
                               60_000, out=out0.clone(),
                               square_from=L - L // 2)
    assert torch.equal(got, other)


# bfloat16 (K1's bf16 entry): float32 products, sums and carries, one
# rounding into out; per segment |got - ref64| <= 2^-8 |ref64| + 1e-5 *
# (|out0| + sum |contrib|), ref64 the float64 sum of the bf16 inputs
BF16_REL = 2.0 ** -8


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["gather", "contrib"])
@pytest.mark.parametrize("L", [1, 3, 6])
def test_segment_sum_bf16_against_f64_and_plain(cuda, form, L):
    """K1's bf16 entry, both forms, into a non-zero accumulator with the
    last L // 2 lanes squared (the gather form) and into zeros (the contrib
    form), and the plain version on the card (float32 index_add_, one
    rounding), each against the float64 sum of the same bf16 inputs;
    untouched segments keep their bits; one launch per call."""
    rng = np.random.default_rng(300 + L)
    vals, V, idx, seg, out0 = gather_inputs(rng, 300_000, 60_000, 40_000, L,
                                            torch.bfloat16, cuda)
    before = segment_sum_sorted.launches
    if form == "gather":
        sf = L - L // 2
        got = check_gather(vals, V, idx, seg, 60_000, 1e-5, out0=out0,
                           square_from=sf, rel=BF16_REL)
        plain = segment_sum_gather_reference(vals, V, idx, seg, 60_000,
                                             out=out0.clone(), square_from=sf)
    else:
        contrib = torch.as_tensor(rng.normal(size=(L, seg.numel())),
                                  dtype=torch.bfloat16, device=cuda)
        got = check_gather(contrib, None, None, seg, 60_000, 1e-5,
                           rel=BF16_REL)
        assert torch.equal(got, segment_sum_sorted(contrib, seg, 60_000))
        plain = segment_sum_sorted_reference(contrib, seg, 60_000)
    assert segment_sum_sorted.launches == before + 1 + (form == "contrib")
    assert plain.dtype == got.dtype == torch.bfloat16
    # the plain version is held to the same rule against the same ref64
    f64 = (lambda t: None if t is None else t.double())       # noqa: E731
    if form == "gather":
        ref = segment_sum_gather_reference(
            f64(vals), f64(V), idx, seg, 60_000, out=f64(out0).clone(),
            square_from=sf)
        scale = segment_sum_gather_reference(
            f64(vals).abs(), f64(V).abs(), idx, seg, 60_000,
            out=f64(out0).abs(), square_from=sf)
    else:
        ref = segment_sum_sorted_reference(f64(contrib), seg, 60_000)
        scale = segment_sum_sorted_reference(f64(contrib).abs(), seg, 60_000)
    err = (plain.double() - ref).abs()
    assert bool((err <= 1e-5 * scale + BF16_REL * ref.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 3, 6])
def test_segment_sum_bf16_into_float32(cuda, L):
    """K1's bf16 gather form into a float32 accumulator, as a bfloat16
    solve calls it (its scores and X'v sums stay float32): no rounding
    into out, so per segment within 1e-5 * scale of the float64 sum of the
    same bf16 inputs, the last L // 2 lanes squared; the plain version on
    the card to the same bound; untouched segments keep their bits."""
    rng = np.random.default_rng(400 + L)
    vals, V, idx, seg, _ = gather_inputs(rng, 300_000, 60_000, 40_000, L,
                                         torch.bfloat16, cuda)
    out0 = torch.as_tensor(rng.normal(size=(L, 60_000)),
                           dtype=torch.float32, device=cuda)
    sf = L - L // 2
    before = segment_sum_sorted.launches
    got = check_gather(vals, V, idx, seg, 60_000, 1e-5, out0=out0,
                       square_from=sf)
    assert segment_sum_sorted.launches == before + 1
    plain = segment_sum_gather_reference(vals, V, idx, seg, 60_000,
                                         out=out0.clone(), square_from=sf)
    assert plain.dtype == got.dtype == torch.float32
    # the plain version (float32 index_add_, whose atomics sum in another
    # order each run) to the kernel's bound against the same float64 sum
    f64 = (lambda t: t.double())                          # noqa: E731
    ref = segment_sum_gather_reference(f64(vals), f64(V), idx, seg, 60_000,
                                       out=f64(out0).clone(), square_from=sf)
    scale = segment_sum_gather_reference(
        f64(vals).abs(), f64(V).abs(), idx, seg, 60_000,
        out=f64(out0).abs(), square_from=sf)
    assert bool(((plain.double() - ref).abs() <= 1e-5 * scale).all())
    T = 3 * CHUNK + 7                     # a stream of a few steps
    check_gather(vals[:T], V, idx[:T], seg[:T], 60_000, 1e-5, out0=out0,
                 square_from=sf)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 31, CHUNK - 1, CHUNK, CHUNK + 1,
                               3 * CHUNK + 7, 1_000 * CHUNK + 1])
def test_segment_sum_bf16_chunk_edges(cuda, T):
    """bf16 streams ending inside, at and just past a step, and one of many
    steps whose carries take two levels, both forms."""
    rng = np.random.default_rng(T + 1)
    S = max(T // 40, 1) + 5
    vals, V, idx, seg, out0 = gather_inputs(rng, T, S - 5, 500, 3,
                                            torch.bfloat16, cuda, zipf=False)
    out0 = torch.as_tensor(rng.normal(size=(3, S)), dtype=torch.bfloat16,
                           device=cuda)
    check_gather(vals, V, idx, seg, S, 1e-5, out0=out0, square_from=2,
                 rel=BF16_REL)
    contrib = torch.as_tensor(rng.normal(size=(3, T)), dtype=torch.bfloat16,
                              device=cuda)
    check_gather(contrib, None, None, seg, S, 1e-5, rel=BF16_REL)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 31, CHUNK - 1, CHUNK, CHUNK + 1,
                               3 * CHUNK + 7, 1_000 * CHUNK + 1,
                               16_000 * CHUNK + 5])
def test_segment_gather_chunk_edges(cuda, T):
    """Streams ending inside, at and just past a warp's step, and streams
    long enough for several steps per warp and three carry levels; runs
    cross lane, step and warp boundaries; one pointer not 16-byte
    aligned."""
    rng = np.random.default_rng(T)
    S = max(T // 40, 1) + 5
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        vals, V, idx, seg, out0 = gather_inputs(rng, T, S, 500, 3, dtype,
                                                cuda, zipf=False)
        check_gather(vals, V, idx, seg, S, tol, out0=out0)
        check_gather(vals, V, idx, seg, S, tol, square_from=1)
        if T > 1:             # vals one entry in: scalar loads throughout
            check_gather(vals[1:], V, idx[1:], seg[1:], S, tol, out0=out0)
            contrib = torch.randn((3, T), dtype=dtype, device=cuda)
            check(contrib[:, 1:], seg[1:], S, tol)


@pytest.mark.cuda
def test_segment_gather_one_giant_segment_and_empty_segments(cuda):
    """One segment spanning every warp's span (reduced by a tree of
    spans), and a stream that touches one segment in 97."""
    rng = np.random.default_rng(17)
    T = 4_000_000
    seg = torch.full((T,), 9, dtype=torch.int32, device=cuda)
    vals = torch.randn(T, device=cuda)
    V = torch.randn((4, 1000), device=cuda)
    idx = torch.randint(0, 1000, (T,), dtype=torch.int32, device=cuda)
    out0 = torch.randn((4, 20), device=cuda)
    check_gather(vals, V, idx, seg, 20, 1e-5, out0=out0, square_from=2)

    ids = np.sort(rng.choice(np.arange(0, 200_000, 97), 100_000))
    seg = torch.as_tensor(ids.astype(np.int32), device=cuda)
    vals = torch.randn(seg.numel(), dtype=torch.float64, device=cuda)
    idx = torch.randint(0, 1000, (seg.numel(),), dtype=torch.int32,
                        device=cuda)
    got = check_gather(vals, V.double(), idx, seg, 200_000, 1e-12)
    empty = torch.ones(200_000, dtype=torch.bool, device=cuda)
    empty[seg.long()] = False
    assert bool((got[:, empty] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["gather", "contrib"])
def test_segment_sum_two_calls_give_the_same_bits(cuda, form):
    """No float atomics: float32 sums over a zipf stream with one hot
    segment spanning many blocks come out bit for bit the same."""
    rng = np.random.default_rng(23)
    vals, V, idx, seg, out0 = gather_inputs(rng, 3_000_000, 100_000, 50_000,
                                            3, torch.float32, cuda)
    seg[100_000:2_000_000] = seg[100_000]        # one run over most spans
    if form == "gather":
        calls = [segment_sum_gather(vals, V, idx, seg, 100_000,
                                    out=out0.clone()) for _ in range(2)]
    else:
        contrib = torch.randn((3, seg.numel()), device=cuda)
        calls = [segment_sum_sorted(contrib, seg, 100_000)
                 for _ in range(2)]
    assert torch.equal(calls[0], calls[1])


@pytest.mark.cuda
def test_segment_gather_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    vals = torch.ones(8, device=cuda)
    V = torch.ones((2, 5), device=cuda)
    idx = torch.zeros(8, dtype=torch.int32, device=cuda)
    seg = torch.zeros(8, dtype=torch.int32, device=cuda)
    out = torch.zeros((4, 2), device=cuda).t()
    with pytest.raises(ValueError, match="contiguous"):
        segment_sum_gather(vals, V, idx, seg, 4, out=out)
    with pytest.raises(ValueError, match="out must be"):
        segment_sum_gather(vals, V, idx, seg, 3, out=torch.zeros(
            (2, 4), device=cuda))
    with pytest.raises(TypeError, match="int32"):
        segment_sum_gather(vals, V, idx.long(), seg, 4)
    with pytest.raises(TypeError, match="dtype"):
        segment_sum_gather(vals.double(), V, idx, seg, 4)
    with pytest.raises(ValueError, match="one device"):
        segment_sum_gather(vals, V.cpu(), idx, seg, 4)


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

    keyed = item_rows(5, 40)
    cfg = ItemConfig(intercept_lambdas=[1.0], default_lambdas=[1.0, 10.0],
                     compute_var=True, full_cov=True, solver=solver,
                     liblinear_epsilon=1e-8, dtype=torch.float64)
    want = train_item_models(keyed, cfg, device="cpu")
    with recorded_loops() as loops:
        before = gram_batched.launches
        got = train_item_models(keyed, cfg, device=cuda)
        launches = gram_batched.launches - before
    trips = sum(s["newton_trips"] for s in got.solver_stats)
    expected = len(got.solver_stats) + (trips if solver == "cholesky" else 0)
    # K2's runs: the eager calls (the launches less the loops' warm-up
    # and captured ones) and the executions counted inside the loops
    assert launches - 2 * loops.captured("gram_batched") \
        + loops.executed("gram_batched") == expected
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
@pytest.mark.parametrize("solver", ["cholesky", "tron"])
def test_item_diagonal_variances_on_card_match_cpu(cuda, solver):
    """The diagonal posterior variances (compute_var without full_cov:
    1 / the Hessian diagonal, whose squared values K1 sums over the item
    problem's column-sorted copy on the card) and the models, card against
    CPU in float64: models to 1e-6 relative, variances to 1e-5, as the
    full-covariance test holds them; K1 runs inside every bucket's loop."""
    from mlease_tpu_torch.train.item import ItemConfig, train_item_models

    keyed = item_rows(6, 40)
    cfg = ItemConfig(intercept_lambdas=[1.0], default_lambdas=[1.0, 10.0],
                     compute_var=True, full_cov=False, solver=solver,
                     liblinear_epsilon=1e-8, dtype=torch.float64)
    want = train_item_models(keyed, cfg, device="cpu")
    with recorded_loops() as loops:
        got = train_item_models(keyed, cfg, device=cuda)
    assert len(loops) == len(got.solver_stats) > 1
    assert loops.executed("segment_sum_gather") > 0
    assert set(got.models) == set(want.models) == set(got.posterior_var)
    for key, m in want.models.items():
        g, pv, pw = got.models[key], got.posterior_var[key], \
            want.posterior_var[key]
        assert g.intercept == pytest.approx(m.intercept, rel=1e-6, abs=1e-8)
        assert pv.intercept == pytest.approx(pw.intercept, rel=1e-5)
        for name, v in m.coefficients.items():
            assert g.coefficients[name] == pytest.approx(v, rel=1e-6,
                                                         abs=1e-8)
            assert pv.coefficients[name] == pytest.approx(
                pw.coefficients[name], rel=1e-5)


class _Loops(list):
    """The device loops prepared inside `recorded_loops`."""

    def captured(self, kernel):
        """A kernel's launches the loops' captures recorded (as many as
        their warm-ups launched)."""
        return sum(b.get(kernel, 0) for lp in self
                   for b in lp.captured.values())

    def executed(self, kernel):
        """A kernel's executions inside the loops, counted on the card."""
        return sum(lp.counts()["kernel_executions"].get(kernel, 0)
                   for lp in self)


@contextlib.contextmanager
def recorded_loops():
    from mlease_tpu_torch.ops.device_loop import DeviceLoop
    loops, prepare = _Loops(), DeviceLoop.prepare

    def prepared(self):
        prepare(self)
        loops.append(self)
    DeviceLoop.prepare = prepared
    try:
        yield loops
    finally:
        DeviceLoop.prepare = prepare


def item_rows(seed, n_items=30):
    rng = np.random.default_rng(seed)
    return {f"it{i}": [{
        "response": int(rng.integers(0, 2)), "weight": 1.0, "offset": 0.0,
        "features": [(f"f{int(j)}", float(rng.normal()))
                     for j in rng.choice(9, 3, replace=False)]}
        for _ in range(int(rng.integers(20, 90)))] for i in range(n_items)}


@pytest.mark.cuda
@pytest.mark.parametrize("solver,full_cov", [("cholesky", True),
                                             ("cholesky", False),
                                             ("tron", False)])
def test_item_loop_reads_the_host_once_a_bucket(cuda, solver, full_cov):
    """A bucket's solve is one device loop: after a first call has built
    the kernels, a call's only synchronizing calls are its buckets' reads,
    one each; K1 runs inside every loop (the item problem's column-sorted
    copy), K2 inside the Cholesky route's."""
    from mlease_tpu_torch.train.item import ItemConfig, train_item_models
    keyed = item_rows(8)
    cfg = ItemConfig(intercept_lambdas=[1.0], default_lambdas=[1.0, 10.0],
                     compute_var=True, full_cov=full_cov, solver=solver)
    train_item_models(keyed, cfg, device=cuda)
    with recorded_loops() as loops:
        res, syncs = count_syncs(
            lambda: train_item_models(keyed, cfg, device=cuda))
    assert len(res.solver_stats) > 1
    assert syncs == len(res.solver_stats) == len(loops)
    assert all(lp.counts()["kernel_executions"]["segment_sum_gather"] > 0
               for lp in loops)
    assert (loops.executed("gram_batched") > 0) == (solver == "cholesky")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("solver", ["cholesky", "tron"])
def test_item_runs_give_the_same_bits(cuda, monkeypatch, solver, dtype):
    """Two runs of the same buckets give the same bits (X'v and the
    Hessian diagonal sum with K1 in one fixed order, not with atomics), and
    so does the host-driven solve through the trainer's seam: models,
    posterior variances (diagonal, and from the full covariance in
    float32) and trips."""
    from mlease_tpu_torch.train import item
    from torch_host_solves import host_bucket
    keyed = item_rows(9, 60)
    cfg = item.ItemConfig(intercept_lambdas=[1.0, 3.0],
                          default_lambdas=[1.0, 10.0], compute_var=True,
                          full_cov=dtype == torch.float32, solver=solver,
                          dtype=dtype)

    def flat(res):
        return [(k, m.intercept, sorted(m.coefficients.items()),
                 res.posterior_var[k].intercept,
                 sorted(res.posterior_var[k].coefficients.items()))
                for k, m in sorted(res.models.items())]

    def trips(res):
        return [(s["newton_trips"], s.get("cg_trips"))
                for s in res.solver_stats]

    runs = [item.train_item_models(keyed, cfg, device=cuda)
            for _ in range(2)]
    monkeypatch.setattr(item, "_solve_bucket", host_bucket)
    runs.append(item.train_item_models(keyed, cfg, device=cuda))
    assert flat(runs[0]) == flat(runs[1]) == flat(runs[2])
    assert trips(runs[0]) == trips(runs[1]) == trips(runs[2])
    if cfg.full_cov:
        assert runs[0].covariances == runs[1].covariances \
            == runs[2].covariances


@pytest.mark.cuda
@pytest.mark.parametrize("F", [16, 64])
def test_batched_cholesky_and_triangular_solves_capture(cuda, F):
    """The Newton step's factor and solves at the item loop's shapes
    (B 20,000): torch.linalg.cholesky_ex and two solve_triangular calls
    captured in a CUDA graph give the eager calls' bits on replay, on
    inputs written after the capture."""
    g = torch.Generator(device=cuda)
    g.manual_seed(F)
    B = 20_000
    A = torch.randn((B, 2 * F, F), generator=g, device=cuda)
    H = A.mT @ A + torch.eye(F, device=cuda)
    rhs = torch.randn((B, F, 1), generator=g, device=cuda)

    def solve():
        L, info = torch.linalg.cholesky_ex(H)
        y = torch.linalg.solve_triangular(L, rhs, upper=False)
        return torch.linalg.solve_triangular(L.mT, y, upper=True), info
    want, info = solve()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got, ginfo = solve()
    # the replay reads the new inputs: 4H and 4rhs give the factor 2L and
    # the same solution, each op scaled by a power of two (exact)
    H.mul_(4.0)
    rhs.mul_(4.0)
    graph.replay()
    torch.cuda.synchronize()
    assert int(info.abs().max()) == int(ginfo.abs().max()) == 0
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert bool(torch.isfinite(got).all())


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
        # X'v sums the ELL over its column-sorted copy with K1 on the card
        return tm.with_column_copy(tm.MultiProblem(
            indices=t(idx), values=t(vals), y=t(y), weight=t(np.ones(R)),
            offset=t(np.zeros(R)), prior_mean=t(np.zeros((n, 2))),
            prior_var_inv=t(np.tile([1.0, 10.0], (n, 1))), head_x=t(head_x),
            head_ids=t(np.arange(H))))

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


# ---------------------------------------------------------------------------
# The per-block solves: K1 inside them, K2 building each block's head Gram
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(flat_blocks=False),
                                dict(pcg="head_block"),
                                dict(multi_rhs=False)],
                         ids=["per_block", "head_block", "lanes"])
def test_solver_modes_on_card_match_cpu(cuda, kw):
    """AdmmTrainer's per-block, head-block and lanes solves on the card
    against the same float64 runs on the CPU: z to 1e-8. K1 launches in
    every solve (the lanes solve's sorted sums are K1 on the card); with
    head_block K2 builds each block's head Gram, B calls per build, one
    build per Newton trip plus one per solve. The per-block solves reduce
    in a fixed order on both (the head product, K1), so their trip counts
    are equal too. The lanes solve sums its sorted streams with K1 on the
    card and with scatter_add_ on the CPU, in another order, so a CG stop
    decision within rounding of its threshold can go either way: it solves
    to liblinear.epsilon 1e-10 here, where both reach the same minimizer."""
    from mlease_tpu_torch.core.vocab import FeatureVocab
    from mlease_tpu_torch.train.admm import AdmmConfig, AdmmTrainer

    data = blocked_data(12, B=3, R=1500)
    vocab = FeatureVocab.from_names(f"f{i}" for i in range(3000))
    lanes = "multi_rhs" in kw
    cfg = AdmmConfig(lambdas=[1.0, 10.0, 100.0], num_iters=2, head_size=64,
                     dtype=torch.float64,
                     liblinear_epsilon=1e-10 if lanes else 0.01, **kw)
    want = AdmmTrainer(data, vocab, cfg, device="cpu").run()
    tr = AdmmTrainer(data, vocab, cfg, device=cuda)
    got = tr.run()                       # makes and captures its solve loop
    np.testing.assert_allclose(got.z, want.z, rtol=0, atol=1e-8)
    assert lanes or got.solver_stats == want.solver_stats
    # the kernels' runs in a second run, the loop's set-up done: the
    # wrappers' eager launches plus the executions counted on the card
    loop = tr._loops["x"].loop
    k1, k2 = segment_sum_sorted.launches, gram_batched.launches
    ex = loop.counts()["kernel_executions"]
    again = tr.run()
    ex = {k: n - ex[k] for k, n in loop.counts()["kernel_executions"].items()}
    k1 = segment_sum_sorted.launches - k1 + ex["segment_sum_gather"]
    k2 = gram_batched.launches - k2 + ex["gram_batched"]
    assert again.solver_stats == got.solver_stats
    assert k1 > 0 and ex["segment_sum_gather"] > 0
    builds = sum(s["newton_trips"] + 1 for s in got.solver_stats)
    assert k2 == (3 * builds if kw.get("pcg") == "head_block" else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dtype", [torch.float32, torch.bfloat16])
def test_per_block_head_gram_matches_reference(cuda, monkeypatch,
                                               head_dtype):
    """Every head Gram that a per-block head-block solve builds on the card
    (one K2 call per block, the head shared by the L lanes; a bfloat16 head
    through K2's bf16-in route) against gram_batched_reference on the same
    inputs, at K2's tolerance; and the solve itself against the CPU's."""
    import mlease_tpu_torch.ops.tron_multi as tm
    from mlease_tpu_torch.core.dataset import to_hybrid

    data = to_hybrid(blocked_data(13, B=3, R=1200), 32,
                     head_dtype=head_dtype)
    B, n, L = data.nblocks, data.dim, 2

    def problem(dev):
        t = lambda a, dt=None: torch.as_tensor(a, device=dev, dtype=dt)  # noqa
        f32 = torch.float32
        head = (t(data.head, head_dtype), t(data.head_ids),
                t(data.tail_rows), t(data.tail_cols),
                t(data.tail_vals, f32), t(data.tail_c_rows),
                t(data.tail_c_cols), t(data.tail_c_vals, f32))
        return tm.stack_blocks(
            t(data.indices), t(data.values, f32), t(data.y, f32),
            t(data.weight, f32), t(data.offset, f32), head,
            torch.zeros((L, B, n), dtype=f32, device=dev),
            t([1.0, 10.0], f32))

    calls = []
    real = tm.gram_batched

    def checked(x, d, pvi=None):
        calls.append(x.shape)
        return check_gram(x, d, pvi, 1e-5)

    W0 = torch.zeros((B * n, L))
    eps = torch.full((B,), 1e-4)
    want = tm.tron_multi(problem("cpu"), W0, eps, precondition="head_block",
                         blocks=B)
    monkeypatch.setattr(tm, "gram_batched", checked)
    got = tm.tron_multi(problem(cuda), W0.to(cuda), eps.to(cuda),
                        precondition="head_block", blocks=B)
    monkeypatch.setattr(tm, "gram_batched", real)
    assert len(calls) == B * (got.newton_trips + 1)
    assert set(calls) == {(1200, 32)}
    scale = float(want.w.abs().max())
    assert float((got.w.cpu() - want.w).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_lanes_minor_passes_on_card_match_cpu(cuda):
    """The public lanes-minor passes of ops/tron_multi.py on the card (K1
    on lanes-minor views of V and D) against the same float64 calls on the
    CPU, on a stacked problem with a (B, Rb, H) head and both sorted tails:
    every output to 1e-12 * max|out|, and K1 launched as often as each
    function reduces a sorted tail."""
    import mlease_tpu_torch.ops.tron_multi as tm
    from mlease_tpu_torch.core.dataset import to_hybrid

    data = to_hybrid(blocked_data(14, B=3, R=1000), 32)
    B, n, L = data.nblocks, data.dim, 3
    rng = np.random.default_rng(14)
    pm = rng.normal(size=(L, B, n)) * 0.05
    W, S = rng.normal(size=(B * n, L)) * 0.3, rng.normal(size=(B * n, L))
    C, Dm = rng.normal(size=(B * 1000, L)), rng.random(size=(B * 1000, L))

    def problem(dev):
        t = lambda a, dt=torch.float64: torch.as_tensor(  # noqa: E731
            np.asarray(a), device=dev, dtype=dt)
        ids = [t(getattr(data, k), None) for k in (
            "head_ids", "tail_rows", "tail_cols")]
        head = (t(data.head), *ids, t(data.tail_vals),
                t(data.tail_c_rows, None), t(data.tail_c_cols, None),
                t(data.tail_c_vals))
        return tm.stack_blocks(
            t(data.indices, None), t(data.values), t(data.y), t(data.weight),
            t(data.offset), head, t(pm), t([0.5, 2.0, 8.0])), t

    calls = {"xv": (1, "W"), "xtv": (1, "Dm"), "scores": (1, "W"),
             "fun": (1, "W"), "grad_and_curvature": (2, "W"),
             "xtv_and_sqdiag": (1, "C", "Dm"),
             "fun_grad_curvature": (2, "W"), "grad_norm_at_zero": (1,),
             "hv": (2, "Dm", "S"), "hessian_diagonal": (1, "Dm")}
    x = {"W": W, "S": S, "C": C, "Dm": Dm}
    (cpu, tc), (dev, td) = problem("cpu"), problem(cuda)
    for name, (k1, *args) in calls.items():
        extra = (L,) if name == "grad_norm_at_zero" else ()
        want = getattr(tm, name)(cpu, *[tc(x[a]) for a in args], *extra)
        before = segment_sum_sorted.launches
        got = getattr(tm, name)(dev, *[td(x[a]) for a in args], *extra)
        assert segment_sum_sorted.launches - before == k1, name
        if not isinstance(want, tuple):
            want, got = (want,), (got,)
        for g, w in zip(got, want):
            assert g.device.type == "cuda" and g.shape == w.shape
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=0,
                                       atol=1e-12 * float(w.abs().max()))


# ---------------------------------------------------------------------------
# run_fused: the driver loop as a CUDA graph that loops on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(pcg=True), dict(flat_blocks=False),
                                dict(pcg="head_block")],
                         ids=["flat", "per_block", "head_block"])
def test_run_fused_on_card_equals_run(cuda, kw):
    """AdmmTrainer.run_fused on the card gives run()'s z, u, diffs and
    trip totals bit for bit, in one chunk and in chunks of 2; K1 (and K2
    with head_block) execute inside the loop's graphs; and a chunk runs
    clean under torch.cuda.set_sync_debug_mode("error"): no host read or
    wait between its launch and the chunk end."""
    from mlease_tpu_torch.core.vocab import FeatureVocab
    from mlease_tpu_torch.ops.device_loop import DeviceLoop
    from mlease_tpu_torch.train.admm import AdmmConfig, AdmmTrainer

    data = blocked_data(13, B=3, R=1500)
    vocab = FeatureVocab.from_names(f"f{i}" for i in range(3000))
    cfg = AdmmConfig(lambdas=[1.0, 10.0, 100.0], num_iters=4, head_size=64,
                     dtype=torch.float32, test_loglik_per_iter=False, **kw)
    trainer = AdmmTrainer(data, vocab, cfg, device=cuda)
    run = trainer.run()
    one = trainer.run_fused()
    counts = one.loop_counts
    np.testing.assert_array_equal(one.z, run.z)
    np.testing.assert_array_equal(one.u, run.u)
    assert one.diff_history == run.diff_history
    assert one.iterations == run.iterations
    assert one.solver_stats == [{k: sum(s[k] for s in run.solver_stats)
                                 for k in ("newton_trips", "cg_trips")}]
    # K1 and K2 executions as counted on the card, and as captured
    # launches times branch executions: the same
    ke, runs = counts["kernel_executions"], counts["branch_executions"]
    assert ke == {c: sum(n[c] * runs[b] for b, n in
                         counts["captured_launches"].items()) for c in ke}
    assert ke["segment_sum_gather"] > 0
    assert (ke["gram_batched"] > 0) == (kw.get("pcg") == "head_block")
    # one execution of the CG branch per lock-step trip: the flat solve's
    # count; a per-block solve's trips are each block's, maxed
    cg_runs = runs["cg_trip"]
    assert (cg_runs == one.solver_stats[0]["cg_trips"]
            if trainer.mode == "flat"
            else cg_runs >= one.solver_stats[0]["cg_trips"])

    launch = DeviceLoop.run

    def checked(self):
        torch.cuda.set_sync_debug_mode("error")
        try:
            launch(self)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    calls = []
    DeviceLoop.run = checked
    try:
        chunked = trainer.run_fused(
            checkpoint_every=2, callback=lambda **kw: calls.append(kw))
    finally:
        DeviceLoop.run = launch
    np.testing.assert_array_equal(chunked.z, run.z)
    assert [c["iteration"] for c in calls] == [2, 4]


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(multi_rhs=False),
                                dict(dual_layout=True, head_size=0)],
                         ids=["multi_rhs=False", "dual_layout"])
def test_lanes_run_fused_on_card_equals_run(cuda, kw):
    """run_fused of the lanes solve (ops/tron.py's LaneSolver in the loop's
    graphs) gives run()'s z, u, diffs and trip totals bit for bit on the
    card, and a chunk runs clean under set_sync_debug_mode("error")."""
    from mlease_tpu_torch.core.vocab import FeatureVocab
    from mlease_tpu_torch.ops.device_loop import DeviceLoop
    from mlease_tpu_torch.train.admm import AdmmConfig, AdmmTrainer

    data = blocked_data(17, B=3, R=1500)
    vocab = FeatureVocab.from_names(f"f{i}" for i in range(3000))
    cfg = AdmmConfig(**dict(dict(lambdas=[1.0, 10.0], num_iters=3,
                                 head_size=64, dtype=torch.float32), **kw))
    trainer = AdmmTrainer(data, vocab, cfg, device=cuda)
    assert trainer.mode == "lanes"
    run = trainer.run()
    launch = DeviceLoop.run

    def checked(self):
        torch.cuda.set_sync_debug_mode("error")
        try:
            launch(self)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    DeviceLoop.run = checked
    try:
        got = trainer.run_fused()
    finally:
        DeviceLoop.run = launch
    np.testing.assert_array_equal(got.z, run.z)
    np.testing.assert_array_equal(got.u, run.u)
    assert got.diff_history == run.diff_history
    assert got.solver_stats == [{k: sum(s[k] for s in run.solver_stats)
                                 for k in ("newton_trips", "cg_trips")}]


@pytest.fixture
def one_rank(cuda, tmp_path, request):
    """A one-rank process group on the card, of the backend asked for."""
    import torch.distributed as dist
    from mlease_tpu_torch.parallel import distributed
    distributed.initialize(cuda, init_method=f"file://{tmp_path}/pg",
                           world_size=1, rank=0, backend=request.param)
    yield request.param
    dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("one_rank", ["nccl"], indirect=True)
@pytest.mark.parametrize("kw", [dict(flat_blocks=False),
                                dict(pcg="head_block")],
                         ids=["per_block", "head_block"])
def test_one_rank_nccl_mesh_run_fused_equals_run(one_rank, kw):
    """run_fused on a one-rank NCCL mesh: its all_reduces captured into the
    loop's graphs ("thread_local" capture), run()'s bits, and the
    collectives executed on the card as many as run()'s step calls (two an
    iteration), beside K1 (and K2 with head_block)."""
    import torch.distributed as dist
    from mlease_tpu_torch import collectives
    from mlease_tpu_torch.core.vocab import FeatureVocab
    from mlease_tpu_torch.parallel import make_mesh
    from mlease_tpu_torch.train.admm import AdmmConfig, AdmmTrainer

    assert dist.get_backend() == "nccl"
    mesh = make_mesh(1, "cuda")
    data = blocked_data(19, B=3, R=1500)
    vocab = FeatureVocab.from_names(f"f{i}" for i in range(3000))
    cfg = AdmmConfig(lambdas=[1.0, 10.0], num_iters=3, head_size=64,
                     dtype=torch.float32, **kw)
    trainer = AdmmTrainer(data, vocab, cfg, mesh=mesh)
    run = trainer.run()
    got = trainer.run_fused()
    np.testing.assert_array_equal(got.z, run.z)
    np.testing.assert_array_equal(got.u, run.u)
    assert got.solver_stats == [{k: sum(s[k] for s in run.solver_stats)
                                 for k in ("newton_trips", "cg_trips")}]
    counts = got.loop_counts
    ke = counts["kernel_executions"]
    assert ke["all_reduce"] == 2 * run.iterations
    assert counts["capture_modes"]["iteration_end"] == "thread_local"
    assert counts["capture_modes"]["cg_trip"] == "global"
    assert ke["segment_sum_gather"] > 0
    assert (ke["gram_batched"] > 0) == (kw.get("pcg") == "head_block")
    assert collectives.all_reduce.device_launches is None


@pytest.mark.cuda
@pytest.mark.parametrize("one_rank", ["gloo"], indirect=True)
def test_run_fused_under_gloo_on_the_card_raises(one_rank):
    """A gloo group cannot be captured: run_fused on a CUDA device under
    one raises ValueError naming the backend (run() runs)."""
    from mlease_tpu_torch.core.vocab import FeatureVocab
    from mlease_tpu_torch.parallel.mesh import make_mesh
    from mlease_tpu_torch.train.admm import AdmmConfig, AdmmTrainer

    mesh = make_mesh(1, "cuda")
    data = blocked_data(19, B=2, R=500)
    vocab = FeatureVocab.from_names(f"f{i}" for i in range(3000))
    trainer = AdmmTrainer(data, vocab, AdmmConfig(
        num_iters=1, flat_blocks=False, dtype=torch.float32), mesh=mesh)
    with pytest.raises(ValueError, match="gloo"):
        trainer.run_fused()
    assert np.isfinite(trainer.run().z).all()


@pytest.mark.cuda
def test_device_loop_refuses_a_node_a_conditional_body_cannot_hold(cuda):
    """A branch whose capture leaves a node that a conditional body cannot
    hold (an external event's record: an event_record node) makes
    DeviceLoop.prepare raise, naming the branch and the node type; nothing
    runs in the loop's stead (the warm-up's writes are put back, and run
    refuses)."""
    from mlease_tpu_torch.ops.device_loop import DeviceLoop

    phase = torch.ones((), dtype=torch.int32, device=cuda)
    x = torch.zeros(4, device=cuda)
    ev = torch.cuda.Event(external=True)

    def step():
        x.add_(1.0)
        ev.record()
        phase.fill_(0)

    loop = DeviceLoop([(1, "recorder", step)], phase, [x])
    with pytest.raises(RuntimeError, match=r"'recorder' holds a "
                       r"event_record node"):
        loop.prepare()
    assert loop.node_types["recorder"].get("event_record", 0) >= 1
    with pytest.raises(RuntimeError, match="before prepare"):
        loop.run()
    torch.cuda.synchronize(cuda)
    assert float(x.sum()) == 0.0 and int(phase) == 1
    loop.close()


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(pcg=True), dict(pcg="head_block")],
                         ids=["per_block", "head_block"])
def test_substacked_run_fused_on_card_equals_run(cuda, monkeypatch, kw):
    """Past the int32 bound (lowered here so that 3 blocks solve as
    sub-stacks of 2 and 1) run_fused loops over each sub-stack's branches
    in turn and gives run()'s bits; K1 runs inside the graphs."""
    from mlease_tpu_torch.core.vocab import FeatureVocab
    from mlease_tpu_torch.ops import tron_multi
    from mlease_tpu_torch.train.admm import AdmmConfig, AdmmTrainer

    data = blocked_data(23, B=3, R=1500)
    monkeypatch.setattr(tron_multi, "STACK_ID_BOUND",
                        2 * max(data.dim, 1500) + 1)
    vocab = FeatureVocab.from_names(f"f{i}" for i in range(3000))
    cfg = AdmmConfig(lambdas=[1.0, 10.0], num_iters=3, head_size=64,
                     dtype=torch.float32, **kw)
    trainer = AdmmTrainer(data, vocab, cfg, device=cuda)
    assert trainer.mode == "per_block"
    assert trainer.prob.ranges == ((0, 2), (2, 3))
    run = trainer.run()
    got = trainer.run_fused()
    np.testing.assert_array_equal(got.z, run.z)
    np.testing.assert_array_equal(got.u, run.u)
    assert got.solver_stats == [{k: sum(s[k] for s in run.solver_stats)
                                 for k in ("newton_trips", "cg_trips")}]
    assert got.loop_counts["kernel_executions"]["segment_sum_gather"] > 0
    assert got.loop_counts["branch_executions"]["cg_trip.1"] > 0


# ---------------------------------------------------------------------------
# run() and the streaming trainer: each x-update one device loop
# (train/admm.py::_SolveLoop), one host sync an iteration
# ---------------------------------------------------------------------------

def count_syncs(fn):
    """fn() under set_sync_debug_mode("warn"): its result and the number
    of synchronizing calls it made."""
    import warnings
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("called a synchronizing" in str(w.message)
                    for w in seen)


def syncs_per_iteration(run):
    """run(callback) under set_sync_debug_mode("warn"): the synchronizing
    calls between consecutive callbacks (one an iteration, the first
    iteration's, which holds the run's set-up, left out)."""
    import warnings
    marks = []
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run(lambda **_kw: marks.append(len(seen)))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sync = [i for i, w in enumerate(seen) if "synchroniz" in str(w.message)]
    return [sum(lo <= i < hi for i in sync)
            for lo, hi in zip(marks[:-1], marks[1:])]


@pytest.mark.cuda
def test_run_and_a_streamed_run_sync_once_an_iteration(cuda):
    """After the first run has captured the loops, an iteration of run()
    and of a 2-group streamed run (nothing resident, the compact wire)
    reads the host once, and K1 executes inside the loops' graphs."""
    from mlease_tpu_torch.core.dataset import split_blocks
    from mlease_tpu_torch.core.vocab import FeatureVocab
    from mlease_tpu_torch.train.admm import AdmmConfig, AdmmTrainer
    from mlease_tpu_torch.train.streaming import StreamingAdmmTrainer

    data = blocked_data(29, B=4, R=1500)
    vocab = FeatureVocab.from_names(f"f{i}" for i in range(3000))
    cfg = AdmmConfig(lambdas=[1.0, 10.0], num_iters=4, head_size=64,
                     dtype=torch.float32, epsilon=0.0)
    tr = AdmmTrainer(data, vocab, cfg, device=cuda)
    st = StreamingAdmmTrainer(split_blocks(data, 2), vocab, cfg,
                              resident_head=False, compact_wire=True,
                              device=cuda)
    assert st.residency_report()["compact_wire_groups"] == 2
    for trainer in (tr, st):
        first = trainer.run()
        assert first.iterations == 4
        assert syncs_per_iteration(
            lambda cb: trainer.run(callback=cb)) == [1, 1, 1]
        assert all(lp.loop.counts()["kernel_executions"][
            "segment_sum_gather"] > 0 for lp in trainer._loops.values())


@pytest.mark.cuda
def test_a_slot_is_not_overwritten_while_a_loop_reads_it(cuda):
    """Three streamed groups in two slots: the third group's copy goes
    into the first group's slot while the first group's (large, so slow)
    solve may still run on the card, and must wait for it. The first
    group's x and trips equal build_group_solver's on the same inputs and
    a fresh copy of its data, and the run equals an all-resident one bit
    for bit."""
    from mlease_tpu_torch.core.vocab import FeatureVocab
    from mlease_tpu_torch.train.admm import AdmmConfig
    from mlease_tpu_torch.train.streaming import (StreamingAdmmTrainer,
                                                  build_group_solver)

    groups = [blocked_data(31, B=2, R=20000), blocked_data(32, B=1, R=500),
              blocked_data(33, B=1, R=500)]
    vocab = FeatureVocab.from_names(f"f{i}" for i in range(3000))
    cfg = AdmmConfig(lambdas=[1.0, 10.0], num_iters=3, head_size=64,
                     dtype=torch.float32)
    tr = StreamingAdmmTrainer(groups, vocab, cfg, resident_head=False,
                              device=cuda)
    assert tr._slot_of == {0: 0, 1: 1, 2: 0}
    solve, kept = tr._solve_group, []

    def keep(gi, prob, present, z, u, rho_eff, eps, perm):
        x, trips = solve(gi, prob, present, z, u, rho_eff, eps, perm)
        if gi == 0:
            kept.append((x.clone(), trips.clone(), z.clone(), u.clone(),
                         rho_eff.clone(), eps.clone()))
        return x, trips
    tr._solve_group = keep
    got = tr.run()
    del tr._solve_group
    prob, present, perm = tr._ship(
        0, lambda f, shape, dt: torch.empty(shape, dtype=dt, device=cuda))
    host = build_group_solver(cfg.max_newton_iter, cfg.max_cg_iter,
                              mode=tr.mode, pcg=cfg.pcg)
    for x, trips, z, u, rho_eff, eps in kept:
        xh, nt, cg = host(prob, present, z, u, rho_eff, eps, perm)
        assert torch.equal(x, xh)
        assert trips.tolist() == [nt, cg]
    want = StreamingAdmmTrainer(groups, vocab, cfg, resident_head=True,
                                device=cuda).run()
    np.testing.assert_array_equal(got.z, want.z)
    np.testing.assert_array_equal(got.u, want.u)


# ---------------------------------------------------------------------------
# X'v over the ELL on K1, and the feature-sharded trainer's device loop
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_headless_per_block_x_update_gives_the_same_bits(cuda):
    """A head-less per-block x-update (X'v summed over the ELL's
    column-sorted copy with K1) on the trainer's device loop, twice from
    the same inputs, and through the host-driven build_x_update solve:
    the same bits and trips every time, K1 executed inside the loop; two
    run() calls of fresh trainers alike."""
    from mlease_tpu_torch.core.vocab import FeatureVocab
    from mlease_tpu_torch.train.admm import (AdmmConfig, AdmmTrainer,
                                             build_x_update, x_prior)

    data = blocked_data(41, B=3, R=4000)
    vocab = FeatureVocab.from_names(f"f{i}" for i in range(3000))
    cfg = AdmmConfig(lambdas=[1.0, 10.0, 100.0], num_iters=3,
                     flat_blocks=False, dtype=torch.float32)
    tr = AdmmTrainer(data, vocab, cfg, device=cuda)
    assert tr.mode == "per_block" and tr.prob.csc_cols is not None
    gen = torch.Generator(device=cuda).manual_seed(41)
    L, n, B = 3, tr.dim, data.nblocks
    z = 0.01 * torch.randn((L, n), generator=gen, device=cuda)
    u = 0.01 * torch.randn((L, B, n), generator=gen, device=cuda)
    rho = torch.as_tensor(tr.rhos, device=cuda)
    eps = cfg.liblinear_epsilon * tr.eps_scale
    solve = build_x_update(tr.mode, cfg.max_newton_iter, cfg.max_cg_iter,
                           cfg.pcg)
    xh, th = solve(tr.prob, tr.present, z, u, rho, eps)
    loop = tr._solve_loop(z, u, rho, eps)
    loop.own_loop().prepare()
    try:
        for _ in range(2):
            loop.solve(z, u, rho, eps)
            x = solve.finish(loop.x(), tr.present, x_prior(z, u), z)
            assert torch.equal(x, xh)
            np.testing.assert_array_equal(loop.trips().cpu().numpy(), th)
        assert loop.loop.counts()["kernel_executions"][
            "segment_sum_gather"] > 0
    finally:
        loop.close()
    a = AdmmTrainer(data, vocab, cfg, device=cuda).run()
    b = AdmmTrainer(data, vocab, cfg, device=cuda).run()
    np.testing.assert_array_equal(a.z, b.z)
    np.testing.assert_array_equal(a.u, b.u)
    assert a.solver_stats == b.solver_stats


def fs_rows(seed, n_rows, n_feat=400):
    """Rows as the port's pack_rows reads them (the CPU tests take them
    from tests/test_admm.py::synth_rows, which needs JAX)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=n_feat)
    rows = []
    for _ in range(n_rows):
        js = rng.choice(n_feat, size=int(rng.integers(2, 12)),
                        replace=False)
        vals = rng.normal(size=js.size)
        p = 1.0 / (1.0 + np.exp(-(w[js] @ vals - 0.2)))
        rows.append({"response": int(rng.random() < p),
                     "features": [(f"f{j}", float(v))
                                  for j, v in zip(js, vals)],
                     "weight": 1.0, "offset": 0.0})
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("one_rank", ["nccl"], indirect=True)
def test_one_rank_nccl_feature_sharded_loop_equals_its_seam(one_rank):
    """FeatureShardedAdmmTrainer on a one-rank NCCL 1 x 1 mesh: run() on
    its device loop (one feat shard: the solve sums nothing over the
    group, so no collective is captured) against run() with the seam on
    the host-driven solve, bit for bit with equal trips; a second run() on
    the kept loop alike, reading the host once an iteration; K1 executed
    inside the loop."""
    import warnings
    from mlease_tpu_torch.core import build_vocab, pack_blocks
    from mlease_tpu_torch.parallel.mesh import make_mesh_2d
    from mlease_tpu_torch.train.admm import AdmmConfig
    from mlease_tpu_torch.train.feature_sharded import \
        FeatureShardedAdmmTrainer

    rows = fs_rows(43, 6000)
    blocks = [rows[i::3] for i in range(3)]
    vocab = build_vocab(rows)
    cfg = AdmmConfig(lambdas=[1.0, 10.0, 100.0], num_iters=3,
                     flat_blocks=False, dtype=torch.float32, epsilon=0.0)
    tr = FeatureShardedAdmmTrainer(pack_blocks(blocks, vocab), vocab, cfg,
                                   mesh=make_mesh_2d(1, 1, "cuda"))
    got = tr.run()
    loop = tr._loops["x"].loop
    counts = loop.counts()
    assert counts["kernel_executions"]["segment_sum_gather"] > 0
    assert counts["capture_modes"]["cg_trip"] == "global"
    assert "all_reduce" not in counts["kernel_executions"]

    marks, x_update = [], tr._x_update
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")

        def marked(*a):
            marks.append(len(seen))
            return x_update(*a)
        tr._x_update = marked
        torch.cuda.set_sync_debug_mode("warn")
        try:
            again = tr.run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sync = [i for i, w in enumerate(seen) if "synchroniz" in str(w.message)]
    assert [sum(lo <= i < hi for i in sync)
            for lo, hi in zip(marks[:-1], marks[1:])] == [1, 1]
    tr._x_update = tr._host_x_update
    host = tr.run()
    del tr._x_update
    for res in (again, host):
        np.testing.assert_array_equal(res.z, got.z)
        np.testing.assert_array_equal(res.u, got.u)
        assert res.solver_stats == got.solver_stats


@pytest.mark.cuda
def test_feature_sharded_run_on_a_gloo_group_of_two_raises(cuda, tmp_path):
    """On the card a gloo feat group of 2 ranks cannot be captured: run()
    raises ValueError naming NCCL before any loop is made, and run() with
    the seam on the host-driven solve runs (2 ranks on the one card,
    through tests/torch_mesh_worker.py, with a deadline)."""
    from torch_mesh_worker import launch

    rows = fs_rows(44, 900)
    got = launch([("g", "fs_gloo_cuda", dict(
        blocks=[rows[i::3] for i in range(3)], grid=(1, 2),
        config=dict(lambdas=[1.0, 10.0], num_iters=2, flat_blocks=False,
                    dtype="float32")))], 2, tmp_path, timeout=240,
        device="cuda")["g"]
    for r in got:
        assert r["error"] is not None and "NCCL" in r["error"]
        assert r["loops_made"] == 0
        assert r["z_finite"] and r["iterations"] == 2


# ---------------------------------------------------------------------------
# the streamed lanes solve and consensus on the host, on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("head", [64, 0], ids=["head", "head-less"])
def test_a_streamed_lanes_group_refreshed_through_one_slot(cuda, monkeypatch,
                                                           head):
    """The lanes solve (multi_rhs=False) over three streamed groups in two
    slots (groups 0 and 2 share slot 0): each group's problem is unstacked
    anew after every copy into its slot and written into its loop's
    tensors (train/streaming.py::_refresh), twice a group in 3
    iterations. With a head, the run gives the bits of the run with every
    group resident (no slot, no refresh). Without one (no residency tier
    exists without a head), each group ships its column order and every
    group solve equals build_group_solver's on the same inputs, bit for
    bit with equal trips; K1 runs inside the loops' graphs."""
    import mlease_tpu_torch.train.streaming as streaming
    from mlease_tpu_torch.core.vocab import FeatureVocab
    from mlease_tpu_torch.train.admm import AdmmConfig
    from mlease_tpu_torch.train.streaming import (StreamingAdmmTrainer,
                                                  build_group_solver)

    groups = [blocked_data(51, B=2, R=1500), blocked_data(52, B=1, R=1500),
              blocked_data(53, B=2, R=1500)]
    vocab = FeatureVocab.from_names(f"f{i}" for i in range(3000))
    cfg = AdmmConfig(lambdas=[1.0, 10.0], num_iters=3, head_size=head,
                     multi_rhs=False, dtype=torch.float32, epsilon=0.0)
    tr = StreamingAdmmTrainer(groups, vocab, cfg, resident_head=False,
                              device=cuda)
    assert tr.mode == "lanes" and tr._slot_of == {0: 0, 1: 1, 2: 0}
    assert all((p is not None) == (head == 0) for p in tr.csc_perms)
    refreshed = []
    refresh = streaming._refresh

    def counted(parts, probs):
        refreshed.append(len(parts))
        refresh(parts, probs)
    monkeypatch.setattr(streaming, "_refresh", counted)
    host = build_group_solver(cfg.max_newton_iter, cfg.max_cg_iter,
                              mode="lanes", pcg=cfg.pcg)
    solve, seen = tr._solve_group, []

    def check(gi, prob, present, z, u, rho_eff, eps, perm):
        x, trips = solve(gi, prob, present, z, u, rho_eff, eps, perm)
        xh, nt, cg = host(prob, present, z, u, rho_eff, eps, perm)
        seen.append(bool(torch.equal(x, xh)) and trips.tolist() == [nt, cg])
        return x, trips
    tr._solve_group = check
    got = tr.run()
    del tr._solve_group
    assert got.iterations == 3 and len(refreshed) == 3 * 2
    assert len(seen) == 9 and all(seen)
    assert all(lp.loop.counts()["kernel_executions"][
        "segment_sum_gather"] > 0 for lp in tr._loops.values())
    if head:
        want = StreamingAdmmTrainer(groups, vocab, cfg, resident_head=True,
                                    device=cuda)
        assert want._slot_of == {}
        ref = want.run()
        np.testing.assert_array_equal(got.z, ref.z)
        np.testing.assert_array_equal(got.u, ref.u)
        assert got.solver_stats == ref.solver_stats


@pytest.mark.cuda
def test_a_host_u_slot_is_not_overwritten_before_its_last_reader(cuda):
    """Consensus on the host (u in page-locked memory, shipped in each
    group's slot): three streamed groups in two slots, the compute stream
    held back by a sleep kernel at the start of every group solve, so
    that group 2's copy into slot 0 (its u and its data) is issued while
    group 0's solve, and the partial sum that reads its u last, are still
    queued. The copy waits on the event recorded after that last reader:
    the run equals the one with device-resident consensus and every group
    resident, bit for bit."""
    from mlease_tpu_torch.core.vocab import FeatureVocab
    from mlease_tpu_torch.train.admm import AdmmConfig
    from mlease_tpu_torch.train.streaming import StreamingAdmmTrainer

    groups = [blocked_data(54, B=2, R=1500), blocked_data(55, B=1, R=1500),
              blocked_data(56, B=2, R=1500)]
    vocab = FeatureVocab.from_names(f"f{i}" for i in range(3000))
    cfg = AdmmConfig(lambdas=[1.0, 10.0], num_iters=3, head_size=64,
                     dtype=torch.float32, epsilon=0.0)
    tr = StreamingAdmmTrainer(groups, vocab, cfg, resident_head=False,
                              consensus_device=False, device=cuda)
    assert tr.residency_report()["consensus_device"] is False
    assert tr._slot_of == {0: 0, 1: 1, 2: 0}
    solve = tr._solve_group

    def slow(gi, *a):
        torch.cuda._sleep(20_000_000)          # about 10 ms on the card
        return solve(gi, *a)
    tr._solve_group = slow
    got = tr.run()
    del tr._solve_group
    want = StreamingAdmmTrainer(groups, vocab, cfg, resident_head=True,
                                device=cuda).run()
    np.testing.assert_array_equal(got.z, want.z)
    np.testing.assert_array_equal(got.u, want.u)
    assert got.solver_stats == want.solver_stats


@pytest.mark.cuda
def test_locked_copies_are_page_locked_exact_and_freed(cuda, monkeypatch):
    """train/streaming.py::_locked_copy: the streaming trainer's kept host
    arrays are page-locked copies in pages of their own size (torch's
    caching host allocator would round a 1.6 GB head up to 2.1 GB), equal
    to their source, copied to the card asynchronously, and unregistered
    once their last tensor goes, so that the same addresses register
    again, copy after copy."""
    from mlease_tpu_torch.train import streaming

    released = []
    unregister = streaming._LockedPages.__del__

    def counted(self):
        released.append(self.ptr)
        unregister(self)
    monkeypatch.setattr(streaming._LockedPages, "__del__", counted)
    src = torch.arange(3 * 1000 * 128, dtype=torch.float32).view(
        3, 1000, 128).to(torch.bfloat16)
    got = streaming._locked_copy(src)
    assert got.is_pinned() and got.dtype == src.dtype
    assert got.shape == src.shape and torch.equal(got, src)
    assert got.untyped_storage().nbytes() == src.numel() * 2
    dev = torch.empty_like(got, device=cuda)
    dev.copy_(got, non_blocking=True)
    torch.cuda.synchronize()
    assert torch.equal(dev.cpu(), src)
    view = got.view(-1)[5:]
    del got
    assert released == []          # a view keeps the pages
    del view
    assert len(released) == 1
    for t in (torch.zeros(0, dtype=torch.int32), torch.ones(7, dtype=bool)):
        c = streaming._locked_copy(t)
        assert torch.equal(c, t) and c.dtype == t.dtype
    big = torch.ones(16 << 20, dtype=torch.float32)
    for _ in range(20):
        c = streaming._locked_copy(big)
        assert c.is_pinned()
        del c
    assert len(released) == 22


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["admm", "stream"])
def test_the_clock_times_the_loops_on_the_card(cuda, kind):
    """The trainer's clock on the card: each captured branch holds the
    open and the close stamp of its own slot; a loop's time is above 0
    and holds its branches'; the data passes' head and K1 spans (and a
    shipped group's wire stall) are recorded; each launch's interval,
    mapped onto the host clock, lies inside its iteration's span, within
    the offset's error bound."""
    from mlease_tpu_torch.core.dataset import split_blocks
    from mlease_tpu_torch.core.vocab import FeatureVocab
    from mlease_tpu_torch.ops.device_loop import stamp_nodes
    from mlease_tpu_torch.train.admm import AdmmConfig, AdmmTrainer
    from mlease_tpu_torch.train.streaming import StreamingAdmmTrainer
    from mlease_tpu_torch.utils import profiling

    data = blocked_data(31, B=4, R=1500)
    vocab = FeatureVocab.from_names(f"f{i}" for i in range(3000))
    cfg = AdmmConfig(lambdas=[1.0, 10.0], num_iters=4, head_size=64,
                     dtype=torch.float32, epsilon=0.0)
    if kind == "admm":
        tr = AdmmTrainer(data, vocab, cfg, device=cuda)
    else:
        tr = StreamingAdmmTrainer(split_blocks(data, 2), vocab, cfg,
                                  resident_head=False, compact_wire=True,
                                  device=cuda)
    tr.run()
    profiling.reset()
    res = tr.run()
    for lp in tr._loops.values():
        loop = lp.loop
        for k, name in enumerate(loop.names):
            graph = loop._graphs[k].raw_cuda_graph()
            assert stamp_nodes(graph, loop.table, k) == (1, 1), name
        counts = loop.counts()
        assert counts["loop_ns"] > 0
        assert 0 < sum(counts["branch_ns"].values()) <= counts["loop_ns"]
    rec = profiling.recorded()
    (clock,) = rec["clocks"].values()
    err = clock["error_ns"]
    assert err is not None and 0 <= err < 5_000_000, clock
    spans = rec["spans"]
    names = {s.name for s in spans}
    assert {"head_pass", "tail_pass"} <= names
    if kind == "stream":
        assert "wire_wait" in names
    launches = [s for s in spans if s.name.endswith("/launch")]
    assert len(launches) == res.iterations * len(tr._loops)
    for s in launches:
        it = spans[s.parent]
        assert it.name.endswith("_iteration")
        assert it.start <= s.start <= s.end <= it.end + err, (s, it, err)
    for s in spans:
        if s.device is not None:
            # a stall may end before the stream reaches it
            assert s.executions > 0 and (s.ns > 0 or s.name == "wire_wait"
                                         and s.ns == 0), s


# ---------------------------------------------------------------------------
# The bf16 head's kernels (ops/head_pass.py, csrc/head_pass.cu)
# ---------------------------------------------------------------------------
#
# Each entry against the float64 product of the same bfloat16 head, per
# element |kernel - f64| <= c 2^-24 (|out0| + sum |terms|), c the longest
# chain of float32 roundings the kernel's order makes: Xv's 16 products a
# lane, the group's butterfly and the add into out (32 covers a 128-column
# panel and a few panels); X'v's rows a lane sums, the butterfly
# over the warp's groups, the block's 8 warps, the grid's partials, the add
# into out (`xtv_chain`).

def head_inputs(cuda, seed, B, Rb, H, L, flat=True):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    shape = (B, Rb, H) if flat else (B * Rb, H)
    x = torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)
    n = B * H + 7
    ids = torch.randperm(n, generator=gen, device=cuda)[:B * H]
    hw = torch.randn((L, B * H), generator=gen, device=cuda)
    D = torch.randn((L, B * Rb), generator=gen, device=cuda)
    return x, ids, hw, D, n


def xtv_chain(x, L):
    from mlease_tpu_torch.ops import head_pass
    Rb = x.shape[-2]
    cx = head_pass.grid_blocks(x, L)
    span = -(-(-(-Rb // cx)) // 32) * 32
    G = 16                       # lanes a row's 128-column panel
    return G * -(-span // 256) + 5 + 8 + cx + 1


def check_head_xv(x, hw, out0, c=32):
    from mlease_tpu_torch.ops.head_pass import head_xv
    B, Rb, H = x.shape if x.dim() == 3 else (1, *x.shape)
    L = hw.shape[0]
    got = head_xv(x, hw, out0.clone())
    xb = x.reshape(B, Rb, H)
    want = out0.double().view(L, B, Rb).clone()
    scale = out0.double().abs().view(L, B, Rb).clone()
    for b in range(B):           # one block at a time in float64
        x64, w64 = xb[b].double(), hw[:, b * H:(b + 1) * H].double()
        want[:, b] += w64 @ x64.T
        scale[:, b] += w64.abs() @ x64.abs().T
    torch.cuda.synchronize()
    err = (got.double() - want.view(L, -1)).abs()
    assert bool((err <= c * 2**-24 * scale.view(L, -1)).all()), \
        float(err.max())
    return got


def check_head_xtv(x, D, ids, out0, square_from):
    from mlease_tpu_torch.ops.head_pass import head_xtv
    B, Rb, H = x.shape if x.dim() == 3 else (1, *x.shape)
    L = D.shape[0]
    sf = min(square_from, L)
    got = head_xtv(x, D, ids, out0.clone(), square_from=square_from)
    xb = x.reshape(B, Rb, H)
    terms = torch.empty((L, B * H), dtype=torch.float64, device=x.device)
    mags = torch.empty_like(terms)
    for b in range(B):           # one block at a time in float64
        x64, xs64 = xb[b].double(), (xb[b] * xb[b]).double()
        D64 = D[:, b * Rb:(b + 1) * Rb].double()
        cols = slice(b * H, (b + 1) * H)
        terms[:sf, cols] = D64[:sf] @ x64
        terms[sf:, cols] = D64[sf:] @ xs64
        mags[:sf, cols] = D64[:sf].abs() @ x64.abs()
        mags[sf:, cols] = D64[sf:].abs() @ xs64
    want = out0.double().index_add(1, ids, terms)
    scale = out0.double().abs().index_add(1, ids, mags)
    torch.cuda.synchronize()
    err = (got.double() - want).abs()
    c = max(xtv_chain(x, min(8, L - l0)) for l0 in range(0, L, 8))
    assert bool((err <= c * 2**-24 * scale).all()), (float(err.max()), c)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("B,Rb,H,L", [
    (8, 1_562_500, 128, 3),            # a ctr-12m pass: 8 blocks
    (8, 1_562_500, 128, 6),            # its 2L pass
    (3, 1_001, 64, 1), (3, 1_001, 96, 8), (2, 777, 130, 3), (2, 333, 1, 3),
    (1, 5_000, 512, 3),                 # bench's head, four panels
    (2, 100, 16, 9)],                   # lanes past 8: two launches
    ids=["ctr12m-L3", "ctr12m-2L6", "H64-L1", "H96-L8", "H130-L3", "H1-L3",
         "H512-L3", "L9"])
def test_head_kernels_against_float64(cuda, B, Rb, H, L):
    from mlease_tpu_torch.ops.head_pass import head_xtv, head_xv
    x, ids, hw, D, n = head_inputs(cuda, B + H + L, B, Rb, H, L)
    out0 = torch.randn((L, B * Rb), device=cuda)
    before = head_xv.launches, head_xtv.launches
    check_head_xv(x, hw, out0)
    for sf in (L, 0, L // 2):
        check_head_xtv(x, D, ids, torch.randn((L, n), device=cuda), sf)
    assert (head_xv.launches, head_xtv.launches) == (before[0] + 1,
                                                     before[1] + 3)


@pytest.mark.cuda
def test_head_kernels_on_a_2d_head(cuda):
    """An (R, H) head is one block; a head in a strided view is read where
    it lies."""
    x, ids, hw, D, n = head_inputs(cuda, 3, 1, 4_099, 128, 3, flat=False)
    ids = ids[:128]
    check_head_xv(x, hw[:, :128], torch.randn((3, 4_099), device=cuda))
    check_head_xtv(x, D, ids, torch.zeros((3, n), device=cuda), 3)
    wide = torch.randn((4_099, 136), device=cuda).to(torch.bfloat16)
    check_head_xv(wide[:, :128], hw[:, :128],
                  torch.zeros((3, 4_099), device=cuda))
    check_head_xtv(wide[:, 3:131], D, ids, torch.zeros((3, n), device=cuda),
                   1)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [128, 130])
def test_head_kernel_squares_are_the_bfloat16_product(cuda, H):
    """One-hot D rows pick one row a lane: the squared lanes give
    (hb * hb).float() bit for bit, the plain lanes the stored values, at
    every row position of two tiles."""
    from mlease_tpu_torch.ops.head_pass import head_xtv
    gen = torch.Generator(device=cuda).manual_seed(H)
    x = torch.randn((2, 64, H), generator=gen, device=cuda).to(
        torch.bfloat16)
    ids = torch.arange(2 * H, device=cuda)
    sq = (x * x).float()
    for b in range(2):
        for r0 in range(0, 64, 4):
            D = torch.zeros((8, 128), device=cuda)
            for l in range(8):
                D[l, b * 64 + r0 + l % 4] = 1.0
            got = head_xtv(x, D, ids, torch.zeros((8, 2 * H), device=cuda),
                           square_from=4)[:, b * H:(b + 1) * H]
            assert torch.equal(got[:4], x[b, r0:r0 + 4].float())
            assert torch.equal(got[4:], sq[b, r0:r0 + 4])


@pytest.mark.cuda
def test_head_kernels_same_bits_eager_twice_and_captured(cuda):
    """Two eager calls give the same bits, and a DeviceLoop's captured
    calls give the eager bits, counted on the card."""
    from mlease_tpu_torch.ops.device_loop import DeviceLoop
    from mlease_tpu_torch.ops.head_pass import head_xtv, head_xv
    x, ids, hw, D, n = head_inputs(cuda, 7, 4, 200_001, 128, 6)
    out0 = torch.randn((6, 4 * 200_001), device=cuda)
    t0 = torch.randn((6, n), device=cuda)

    def eager():
        return (head_xv(x, hw, out0.clone()),
                head_xtv(x, D, ids, t0.clone(), square_from=3))
    a, b = eager(), eager()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    phase = torch.zeros((), dtype=torch.int32, device=cuda)
    out = torch.empty_like(out0)
    t = torch.empty_like(t0)

    def branch():
        out.copy_(out0)
        head_xv(x, hw, out)
        t.copy_(t0)
        head_xtv(x, D, ids, t, square_from=3)
        phase.fill_(0)
    loop = DeviceLoop([(1, "pass", branch)], phase, [out, t],
                      kernels={"head_xv": head_xv, "head_xtv": head_xtv})
    loop.prepare()
    for _ in range(2):
        out.zero_()
        t.zero_()
        phase.fill_(1)
        loop.run()
        torch.cuda.synchronize()
        assert torch.equal(out, a[0]) and torch.equal(t, a[1])
    counts = loop.counts()
    assert counts["kernel_executions"] == {"head_xv": 2, "head_xtv": 2}
    loop.close()


@pytest.mark.cuda
def test_head_route_only_for_a_bf16_head_under_a_float32_solve(cuda):
    """On the card a float32 head and a bfloat16 solve keep the widening
    route (no head kernel launches); a bfloat16 head under a float32
    solve takes the kernels at each pass."""
    import mlease_tpu_torch.ops.tron_multi as tm
    from mlease_tpu_torch.ops.head_pass import head_xtv, head_xv
    gen = torch.Generator(device=cuda).manual_seed(2)
    B, Rb, H, L = 2, 300, 16, 3
    n = B * H + 5
    x = torch.randn((B, Rb, H), generator=gen, device=cuda)
    for head, dtype, fused in ((torch.bfloat16, torch.float32, True),
                               (torch.float32, torch.float32, False),
                               (torch.bfloat16, torch.bfloat16, False)):
        R = B * Rb
        prob = tm.MultiProblem(
            indices=torch.zeros((R, 0), dtype=torch.int32, device=cuda),
            values=torch.zeros((R, 0), dtype=dtype, device=cuda),
            y=torch.ones(R, dtype=dtype, device=cuda),
            weight=torch.ones(R, dtype=dtype, device=cuda),
            offset=torch.zeros(R, dtype=dtype, device=cuda),
            prior_mean=torch.zeros((L, n), dtype=dtype, device=cuda),
            prior_var_inv=torch.ones((L, n), dtype=dtype, device=cuda),
            head_x=x.to(head),
            head_ids=torch.arange(B * H, dtype=torch.int32, device=cuda))
        before = head_xv.launches + head_xtv.launches
        tm._xv_lm(prob, torch.ones((L, n), dtype=dtype, device=cuda))
        D = torch.ones((L, R), dtype=dtype, device=cuda)
        tm._xtv_lm(prob, D)
        tm._xtv_and_sqdiag_lm(prob, D, D)
        tm._hessian_diagonal_lm(prob, D)
        assert head_xv.launches + head_xtv.launches - before == \
            (4 if fused else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["admm", "stream"])
def test_bf16_head_run_matches_the_widening_route(cuda, monkeypatch, kind):
    """AdmmTrainer.run (and the streaming trainer's) with a bfloat16 head
    under a float32 solve: the kernels' z against the widening route's on
    the same card to 1e-6, with the same trips; every head pass of the
    kernel route inside the head_fused span."""
    import mlease_tpu_torch.ops.tron_multi as tm
    from mlease_tpu_torch.core.dataset import split_blocks
    from mlease_tpu_torch.core.vocab import FeatureVocab
    from mlease_tpu_torch.train.admm import AdmmConfig, AdmmTrainer
    from mlease_tpu_torch.train.streaming import StreamingAdmmTrainer
    from mlease_tpu_torch.utils import profiling

    data = blocked_data(17, B=4, R=3000)
    vocab = FeatureVocab.from_names(f"f{i}" for i in range(3000))
    cfg = AdmmConfig(lambdas=[1.0, 10.0, 100.0], num_iters=4, head_size=64,
                     head_dtype=torch.bfloat16, dtype=torch.float32,
                     test_loglik_per_iter=False)

    def run():
        if kind == "admm":
            tr = AdmmTrainer(data, vocab, cfg, device=cuda)
        else:
            tr = StreamingAdmmTrainer(split_blocks(data, 2), vocab, cfg,
                                      device=cuda)
        profiling.reset()
        res = tr.run()
        names = {}
        for s in profiling.recorded()["spans"]:
            if s.name in ("head_pass", "head_fused"):
                names[s.name] = names.get(s.name, 0) + s.executions
        return res, names
    got, spans = run()
    assert spans["head_fused"] == spans["head_pass"] > 0
    monkeypatch.setattr(tm, "takes", lambda hx, dtype: False)
    want, spans = run()
    assert "head_fused" not in spans
    np.testing.assert_allclose(got.z, want.z, rtol=0,
                               atol=1e-6 * float(np.abs(want.z).max()))
    assert got.solver_stats == want.solver_stats
