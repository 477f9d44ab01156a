"""The reference against a plain float64 consensus ADMM of two blocks at
a tiny size, each x-update solved to convergence by dense Newton."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gpubench import datagen, reference

SPEC = datagen.DataSpec(rows=600, blocks=2, n_features=40, nnz=4,
                        zipf_a=1.3, value_std=0.5, w_std=0.3,
                        intercept_weight=-1.5, test_rows=10)
SEED = 2**31 + 12345


def dense_blocks(spec, seed, head_size, head_dtype):
    """Each block's dense X (R, n) as the job stores it: duplicates summed,
    the head columns (most nonzeros over the problem, ties to the lower
    id) rounded to head_dtype."""
    made = list(datagen.blocks(spec, seed, "cpu"))
    idx = torch.stack([m[1] for m in made])
    val = torch.stack([m[2] for m in made])
    n = spec.dim
    head = set()
    if head_size:
        counts = np.bincount(idx.reshape(-1).numpy(), minlength=n)
        head = set(np.argsort(-counts, kind="stable")[:head_size].tolist())
    out = []
    for b, i, v, y in made:
        X = np.zeros((spec.rows_per_block, n))
        np.add.at(X, (np.repeat(np.arange(len(i)), i.shape[1]),
                      i.reshape(-1).numpy()), v.reshape(-1).double().numpy())
        for c in head:
            X[:, c] = torch.from_numpy(X[:, c].copy()).float().to(
                head_dtype).double().numpy()
        out.append((X, y.double().numpy()))
    return out


def newton(X, y, prior, rho, w):
    for _ in range(100):
        m = y * (X @ w)
        s = 1 / (1 + np.exp(-m))
        g = X.T @ ((s - 1) * y) + rho * (w - prior)
        H = X.T @ (X * (s * (1 - s))[:, None]) + rho * np.eye(len(w))
        step = np.linalg.solve(H, g)
        w = w - step
        if np.abs(step).max() < 1e-13:
            break
    return w


def plain_admm(blocks, lambdas, iters):
    n = blocks[0][0].shape[1]
    N = len(blocks)
    z = np.zeros((len(lambdas), n))
    u = np.zeros((len(lambdas), N, n))
    for _ in range(iters):
        x = np.stack([[newton(X, y, z[l] - u[l, b], 1.0, z[l].copy())
                       for b, (X, y) in enumerate(blocks)]
                      for l in range(len(lambdas))])
        v = x.mean(1) + u.mean(1)
        lam = np.array(lambdas)[:, None]
        z = N / (lam + N) * v
        z[:, -1] = v[:, -1]
        u = u + x - z[:, None, :]
    return z


@pytest.mark.parametrize("head", [0, 6])
def test_reference_equals_plain_admm(head):
    job = reference.Job(lambdas=[1.0, 10.0, 100.0], num_iters=5,
                        epsilon=0.0, liblinear_epsilon=1e-12,
                        head_size=head,
                        head_dtype=torch.bfloat16 if head else None,
                        compute_dtype=torch.float64, groups=1)
    got = reference.run(SPEC, SEED, job, "cpu").z.numpy()
    want = plain_admm(dense_blocks(SPEC, SEED, head, torch.bfloat16),
                      job.lambdas, job.num_iters)
    # the reference's inner solves end at TRON's float64 stall test, a few
    # 1e-8 from the exact x-update; a wrong term would read above 1e-3
    assert np.abs(got - want).max() < 1e-6 * max(1.0, np.abs(want).max())


def test_groups_are_the_same_admm():
    job = reference.Job(lambdas=[1.0, 10.0], num_iters=4, epsilon=0.0,
                        liblinear_epsilon=1e-12, head_size=0,
                        head_dtype=None, compute_dtype=torch.float64,
                        groups=1)
    one = reference.run(SPEC, SEED, job, "cpu").z
    job.groups = 2
    two = reference.run(SPEC, SEED, job, "cpu").z
    assert torch.allclose(one, two, rtol=0, atol=1e-6)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -1.0 - 2**-11,
                      1.0 + 2**-10], dtype=torch.float32)
    got = reference.tf32(x).tolist()
    # ties to even at the tenth mantissa bit
    assert got == [1.0, 1.0, 1.0 + 2**-9, -1.0, 1.0 + 2**-10]


@pytest.mark.parametrize("key, value", [("pcg", "head_block"),
                                        ("regularizer", "1"),
                                        ("relaxation", "1.5"),
                                        ("multi.rhs", "false")])
def test_reference_refuses_what_it_does_not_run(key, value):
    keys = {"lambda": "1,10", key: value}
    with pytest.raises(NotImplementedError):
        reference.Job.from_keys(keys)
    keys[key] = {"pcg": "jacobi", "regularizer": "2.0", "relaxation": "1",
                 "multi.rhs": "true"}[key]
    assert reference.Job.from_keys(keys).lambdas == [1.0, 10.0]


def test_every_seed_draws_the_same_sizes_in_another_order():
    """Each block's column counts are the same multiset for every seed
    (the shapes the program sorts, packs and holds), while the columns,
    values and labels differ."""
    def made(seed):
        return list(datagen.blocks(SPEC, seed, "cpu"))

    a, b = made(SEED), made(SEED + 1)
    for (_, ia, va, ya), (_, ib, vb, yb) in zip(a, b):
        ca = np.bincount(ia.reshape(-1).numpy(), minlength=SPEC.dim)
        cb = np.bincount(ib.reshape(-1).numpy(), minlength=SPEC.dim)
        assert np.array_equal(np.sort(ca), np.sort(cb))
        assert not torch.equal(ia, ib)
        assert not torch.equal(va, vb)
        assert not torch.equal(ya, yb)
