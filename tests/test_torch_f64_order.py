"""The float64 ADMM lanes solve against the layout and the order of its
sums, in the port and in the JAX package (ROADMAP.md C, known trait 10).

On the card a streamed lanes run (2 blocks a group) and the in-memory run
(all 4 blocks) solve the same problem bits with the same X'v, Xv and
Jacobi diagonal, but the solver's dot products and norms, torch's
reductions over 6 lanes or over 12, associate otherwise; padded and
unpadded tails move K1's steps (chip_smoke.py phase 24 (a),
`layout_sums`). At the job's liblinear.epsilon 0.01 their z then differ
by more than the 1e-6 * max|z| that phase 24 holds two layouts to at
liblinear.epsilon 1e-8.

Here, on the CPU, with `AdmmTrainer` / `StreamingAdmmTrainer` and
multi_rhs=False (the lanes solve), Jacobi PCG, one iteration, float64,
lambda 1, on chip_smoke.py::synth_blocked_data's blocks (the same draws:
zipf 1.3 columns, 15 a row and the intercept, labels from a random w),
cut to 4 blocks x 8,192 rows over 30,000 features:

- the two layouts agree to rounding in each package (the CPU's sums in
  the solve do not depend on the layout; the consensus adds the blocks
  group by group: 7.3e-17 of max|z| apart);
- each block's rows permuted (the same problem, its X'v, losses and norms
  added in another order) moves the reference's own z at 0.01 far past
  float64 rounding (measured: JAX 1.34e-5 of max|z|, the port 7.8e-6,
  trips equal): the solver carries a last-bit change of its sums to its
  tolerance;
- at 1e-8 both packages stay within 1e-6 * max|z| of their permuted runs
  (measured 8.4e-8 and 7.3e-8) and of each other.

Run as a script from the repository's root
(`PYTHONPATH=. python tests/test_torch_f64_order.py 50000 16384`) it prints
the same distances at phase 24 (a)'s shape (50,000 features, 4 x 16,384
rows).
"""

import sys

import jax.numpy as jnp
import numpy as np
import torch

from mlease_tpu.core.dataset import BlockedData as JaxBlockedData
from mlease_tpu.core.dataset import split_blocks as jax_split_blocks
from mlease_tpu.core.vocab import FeatureVocab as JaxVocab
from mlease_tpu.train.admm import AdmmConfig as JaxConfig
from mlease_tpu.train.admm import AdmmTrainer as JaxTrainer
from mlease_tpu.train.streaming import StreamingAdmmTrainer as JaxStreaming
from mlease_tpu_torch.core.dataset import BlockedData, split_blocks
from mlease_tpu_torch.core.vocab import FeatureVocab
from mlease_tpu_torch.train.admm import AdmmConfig, AdmmTrainer
from mlease_tpu_torch.train.streaming import StreamingAdmmTrainer

torch.set_num_threads(1)

FEATURES, BLOCKS, ROWS, NNZ = 30_000, 4, 8_192, 15
LAMBDAS = [1.0]
EPSILON = 0.01                 # ctr-12m.job's liblinear.epsilon
TIGHT = 1e-8
HELD = 1e-6                    # phase 24 (a)'s layout-to-layout bound
ROUNDING = 1e3 * np.finfo(np.float64).eps


def blocked(features=FEATURES, rows=ROWS, seed=0):
    """chip_smoke.py::synth_blocked_data(features, BLOCKS, rows, NNZ,
    seed)'s arrays: each block from its own stream of the seed."""
    n, B, R = features + 1, BLOCKS, rows
    seqs = np.random.SeedSequence(seed).spawn(B + 1)
    w_true = (np.random.default_rng(seqs[B]).normal(size=n)
              * 0.3).astype(np.float32)
    w_true[features] = -1.5
    indices = np.empty((B, R, NNZ + 1), np.int32)
    values = np.empty((B, R, NNZ + 1), np.float32)
    y = np.empty((B, R), np.float32)
    present = np.zeros((B, n), dtype=bool)
    for b in range(B):
        rng = np.random.default_rng(seqs[b])
        raw = rng.zipf(1.3, size=(R, NNZ))
        raw -= 1
        raw %= features
        indices[b, :, :NNZ] = raw
        indices[b, :, NNZ] = features
        values[b, :, :NNZ] = rng.normal(size=(R, NNZ)) * 0.5
        values[b, :, NNZ] = 1.0
        scores = np.einsum("rk,rk->r", values[b],
                           w_true[indices[b]]).astype(np.float32)
        p = 1.0 / (1.0 + np.exp(-scores))
        y[b] = np.where(rng.random(R) < p, 1.0, -1.0)
        present[b, indices[b].ravel()] = True
    return dict(indices=indices, values=values, y=y,
                weight=np.ones((B, R), np.float32),
                offset=np.zeros((B, R), np.float32), present=present,
                nrows=np.full(B, R, np.int32), nblocks=B, dim=n)


def permuted(data, seed=7):
    """The same blocks, each block's rows in a seeded permutation."""
    R = data["y"].shape[1]
    rng = np.random.default_rng(seed)
    perm = np.stack([rng.permutation(R) for _ in range(BLOCKS)])
    out = dict(data)
    for f in ("indices", "values", "y", "weight", "offset"):
        a = data[f]
        out[f] = np.take_along_axis(
            a, perm if a.ndim == 2 else perm[..., None], axis=1)
    return out


def solve(pkg, data, eps, groups=0):
    """One iteration's z and trips; in 2 groups of 2 blocks (the
    streaming trainer) where `groups`."""
    names = [f"f{i}" for i in range(data["dim"] - 1)]
    kw = dict(lambdas=LAMBDAS, num_iters=1, pcg=True, multi_rhs=False,
              liblinear_epsilon=eps)
    if pkg == "jax":
        d, vocab = JaxBlockedData(**data), JaxVocab.from_names(names)
        cfg = JaxConfig(dtype=jnp.float64, **kw)
        res = (JaxStreaming(jax_split_blocks(d, groups), vocab, cfg)
               if groups else JaxTrainer(d, vocab, cfg)).run()
    else:
        d, vocab = BlockedData(**data), FeatureVocab.from_names(names)
        cfg = AdmmConfig(dtype=torch.float64, **kw)
        res = (StreamingAdmmTrainer(split_blocks(d, groups), vocab, cfg,
                                    device="cpu") if groups else
               AdmmTrainer(d, vocab, cfg, device="cpu")).run()
    return res.z, res.solver_stats


def distance(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def distances(data):
    """{(what, eps): distance / max|z|} (a run in 2 groups at 0.01 and
    the permuted runs from the given run, the port's given run from the
    JAX package's) and the trips of each run."""
    moved = permuted(data)
    z, dist, trips = {}, {}, {}
    for eps in (EPSILON, TIGHT):
        for pkg in ("jax", "port"):
            (a, ta), (b, tb) = solve(pkg, data, eps), solve(pkg, moved, eps)
            z[pkg, eps] = a
            dist[f"{pkg} permuted", eps] = distance(b, a)
            trips[pkg, eps] = (ta, tb)
            if eps == EPSILON:
                dist[f"{pkg} 2 groups", eps] = distance(
                    solve(pkg, data, eps, groups=2)[0], a)
        dist["port vs jax", eps] = distance(z["port", eps], z["jax", eps])
    return z, dist, trips


def test_float64_lanes_solve_against_the_layout_and_order_of_its_sums():
    data = blocked()
    _z, dist, trips = distances(data)
    print("float64 distances / max|z|:",
          {f"{k[0]} @ {k[1]}": f"{v:.3e}" for k, v in dist.items()},
          "trips (given, permuted):", trips)
    # on the CPU 2 groups of 2 blocks and the 4 blocks in memory agree to
    # rounding, in both packages
    for key in ("jax 2 groups", "port 2 groups"):
        assert dist[key, EPSILON] <= ROUNDING, (key, dist[key, EPSILON])
    # the trait, in the reference's own float64 solve: a last-bit change
    # of its sums moves z far past rounding at 0.01
    assert dist["jax permuted", EPSILON] > ROUNDING
    # at 1e-8 the solves reach one point: within the layout-to-layout
    # bound in both packages, and between them
    for key in ("jax permuted", "port permuted", "port vs jax"):
        assert dist[key, TIGHT] <= HELD, (key, dist[key, TIGHT])


if __name__ == "__main__":
    import jax
    jax.config.update("jax_enable_x64", True)
    features, rows = (int(a) for a in sys.argv[1:3])
    _z, dist, trips = distances(blocked(features, rows))
    for k, v in dist.items():
        print(f"{k[0]} @ liblinear.epsilon {k[1]}: {v:.3e} of max|z|")
    print("trips (given, permuted):", trips)
