"""The float32 lanes solve's sensitivity to the order of its sums, in the
port and in the JAX package (ROADMAP.md C, known trait 10).

`train_naive`'s lanes solve (multi_rhs=False, one reference TRON per
(lambda, key) lane) at the job's liblinear.epsilon 0.01 on ctr-like rows
(zipf 1.3 columns, 12 draws a row, as chip_smoke.py's generator, scaled
down to 4 keys x 1,000 rows over 5,000 features), in float32 with each
key's rows in ORDERS orders: as given and in seeded permutations. The
order moves the float32 sums (X'v over the rows, the losses, the norms),
and at this tolerance a lane's stop test may then pass one Newton step
earlier or later: its x moves by the distance between two Newton iterates
(the float64 solve at 0.01 is itself 2% of max|x| from the optimum), not
by rounding.

Each float32 run's distance from the float64 solve of the same rows, in
units of its max|x|, and its per-lane (Newton, CG) trips, for both
packages on the same orders (the JAX side is train_naive's lanes solve,
jitted once per dtype and held to train_naive bit for bit). The bounds,
over the same orders: the port's largest and its median distance at most
2x the JAX package's, its count of (lane, order) runs whose Newton trips
moved at most 2x the JAX package's, and every lane it moves moved by the
same number of Newton steps in some run of the reference; more would be
a sum or a stop test of the port that differs from the reference. In
float64 the two agree to 1e-8 * max|x| with equal trips in every lane.

Measured here (32 orders): distances JAX 2.23e-4 to 2.185e-2, median
1.32e-2; the port 1.91e-4 to 2.185e-2, median 2.06e-2; moved runs JAX
16, the port 23, all one Newton step more, in the lanes (lambda 1, key 2)
(JAX 8, the port 14) and (lambda 1, key 3) (8, 9).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import mlease_tpu_torch.train.naive as tnaive
from mlease_tpu.core import build_vocab as jax_build_vocab
from mlease_tpu.core import pack_blocks as jax_pack_blocks
from mlease_tpu.ops import admm_math
from mlease_tpu.ops import objective as jobj
from mlease_tpu.ops.tron import tron as jax_tron
from mlease_tpu.train.naive import NaiveConfig as JaxNaiveConfig
from mlease_tpu.train.naive import train_naive as jax_train_naive
from mlease_tpu_torch.core import build_vocab
from mlease_tpu_torch.train.naive import NaiveConfig, train_naive

torch.set_num_threads(1)

KEYS, ROWS, FEATURES, NNZ = 4, 1_000, 5_000, 12
ORDERS = 32                    # the given order and 31 seeded permutations
LAMBDAS = [1.0, 10.0, 100.0]
EPSILON = 0.01                 # ctr-12m.job's liblinear.epsilon
BOUND = 2.0                    # port / JAX: largest and median distance,
                               # moved runs


def ctr_rows(rng, n, w):
    rows = []
    for _ in range(n):
        js = np.unique((rng.zipf(1.3, size=NNZ) - 1) % FEATURES)
        vals = rng.normal(size=js.size) * 0.5
        p = 1.0 / (1.0 + np.exp(-(vals @ w[js] - 1.5)))
        rows.append({"response": int(rng.random() < p),
                     "features": [(f"f{j}", float(v))
                                  for j, v in zip(js, vals)],
                     "weight": 1.0, "offset": 0.0})
    return rows


def orders():
    rng = np.random.default_rng(0)
    w = rng.normal(size=FEATURES) * 0.3
    keyed = {f"k{i}": ctr_rows(rng, ROWS, w) for i in range(KEYS)}
    out = [keyed]
    for s in range(1, ORDERS):
        perm = np.random.default_rng(s)
        out.append({k: [v[i] for i in perm.permutation(len(v))]
                    for k, v in keyed.items()})
    return out


def jax_lanes(dtype, vocab, epsilon=EPSILON):
    """JAX train_naive's lanes branch (mlease_tpu/train/naive.py, its
    defaults), jitted once, returning the per-lane trips beside x:
    keyed -> (x (L, K, n) masked to each key's features, Newton (L, K),
    CG (L, K))."""
    n = vocab.size
    pvi = np.stack([admm_math.per_feature_lambda(l, n, None, vocab)
                    for l in LAMBDAS])
    pvi[:, vocab.intercept_index] = 1.0 / JaxNaiveConfig().intercept_prior_var
    pvi = jnp.asarray(pvi, dtype)
    prior_mean = jnp.zeros((n,), dtype)

    def one(indices, values, y, weight, offset, pvi_l, eps):
        prob = jobj.LRProblem(indices=indices, values=values, y=y,
                              weight=weight, offset=offset,
                              prior_mean=prior_mean, prior_var_inv=pvi_l)
        r = jax_tron(prob, jnp.zeros(n, dtype), eps)
        return r.w, r.iterations, r.cg_iterations

    keys = jax.vmap(one, in_axes=(0, 0, 0, 0, 0, None, 0))
    grid = jax.jit(jax.vmap(keys, in_axes=(None,) * 5 + (0, None)))

    def solve(keyed):
        d = jax_pack_blocks([keyed[k] for k in sorted(keyed)], vocab,
                            bias=1.0)
        eps = epsilon * jobj.class_balance_eps_scale(d.y, d.nrows)
        w, nt, cg = grid(*(jnp.asarray(a, dt) for a, dt in (
            (d.indices, None), (d.values, dtype), (d.y, dtype),
            (d.weight, dtype), (d.offset, dtype))), pvi,
            jnp.asarray(eps, dtype))
        x = np.where(d.present[None], np.asarray(w, np.float64), 0.0)
        return x, np.asarray(nt), np.asarray(cg)
    return solve


def port_lanes(dtype, vocab, monkeypatch):
    """The port's train_naive (lanes, on the CPU: K1's plain version),
    with the per-lane trips its loop read."""
    seen = {}
    solve_keys = tnaive._solve_keys

    def spy(*a, **kw):
        solved = solve_keys(*a, **kw)
        seen["trips"] = solved.loop.trips().numpy().copy()
        return solved
    monkeypatch.setattr(tnaive, "_solve_keys", spy)

    def solve(keyed):
        res = train_naive(keyed, NaiveConfig(
            lambdas=LAMBDAS, liblinear_epsilon=EPSILON, multi_rhs=False,
            dtype=dtype), vocab=vocab, device="cpu")
        x = np.stack([[res.models[f"{lam}#{k}"].to_dense(vocab)
                       for k in sorted(keyed)]
                      for lam in ("1.0", "10.0", "100.0")])
        nt, cg = seen["trips"].T.reshape(2, len(LAMBDAS), KEYS)
        return x, nt, cg
    return solve


def test_float32_order_sensitivity_is_the_references(monkeypatch):
    runs = orders()
    rows = [r for k in sorted(runs[0]) for r in runs[0][k]]
    jv, tv = jax_build_vocab(rows), build_vocab(rows)
    jax32, port32 = jax_lanes(jnp.float32, jv), port_lanes(torch.float32,
                                                           tv, monkeypatch)
    ref, jnt64, jcg64 = jax_lanes(jnp.float64, jv)(runs[0])
    optimum = jax_lanes(jnp.float64, jv, epsilon=1e-9)(runs[0])[0]
    got, pnt64, pcg64 = port_lanes(torch.float64, tv, monkeypatch)(runs[0])
    scale = float(np.abs(ref).max())
    # float64: the two packages agree, lane by lane
    assert np.abs(got - ref).max() <= 1e-8 * scale
    np.testing.assert_array_equal(pnt64, jnt64)
    np.testing.assert_array_equal(pcg64, jcg64)

    # the replica is JAX train_naive's lanes solve, bit for bit
    x0 = jax32(runs[0])[0]
    want = jax_train_naive(runs[0], JaxNaiveConfig(
        lambdas=LAMBDAS, liblinear_epsilon=EPSILON, multi_rhs=False,
        dtype=jnp.float32), vocab=jv)
    np.testing.assert_array_equal(x0, np.stack([
        [want.models[f"{lam}#{k}"].to_dense(jv) for k in sorted(runs[0])]
        for lam in ("1.0", "10.0", "100.0")]))

    dist = {"jax": [], "port": []}
    moved = {"jax": {}, "port": {}}     # (lambda, key, Newton steps): runs
    for keyed in runs:
        for pkg, solve, nt64 in (("jax", jax32, jnt64),
                                 ("port", port32, pnt64)):
            x, nt, _cg = solve(keyed)
            assert np.isfinite(x).all()
            dist[pkg].append(float(np.abs(x - ref).max()) / scale)
            for lane in zip(*np.nonzero(nt != nt64)):
                step = (*(int(i) for i in lane),
                        int(nt[lane]) - int(nt64[lane]))
                moved[pkg][step] = moved[pkg].get(step, 0) + 1
    worst = {pkg: max(d) for pkg, d in dist.items()}
    median = {pkg: float(np.median(d)) for pkg, d in dist.items()}
    count = {pkg: sum(m.values()) for pkg, m in moved.items()}
    print("float32 distances / max|x| over the orders:",
          {pkg: [f"{d:.3e}" for d in v] for pkg, v in dist.items()},
          "median:", median, "runs whose Newton trips moved "
          "((lambda, key, steps): runs):", moved,
          "the float64 solve's distance from the optimum: "
          f"{float(np.abs(ref - optimum).max()) / scale:.3e}")
    # the trait: the reference's own float32 solve moves with the order
    # (some lane stops at another Newton iterate)
    assert count["jax"] > 0 and max(dist["jax"]) > 10 * min(dist["jax"])
    # ... and the port moves no further and no more often than 2x the
    # reference, and only as the reference moves
    assert worst["port"] <= BOUND * worst["jax"], worst
    assert median["port"] <= BOUND * median["jax"], median
    assert count["port"] <= BOUND * count["jax"], moved
    assert set(moved["port"]) <= set(moved["jax"]), moved
