"""Per-item model training: thousands of small LRs with posterior variance.

Port of mlease_tpu/train/item.py, the counterpart of ItemModelTrain
(reference: ItemModelTrain.java:130-312): the reference shuffles rows to one
reducer per item key and fits the (intercept.lambdas x default.lambdas) grid
sequentially per item. Here items are packed into *local* dense coordinate
systems (intercept at local index 0, the item's observed features after it),
bucketed by padded (rows, nonzeros, features) shape, and each bucket solves
its whole (grid x item) batch as one call of the batched solver: the two
`vmap`s of the JAX trainer become the leading problem axis P = G * I of
ops/objective.py. The Newton Hessians and the full posterior covariance go
through the weighted-Gram kernel (ops/gram.py) on the card.

The JAX trainer also pads the item axis of a bucket to a {2^k, 1.5 * 2^k}
size with copies of item 0, only so that XLA reuses a compiled program for
other item counts. PyTorch compiles nothing, so the port does not pad the
item axis; results are unchanged. The (R, K, F) shape buckets stay.

A bucket's problem keeps each item's data once and lets the G grid points
share it (ops/objective.py's lanes: data blocks (I, R, K), lanes P = G*I,
grid-major); on the card it carries the column-sorted copy of its
nonzeros, so that X'v (the gradient, Hv) and the Hessian diagonal sum
with K1 in one fixed order, and two runs give the same bits. Each
bucket's solve is one program on the card, as the JAX package jits it
(`_solve_bucket`): the Cholesky route's Newton step, Armijo trial and
Newton finish (ops/newton.py::NewtonSolver) or the TRON route's CG start,
CG trip and Newton epilogue (train/admm.py::_SolveLoop's lanes solve),
looped on the card by ops/device_loop.py; the posterior variance or
covariance follows eagerly, and the host reads the bucket once: w, the
variances, the covariances and the trips in one copy. All buckets of a
call capture into one graph pool.

Under a mesh (`mesh=`, a 1-D block mesh of parallel/mesh.py, every rank
calling with the whole input) a bucket's item axis is padded to a multiple
of the ranks with copies of item 0 (as the JAX package pads it) and each
rank solves its contiguous share, with no collective inside the solve;
then one all_gather of w, the posterior variances and the covariances per
bucket, and every rank assembles the same ItemResult.

Reference semantics kept:
  * grid keys "ilambda:dlambda#item" (ItemModelTrain.java:265)
  * intercept prior mean from intercept.prior.mean.map else
    intercept.default.prior.mean (:240-248); other features prior mean 0
  * prior var: 1/intercept_lambda for the intercept, per-feature
    1/lambda.map[k], else 1/default_lambda (:251-262 with :193-216)
  * posterior variance (compute.var): diagonal 1/hessianDiagonal
    (LibLinear.java:330-333), or full inverse of the Hessian
    (LibLinear.java:317-327) with the diagonal reported
  * lambda.map features absent from an item's data report posterior variance
    = prior variance (LibLinear.java:385-396)
  * cold start w=0 (initParam=null, ItemModelTrain.java:262)
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from mlease_tpu_torch.core.linear_model import LinearModel
from mlease_tpu_torch.device import resolve_device
from mlease_tpu_torch.io.fast_decode import DecodedRows  # noqa: F401 (re-export)
from mlease_tpu_torch.io.records import INTERCEPT_NAME
from mlease_tpu_torch.ops import objective as obj
from mlease_tpu_torch.ops.device_loop import DeviceLoop
from mlease_tpu_torch.ops.newton import NewtonSolver, NewtonStep
from mlease_tpu_torch.collectives import all_gather, all_reduce
from mlease_tpu_torch.parallel.mesh import (BLOCK_AXIS, axis_size,
                                            block_sharding, mesh_device)
from mlease_tpu_torch.train.admm import (_SOLVE_KERNELS, _Solved,
                                         _SolveLoop, _assign, _graph_pool,
                                         _lambda_key, _materialize,
                                         _to_device, blocked_problem)


@dataclass
class ItemConfig:
    intercept_lambdas: Sequence[float] = (1.0,)
    default_lambdas: Sequence[float] = (1.0,)
    intercept_default_prior_mean: float = 0.0
    intercept_prior_mean_map: Mapping[str, float] | None = None
    lambda_map: Mapping[str, float] | None = None
    compute_var: bool = False
    full_cov: bool = False
    liblinear_epsilon: float = 0.01
    positive_weight: float = 1.0
    solver: str = "cholesky"   # "cholesky": dense Newton on the weighted
                               # Gram kernel; "tron": the CG solver
    dtype: Any = torch.float32
    max_newton_iter: int = 1000
    max_cg_iter: int = 500


@dataclass
class ItemResult:
    models: dict[str, LinearModel]                 # "il:dl#item" -> model
    posterior_var: dict[str, LinearModel]          # same keys (empty model if
                                                   # compute_var=False)
    covariances: dict[str, dict] | None = None     # full_cov: {key: {(f1,f2): v}}
    # per bucket: shape, problems, the solver's lock-step trips, and the
    # host's wall seconds for the
    # solve (copies to and from the device included; capture_s of it the
    # device loop's warm-up and capture) and for assembling the result
    # dictionaries
    solver_stats: list[dict] | None = None


def _bucket_dim(x: int, floor: int = 8) -> int:
    """Next power of two (>= floor): shape-buckets items so thousands of
    distinct per-item sizes share a handful of compiled solver
    specializations (at most ~2x padding waste)."""
    n = floor
    while n < x:
        n <<= 1
    return n


def _pack_local(rows, lambda_map):
    """One item's rows -> local coords. Returns (names, indices, values, y,
    weight, offset, map_mask, map_vals) with intercept at local index 0."""
    names = [INTERCEPT_NAME]
    index = {INTERCEPT_NAME: 0}
    parsed = []
    for row in rows:
        acc = {0: 1.0}  # intercept/bias slot
        for key, v in row["features"]:
            j = index.get(key)
            if j is None:
                j = len(names)
                index[key] = j
                names.append(key)
            acc[j] = acc.get(j, 0.0) + v
        parsed.append(acc)
    return names, index, parsed


def _pack_buckets_rows(keyed_rows: Mapping[str, Sequence[Mapping]],
                       cfg: ItemConfig):
    """Canonical-row-dict packing (per-record Python; the columnar path
    below is the scalable one). Yields the packed-bucket structures
    consumed by _train_packed."""
    lambda_map = dict(cfg.lambda_map or {})
    pm_map = dict(cfg.intercept_prior_mean_map or {})

    items = []
    for key in sorted(keyed_rows):
        rows = keyed_rows[key]
        if not rows:
            continue
        names, index, parsed = _pack_local(rows, lambda_map)
        R = _bucket_dim(len(rows))
        K = _bucket_dim(max(len(a) for a in parsed))
        F = _bucket_dim(len(names))
        items.append((key, rows, names, parsed, R, K, F))

    buckets: dict[tuple[int, int, int], list] = {}
    for it in items:
        buckets.setdefault((it[4], it[5], it[6]), []).append(it)

    packed = []
    for (R, K, F), bucket in sorted(buckets.items()):
        I = len(bucket)
        indices = np.zeros((I, R, K), np.int32)
        values = np.zeros((I, R, K), np.float32)
        y = np.ones((I, R), np.float32)
        weight = np.zeros((I, R), np.float32)
        offset = np.zeros((I, R), np.float32)
        prior_mean = np.zeros((I, F), np.float64)
        map_mask = np.zeros((I, F), bool)
        map_pvi = np.ones((I, F), np.float64)
        pad_mask = np.zeros((I, F), bool)
        nrows = np.zeros(I, np.int32)
        meta = []

        for i, (key, rows, names, parsed, *_shape) in enumerate(bucket):
            for r, acc in enumerate(parsed):
                cols = list(acc.keys())
                indices[i, r, :len(cols)] = cols
                values[i, r, :len(cols)] = [acc[c] for c in cols]
                y[i, r] = 1.0 if rows[r]["response"] == 1 else -1.0
                w_ = rows[r].get("weight", 1.0)
                weight[i, r] = (w_ * cfg.positive_weight
                                if (y[i, r] == 1 and cfg.positive_weight != 1.0)
                                else w_)
                offset[i, r] = rows[r].get("offset", 0.0)
            nrows[i] = len(rows)
            prior_mean[i, 0] = pm_map.get(key, cfg.intercept_default_prior_mean)
            for f, name in enumerate(names):
                if f > 0 and name in lambda_map:
                    map_mask[i, f] = True
                    map_pvi[i, f] = lambda_map[name]
            pad_mask[i, len(names):] = True
            meta.append((key, names))

        packed.append(((R, K, F),
                       dict(indices=indices, values=values, y=y,
                            weight=weight, offset=offset,
                            prior_mean=prior_mean, map_mask=map_mask,
                            map_pvi=map_pvi, pad_mask=pad_mask, nrows=nrows),
                       meta))
    return packed


def pack_buckets_columnar(decoded, cfg: ItemConfig):
    """Vectorized per-item packing straight from a columnar decode
    (a DecodedRows whose keys are the item-key column): grouping,
    local-coordinate assignment, in-row duplicate combining, shape bucketing
    and the padded array fill are all numpy array ops — no per-record Python
    (the reference's per-reducer dataset build, ItemModelTrain.java:219-238,
    at native speed)."""
    if decoded.keys is None:
        raise ValueError("decode was not run with the item key column")
    lambda_map = dict(cfg.lambda_map or {})
    pm_map = dict(cfg.intercept_prior_mean_map or {})

    keys_arr = np.asarray(decoded.keys, dtype=object)
    uniq_keys, item_of_row = np.unique(keys_arr.astype(str),
                                       return_inverse=True)
    N = len(item_of_row)
    n_items = len(uniq_keys)
    rows_per_item = np.bincount(item_of_row, minlength=n_items)

    # row slot within its item, preserving original row order
    row_order = np.argsort(item_of_row, kind="stable")
    slot = np.empty(N, np.int64)
    item_starts = np.searchsorted(item_of_row[row_order],
                                  np.arange(n_items + 1))
    slot[row_order] = (np.arange(N, dtype=np.int64)
                       - item_starts[item_of_row[row_order]])

    rs = decoded.row_start
    nnz_per_row = (rs[1:] - rs[:-1]).astype(np.int64)
    row_of_nnz = np.repeat(np.arange(N, dtype=np.int64), nnz_per_row)
    feat = decoded.feat_id[: rs[-1]].astype(np.int64)
    vals = decoded.feat_val[: rs[-1]].astype(np.float64)

    # combine duplicate features within a row (LibLinearDataset combines
    # repeated nameterm entries additively)
    ord2 = np.lexsort((feat, row_of_nnz))
    r_s, f_s, v_s = row_of_nnz[ord2], feat[ord2], vals[ord2]
    if len(r_s):
        new_g = np.empty(len(r_s), bool)
        new_g[0] = True
        new_g[1:] = (r_s[1:] != r_s[:-1]) | (f_s[1:] != f_s[:-1])
        gid = np.cumsum(new_g) - 1
        n_groups = int(gid[-1]) + 1
        val_g = np.zeros(n_groups, np.float64)
        np.add.at(val_g, gid, v_s)
        row_g = r_s[new_g]
        feat_g = f_s[new_g]
    else:
        row_g = feat_g = np.zeros(0, np.int64)
        val_g = np.zeros(0, np.float64)
    item_g = item_of_row[row_g]

    # unique (item, global-feature) pairs -> local ids 1..F_i-1 (0=intercept)
    V = max(len(decoded.vocab_names), 1)
    pair_key = item_g * V + feat_g
    uniq_pairs, pair_inv = np.unique(pair_key, return_inverse=True)
    pair_item = (uniq_pairs // V).astype(np.int64)
    pair_feat = (uniq_pairs % V).astype(np.int64)
    pair_item_start = np.searchsorted(pair_item, np.arange(n_items + 1))
    local_of_group = 1 + (pair_inv
                          - pair_item_start[item_g]).astype(np.int64)
    nfeat_per_item = 1 + np.diff(pair_item_start)

    # k slot within the row (0 = intercept), via group rank within row
    if len(row_g):
        row_change = np.empty(len(row_g), bool)
        row_change[0] = True
        row_change[1:] = row_g[1:] != row_g[:-1]
        row_start_pos = np.flatnonzero(row_change)
        kpos = (np.arange(len(row_g), dtype=np.int64)
                - np.repeat(row_start_pos, np.diff(
                    np.append(row_start_pos, len(row_g)))) + 1)
        distinct_per_row = np.bincount(row_g, minlength=N)
    else:
        kpos = np.zeros(0, np.int64)
        distinct_per_row = np.zeros(N, np.int64)

    kmax_per_item = np.ones(n_items, np.int64)
    np.maximum.at(kmax_per_item, item_of_row, 1 + distinct_per_row)

    # per-global-feature lambda.map vector (built once, O(V))
    lam_of_global = np.full(V, np.nan)
    if lambda_map:
        name_to_gid = {n: i for i, n in enumerate(decoded.vocab_names)}
        for gname, lam in lambda_map.items():
            gi = name_to_gid.get(gname)
            if gi is not None:
                lam_of_global[gi] = lam

    buck = lambda x: _bucket_dim(int(x))  # noqa: E731
    R_i = np.asarray([buck(r) for r in rows_per_item], np.int64)
    K_i = np.asarray([buck(k) for k in kmax_per_item], np.int64)
    F_i = np.asarray([buck(f) for f in nfeat_per_item], np.int64)
    shape_key = (R_i << 42) | (K_i << 21) | F_i
    uniq_shapes, shape_inv = np.unique(shape_key, return_inverse=True)

    names_global = decoded.vocab_names
    resp = decoded.response
    w_in = decoded.weight.astype(np.float64)
    off_in = decoded.offset.astype(np.float64)
    y_all = np.where(resp == 1, 1.0, -1.0)
    if cfg.positive_weight != 1.0:
        w_in = np.where(resp == 1, w_in * cfg.positive_weight, w_in)

    packed = []
    for s_i, skey in enumerate(uniq_shapes):
        R = int(skey >> 42)
        K = int((skey >> 21) & ((1 << 21) - 1))
        F = int(skey & ((1 << 21) - 1))
        members = np.flatnonzero(shape_inv == s_i)          # item ids
        I = len(members)
        local_item = np.full(n_items, -1, np.int64)
        local_item[members] = np.arange(I)

        indices = np.zeros((I, R, K), np.int32)
        values = np.zeros((I, R, K), np.float32)
        y = np.ones((I, R), np.float32)
        weight = np.zeros((I, R), np.float32)
        offset = np.zeros((I, R), np.float32)
        prior_mean = np.zeros((I, F), np.float64)
        map_mask = np.zeros((I, F), bool)
        map_pvi = np.ones((I, F), np.float64)
        nrows = rows_per_item[members].astype(np.int32)
        pad_mask = (np.arange(F)[None, :]
                    >= nfeat_per_item[members][:, None])

        # rows of member items
        rmask = local_item[item_of_row] >= 0
        ri = local_item[item_of_row[rmask]]
        rsl = slot[rmask]
        y[ri, rsl] = y_all[rmask]
        weight[ri, rsl] = w_in[rmask]
        offset[ri, rsl] = off_in[rmask]
        # intercept slot k=0, local col 0, value 1
        values[ri, rsl, 0] = 1.0

        # nonzero groups of member items
        gmask = local_item[item_g] >= 0
        gi_ = local_item[item_g[gmask]]
        indices[gi_, slot[row_g[gmask]], kpos[gmask]] = \
            local_of_group[gmask].astype(np.int32)
        values[gi_, slot[row_g[gmask]], kpos[gmask]] = \
            val_g[gmask].astype(np.float32)

        # per-(item, local-feature) lambda.map entries
        pmask = local_item[pair_item] >= 0
        pi = local_item[pair_item[pmask]]
        plocal = 1 + (np.arange(len(pair_item), dtype=np.int64)
                      - pair_item_start[pair_item])[pmask]
        plam = lam_of_global[pair_feat[pmask]]
        has = ~np.isnan(plam)
        map_mask[pi[has], plocal[has]] = True
        map_pvi[pi[has], plocal[has]] = plam[has]

        meta = []
        for i, it in enumerate(members):
            key = str(uniq_keys[it])
            lo, hi = pair_item_start[it], pair_item_start[it + 1]
            names = [INTERCEPT_NAME] + [names_global[g]
                                        for g in pair_feat[lo:hi]]
            prior_mean[i, 0] = pm_map.get(key,
                                          cfg.intercept_default_prior_mean)
            meta.append((key, names))

        packed.append(((R, K, F),
                       dict(indices=indices, values=values, y=y,
                            weight=weight, offset=offset,
                            prior_mean=prior_mean, map_mask=map_mask,
                            map_pvi=map_pvi, pad_mask=pad_mask, nrows=nrows),
                       meta))
    return packed


def train_item_models(keyed_rows: Mapping[str, Sequence[Mapping]],
                      config: ItemConfig, mesh=None,
                      device="cuda") -> ItemResult:
    return _train_packed(_pack_buckets_rows(keyed_rows, config), config,
                         mesh=mesh, device=device)


def train_item_models_columnar(decoded, config: ItemConfig, mesh=None,
                               device="cuda") -> ItemResult:
    """Per-item training straight from a columnar decode (see
    pack_buckets_columnar)."""
    return _train_packed(pack_buckets_columnar(decoded, config), config,
                         mesh=mesh, device=device)


class _NewtonLoop:
    """The Cholesky route's bucket solve as branches over a static state,
    looped by ops/device_loop.py: newton_cholesky without the host. Its
    Newton state, running mask and step are made here from the first
    inputs; `set_inputs` writes the Newton init in place and chooses the
    first phase on the device. A pass takes BACKTRACK, FINISH, STEP:

      STEP       the Newton step (NewtonSolver.step), then BACKTRACK while
                 a lane's Armijo trial is open, else FINISH;
      BACKTRACK  one Armijo trial, then again or FINISH;
      FINISH     accept, gradient and stop test, the next running mask,
                 then STEP while a lane runs, else 0 (stop)."""

    BACKTRACK, FINISH, STEP = 1, 2, 3

    def __init__(self, solver: NewtonSolver, w0, eps):
        self.solver = solver
        self.phase = torch.zeros((), dtype=torch.int32, device=w0.device)
        self.ns = ns = _materialize(solver.init(w0, eps))
        self.lanes = _materialize(solver.running(ns))
        # the step's tensors, of the types `step` writes into them
        self.bs = NewtonStep(
            s=torch.zeros_like(ns.w), gs=torch.zeros_like(ns.gnorm),
            t=torch.zeros_like(ns.gnorm), fn=torch.zeros_like(ns.f),
            k=torch.zeros_like(ns.it), lanes=self.lanes.clone())
        self.loop: DeviceLoop | None = None

    def state(self) -> list[torch.Tensor]:
        return [self.lanes, *self.ns, *self.bs]

    def own_loop(self, pool=None) -> DeviceLoop:
        self.loop = DeviceLoop(
            [(self.BACKTRACK, "backtrack", self.bt_trip),
             (self.FINISH, "newton_finish", self.finish),
             (self.STEP, "newton_step", self.step)],
            self.phase, self.state(), _SOLVE_KERNELS, pool=pool)
        return self.loop

    def _next(self, cond, yes, no):
        self.phase.copy_(torch.where(cond, yes, no))

    def _next_trip(self):
        self.lanes.copy_(self.solver.running(self.ns))
        self._next(self.lanes.any(), self.STEP, 0)

    def set_inputs(self, w0, eps) -> None:
        """The solve's inputs, written in place (eager, no host read)."""
        _assign(self.ns, self.solver.init(w0, eps))
        self._next_trip()

    # -- branches ---------------------------------------------------------
    def step(self):
        _assign(self.bs, self.solver.step(self.ns, self.lanes))
        self._next(self.solver.bt_open(self.ns, self.bs), self.BACKTRACK,
                   self.FINISH)

    def bt_trip(self):
        _assign(self.bs, self.solver.bt_trip(self.ns, self.bs))
        self._next(self.solver.bt_open(self.ns, self.bs), self.BACKTRACK,
                   self.FINISH)

    def finish(self):
        _assign(self.ns, self.solver.finish(self.ns, self.bs))
        self._next_trip()

    # -- results ----------------------------------------------------------
    def w(self) -> torch.Tensor:
        return self.ns.w

    def trips(self) -> torch.Tensor:
        """(1,) int64: the lock-step Newton trips."""
        return self.ns.trips[None]

    def close(self) -> None:
        if self.loop is not None:
            self.loop.close()


def _solve_bucket(prob: obj.LRProblem, w0: torch.Tensor, eps_t,
                  cfg: ItemConfig, pool=None) -> _Solved:
    """One bucket's (grid x item) solve as one device loop: `prob` its
    problem (data blocks (I, ...), priors (P, F) for the P = G*I lanes),
    w0 (P, F) the start (0 for every lane: ItemModelTrain's initParam is
    null), eps_t (P,) the tolerances. On the card the loop is captured
    into `pool` and launched once; the host reads nothing. The
    host-driven newton_cholesky / tron (one read a trip) take this seam's
    place where a caller holds the loop to them."""
    t0 = time.monotonic()
    P, F = w0.shape
    if cfg.solver == "cholesky":
        lp = _NewtonLoop(NewtonSolver(prob, min(cfg.max_newton_iter, 100)),
                         w0, eps_t)
    else:
        I = prob.y.shape[0]
        G = P // I

        def grid3(t):
            return t.reshape(-1, I, F).expand(G, I, F)
        lp = _SolveLoop("lanes", [(prob, (0, I))], G, F, False,
                        cfg.max_newton_iter, cfg.max_cg_iter, w0,
                        None, None, eps_t.view(G, I)[0],
                        prior=(grid3(prob.prior_mean),
                               grid3(prob.prior_var_inv)))
    lp.own_loop(pool).prepare()
    capture_s = time.monotonic() - t0
    if cfg.solver == "cholesky":
        lp.set_inputs(w0, eps_t)
        lp.loop.run()
        return _Solved(lp.w(), lp.trips(), capture_s, lp)
    lp.solve(w0, None, None, eps_t.view(G, I)[0])
    return _Solved(lp.x().reshape(P, F), lp.lockstep_trips(), capture_s, lp)


def _train_packed(packed, config: ItemConfig, mesh=None,
                  device="cuda") -> ItemResult:
    cfg = config
    if mesh is not None:
        device = mesh_device(mesh)
    if cfg.solver not in ("cholesky", "tron"):
        raise ValueError(f"unknown solver {cfg.solver!r}")
    dev = resolve_device(device)
    dtype = cfg.dtype
    lambda_map = dict(cfg.lambda_map or {})
    trip_names = (("newton_trips",) if cfg.solver == "cholesky"
                  else ("newton_trips", "cg_trips"))

    grid = [(il, dl) for il in cfg.intercept_lambdas
            for dl in cfg.default_lambdas]
    G = len(grid)

    def on_dev(a, dt=dtype):
        # without a blocking copy: a bucket's one sync is its read
        return _to_device(np.asarray(a), dt, dev)

    il_arr = on_dev([g[0] for g in grid])
    dl_arr = on_dev([g[1] for g in grid])
    pool = _graph_pool(dev)     # every bucket's loop captures into it

    models: dict[str, LinearModel] = {}
    posterior: dict[str, LinearModel] = {}
    covs: dict[str, dict] = {} if (cfg.compute_var and cfg.full_cov) else None
    stats: list[dict] = []

    with contextlib.ExitStack() as loops:
        for (R, K, F), arrs, meta in packed:
            t_start = time.monotonic()
            I_all = I = len(meta)
            if mesh is not None:
                # items shard like blocks: pad with copies of item 0 (real,
                # solvable, discarded), then this rank's contiguous share
                W = axis_size(mesh, BLOCK_AXIS)
                I_pad = -(-I // W) * W
                sh = block_sharding(mesh, 0)
                arrs = {k: sh.take(np.concatenate(
                    [v, np.broadcast_to(v[:1], (I_pad - I,) + v.shape[1:])]))
                    for k, v in arrs.items()}
                I = I_pad // W
            eps = cfg.liblinear_epsilon * obj.class_balance_eps_scale(
                arrs["y"], arrs["nrows"])
            # prior precision per grid point g and item i: pvi[0] = il_g;
            # pvi[f] = the lambda.map override, else dl_g; padding lanes 1
            map_mask = on_dev(arrs["map_mask"], torch.bool)
            pad_mask = on_dev(arrs["pad_mask"], torch.bool)
            pvi = torch.where(map_mask[None], on_dev(arrs["map_pvi"])[None],
                              dl_arr[:, None, None].expand(G, I, F))
            pvi[:, :, 0] = il_arr[:, None]
            pvi = torch.where(pad_mask[None], torch.ones_like(pvi), pvi)

            def per_grid(a, dt=dtype):
                """(I, ...) host array -> (G*I, ...) device tensor, grid-major:
                every grid point solves the same data."""
                t = on_dev(a, dt)
                return t[None].expand(G, *t.shape).reshape(G * I, *t.shape[1:])

            # the items' data once, shared by the G grid points' lanes
            prob = blocked_problem(
                on_dev(arrs["indices"], torch.int64), on_dev(arrs["values"]),
                on_dev(arrs["y"]), on_dev(arrs["weight"]),
                on_dev(arrs["offset"]), (None,) * 8, dtype, F)._replace(
                prior_mean=per_grid(arrs["prior_mean"]),
                prior_var_inv=pvi.reshape(G * I, F))
            w0 = torch.zeros((G * I, F), dtype=dtype, device=dev)
            solved = _solve_bucket(prob, w0, per_grid(eps), cfg, pool=pool)
            # torch frees a graph pool with the last graph captured into it:
            # the previous bucket's loop is closed now that this one is
            # captured into the pool, and the last one after the call
            loops.close()
            if solved.loop is not None:
                loops.callback(solved.loop.close)
            w_t, trips = solved.w, solved.trips
            if mesh is not None:      # the bucket's trips: the slowest rank's
                trips = all_reduce(trips, "max", mesh.get_group(BLOCK_AXIS))

            def items(t, *tail):
                """(G*I, ...) -> (G, I_all, ...): under a mesh every rank's
                items gathered in order, the padding dropped."""
                t = t.reshape(G, I, *tail)
                if mesh is not None:
                    t = all_gather(t, mesh.get_group(BLOCK_AXIS),
                                   dim=1)[:, :I_all]
                return t
            out = [items(w_t, F)]
            if cfg.compute_var:
                if cfg.full_cov:
                    # inv_ex: the inverse without inv's check of its info on
                    # the host (H is positive definite)
                    cov_t = torch.linalg.inv_ex(
                        obj.dense_hessian(prob, w_t))[0]
                    out += [items(torch.diagonal(cov_t, dim1=-2, dim2=-1), F),
                            items(cov_t, F, F)]
                else:
                    out.append(items(1.0 / obj.hessian_diagonal(prob, w_t), F))
            # the bucket's one host read: w, variances, covariances, trips
            host = torch.cat([t.reshape(-1).to(torch.float64)
                              for t in (*out, trips)]).cpu()
            parts = host.split([t.numel() for t in (*out, trips)])
            w = parts[0].view(G, I_all, F).numpy()
            pvar = parts[1].view(G, I_all, F).numpy() if cfg.compute_var \
                else None
            cov = (parts[2].view(G, I_all, F, F).numpy()
                   if cfg.compute_var and cfg.full_cov else None)
            stats.append({"shape": (R, K, F), "problems": G * I_all,
                          **dict(zip(trip_names, parts[-1].long().tolist())),
                          "capture_s": solved.capture_s})
            t_solved = time.monotonic()

            # plain Python floats from here on: one tolist() per array instead
            # of a numpy scalar lookup per coefficient
            w, pvar = w.tolist(), (pvar.tolist() if cfg.compute_var else None)
            cov = None if cov is None else cov.tolist()
            for g, (il, dl) in enumerate(grid):
                prefix = f"{_lambda_key(il)}:{_lambda_key(dl)}#"
                for i, (key, names) in enumerate(meta):
                    out_key = prefix + key
                    nf = len(names)
                    wi = w[g][i]
                    models[out_key] = LinearModel(
                        dict(zip(names[1:], wi[1:nf])), intercept=wi[0])
                    if cfg.compute_var:
                        pvi_ = pvar[g][i]
                        pv = dict(zip(names[1:], pvi_[1:nf]))
                        # absent lambda.map features report prior variance
                        # (LibLinear.java:385-396)
                        for k, lam_k in lambda_map.items():
                            if k not in pv:
                                pv[k] = 1.0 / lam_k
                        posterior[out_key] = LinearModel(pv, intercept=pvi_[0])
                        if cfg.full_cov:
                            ci = cov[g][i]
                            covs[out_key] = {
                                (names[a], names[b]): ci[a][b]
                                for a in range(nf) for b in range(nf)}
                    else:
                        posterior[out_key] = LinearModel()
            stats[-1].update(solve_s=t_solved - t_start,
                             assemble_s=time.monotonic() - t_solved)

    return ItemResult(models=models, posterior_var=posterior,
                      covariances=covs, solver_stats=stats)


def write_item_models(path: str, result: ItemResult,
                      intercept_key: str = INTERCEPT_NAME) -> None:
    """Write LinearModelWithVarAvro records (ItemModelTrain.java:264-273)."""
    from mlease_tpu_torch.io import avro, schemas

    records = []
    for key, model in result.models.items():
        records.append({
            "key": key,
            "model": model.to_avro(intercept_key),
            "posteriorVar": result.posterior_var[key].to_avro(intercept_key),
        })
    avro.write_records(path, schemas.LINEAR_MODEL_WITH_VAR, records)


# Full posterior covariance persistence. The reference computes the full
# Laplace covariance (LibLinear.java:317-327, getPostVarMatrixMap) but never
# writes it to disk; this schema fills that gap: row-major covariance over
# the listed feature order (intercept first).
COVARIANCE_SCHEMA = {
    "type": "record",
    "name": "LinearModelCovarianceAvro",
    "namespace": "com.linkedin.mlease.avro",
    "fields": [
        {"name": "key", "type": "string"},
        {"name": "features", "type": {"type": "array", "items": "string"}},
        {"name": "cov", "type": {"type": "array", "items": "float"}},
    ],
}


def write_item_covariances(path: str, result: ItemResult,
                           intercept_key: str = INTERCEPT_NAME) -> None:
    if result.covariances is None:
        raise ValueError("train with compute_var=True, full_cov=True")
    from mlease_tpu_torch.io import avro

    records = []
    for key, cov in result.covariances.items():
        internal = [INTERCEPT_NAME] + list(result.models[key].coefficients)
        display = [intercept_key] + internal[1:]
        flat = [float(cov.get((a, b), 0.0))
                for a in internal for b in internal]
        records.append({"key": key, "features": display, "cov": flat})
    avro.write_records(path, COVARIANCE_SCHEMA, records)


def read_item_covariances(path: str):
    """-> {key: (names list, cov ndarray (F, F))}."""
    import numpy as _np

    from mlease_tpu_torch.io import avro

    out = {}
    for rec in avro.read_records(path):
        names = list(rec["features"])
        F = len(names)
        out[rec["key"]] = (names,
                           _np.asarray(rec["cov"],
                                       _np.float64).reshape(F, F))
    return out
