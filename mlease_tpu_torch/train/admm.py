"""Consensus-ADMM trainer, ported to PyTorch.

Port of mlease_tpu/train/admm.py (reference:
src/main/java/com/linkedin/mlease/regression/jobs/RegressionAdmmTrain.java:129-522).
One iteration is the same program as the JAX step: x-update, presence
mask, optional over-relaxation, consensus means, z-update and dual update;
the host driver loop carries the scalar schedules, sample loglik,
best-model tracking and the stop rule.

The x-update takes one of the JAX package's three solves (`solver_mode`):

  flat       the default: the multi-RHS lambda path (ops/tron_multi.py)
             over the B blocks folded into one stacked problem, one joint
             trust region per lambda, the strictest block's tolerance;
  per_block  flat_blocks=False, or pcg="head_block", or a B*n or B*R past
             int32: the same stacked data solved as B independent problems
             (tron_multi(blocks=B), the JAX vmap over blocks), each block
             with its own tolerance; with "head_block" each block's head
             Gram is built by K2. Where the stacked ids of all B blocks
             would pass int32, the blocks are stacked and solved in
             consecutive sub-stacks (ops/tron_multi.py::SubStacks), one
             tron_multi(blocks=b) each: the blocks share nothing, so this
             is the same solve, and K1's ids stay int32;
  lanes      multi_rhs=False, or dual_layout: the batched reference TRON
             (ops/tron.py) over L*B lanes whose data is shared by the L
             lambdas (stride-0 views, never copied), the JAX
             vmap(vmap(tron)); dual_layout adds the column-sorted copy. Its
             problem is built from the blocked arrays, each block with its
             own int64 ids: nothing is stacked.

The data problem is built once when the trainer is built (the JAX step
restacks it inside its jitted program); each step only sets the prior.

`mesh=` (parallel/mesh.py::make_mesh) runs the trainer on every rank of a
torch.distributed block mesh, one process per rank: each rank pads the
block axis to a multiple of the mesh, keeps its contiguous range of blocks
(never the flat solve: the blocks keep their own problems, as the JAX
package's mesh path keeps its vmap axis), and the consensus is one
all_reduce(SUM) of the (2, L, n) partial sums per iteration, padded blocks
masked out. z is replicated; every rank returns the same result (u gathered
to (L, B, n), the trips the maxima over the ranks).

`run()` takes each x-update as the JAX step's jitted program takes it,
on the device without the host: `_SolveLoop`, the solve's branches over a
static state, looped on the card by ops/device_loop.py (a CUDA graph
captured at the trainer's first iteration and kept), one host read an
iteration. `run_fused` runs the whole driver loop on the device
(`_FusedRun`: the same solve branches beside the iteration's), in every
solve mode and under a mesh, where its two collectives are NCCL calls
captured into the loop's graphs. `build_x_update` and `build_admm_step`
are the host-driven forms (one host read a Newton and a CG trip), which
the loops are held to.

`dtype=torch.bfloat16` runs every solve mode and run_fused as the JAX
package runs it: data, z, u and the solver state in bfloat16, K1's bf16
entry, the objective and every scatter-add summed in float32, and the
scalar inner tolerance rounded to bfloat16 before it scales eps_scale, as
the JAX package's weakly typed product rounds it.
"""

from __future__ import annotations

import logging
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, NamedTuple, Sequence

import numpy as np
import torch
import torch.utils._pytree as pytree

from mlease_tpu_torch.core.dataset import (BlockedData, csc_arrays, pack_rows,
                                           to_hybrid)
from mlease_tpu_torch.core.linear_model import LinearModel
from mlease_tpu_torch.device import resolve_device
from mlease_tpu_torch.ops import admm_math
from mlease_tpu_torch.ops.objective import (K1Streams, LRProblem,
                                            class_balance_eps_scale,
                                            with_sorted_streams)
from mlease_tpu_torch.ops.tron import LaneSolver, tron
from mlease_tpu_torch.ops.device_loop import DeviceClock, DeviceLoop
from mlease_tpu_torch.ops.gram import gram_batched
from mlease_tpu_torch.ops.head_pass import head_xtv, head_xv
from mlease_tpu_torch.ops.segment_sum import (accumulate_dtype,
                                              segment_sum_sorted)
from mlease_tpu_torch.ops.tron_multi import (MultiProblem, MultiSolver,
                                             SubStacks, lanes_major,
                                             stack_fits, stack_substacks,
                                             substacks_of, tron_multi,
                                             with_prior)
from mlease_tpu_torch.collectives import all_gather, all_reduce, max_over
from mlease_tpu_torch.parallel.mesh import (BLOCK_AXIS, axis_size,
                                            block_sharding, local_blocks,
                                            mesh_device)
from mlease_tpu_torch.utils import profiling

logger = logging.getLogger(__name__)

MAX_NTEST_EVENTS = 1_000_000  # RegressionAdmmTrain.java:122


@dataclass
class AdmmConfig:
    """Mirrors the reference's job-file keys (README.md:179-205); the fields
    and defaults of mlease_tpu's AdmmConfig, with torch dtypes."""

    lambdas: Sequence[float] = (1.0,)
    rhos: Sequence[float] | None = None
    num_iters: int = 10
    regularizer: int = 2
    epsilon: float = 1e-4
    liblinear_epsilon: float = 0.01
    aggressive_liblinear_epsilon_decay: bool = False
    penalize_intercept: bool = False
    initialize_boost_rate: float = 0.0
    rho_adapt_coefficient: float = 0.0
    num_click_replicates: int = 1
    test_loglik_per_iter: bool = False
    lambda_map: Mapping[str, float] | None = None
    positive_weight: float = 1.0
    reference_l1_compat: bool = True
    relaxation: float = 1.0
    dual_layout: bool = False     # CSC gather-based X'v (the "lanes" solve)
    head_size: int = 0
    multi_rhs: bool = True        # False: the batched reference TRON lanes
    pcg: Any = True               # True/"jacobi", False, or "head_block"
    head_dtype: Any = None        # storage dtype of the dense head
    flat_blocks: bool = True      # False: the per-block lock-step solve
    dtype: Any = torch.float32
    max_newton_iter: int = 1000
    max_cg_iter: int = 500
    inner_eps_floor: float = 1e-5

    def resolved_rhos(self) -> list[float]:
        if self.rhos is not None:
            if len(self.rhos) != len(self.lambdas):
                raise ValueError(
                    "The number of rho's should be exactly the same as the "
                    "number of lambda's. OR: don't claim rho!")
            return [float(r) for r in self.rhos]
        return [admm_math.default_rho(l) for l in self.lambdas]


@dataclass
class AdmmResult:
    models: dict[str, LinearModel]                 # final z per lambda
    best_model: LinearModel | None
    best_lambda: str | None
    best_loglik: float
    iterations: int
    sample_loglik_history: list[dict]              # [{lambda, iter, testLoglik}]
    diff_history: list[dict[str, float]]
    z: np.ndarray                                  # (L, n) final consensus
    u: np.ndarray                                  # (L, B, n) final duals
    converged: bool
    wall_time: float = 0.0
    compile_time: float = 0.0   # run_fused: warm-up and capture, not in wall
    loop_counts: dict = field(default_factory=dict)  # run_fused: what ran
    iter_times: list[float] = field(default_factory=list)  # seconds/iteration
    solver_stats: list[dict] = field(default_factory=list)  # per-iteration
    # {"newton_trips": int, "cg_trips": int} lock-step loop-trip counts


def _lambda_key(lam: float) -> str:
    """Reference model keys are Java Float.toString of the (float) lambda
    ("1.0", "0.5", "1.0E-4", "1.2345678E7"): plain decimal for
    1e-3 <= |v| < 1e7, computerized scientific notation otherwise, always
    with at least one fractional digit (RegressionAdmmTrain.java:561 keys
    via String.valueOf(float)). Digits are the shortest float32 round-trip
    (Dragon4), matching modern Java; the reference-era FloatingDecimal
    differs only on a handful of pathological subnormals. A copy of
    mlease_tpu's: the keys must be byte-identical."""
    f = np.float32(lam)
    if np.isnan(f):
        return "NaN"
    if np.isinf(f):
        return "Infinity" if f > 0 else "-Infinity"
    sign = "-" if np.signbit(f) else ""
    if f == 0:
        return sign + "0.0"
    sci = np.format_float_scientific(abs(f), unique=True, trim="0")
    mant, _, exp_s = sci.partition("e")
    e = int(exp_s)
    digits = mant.replace(".", "").rstrip("0") or "0"
    if -3 <= e < 7:
        if e >= 0:
            ipart = digits[:e + 1].ljust(e + 1, "0")
            fpart = digits[e + 1:] or "0"
        else:
            ipart = "0"
            fpart = "0" * (-e - 1) + digits
        return f"{sign}{ipart}.{fpart}"
    fpart = digits[1:] or "0"
    return f"{sign}{digits[0]}.{fpart}E{e}"


def solver_mode(multi_rhs: bool, flat_blocks: bool, dual_layout: bool,
                pcg: Any, mesh=None, fits: bool = True) -> str:
    """Which x-update solve a configuration takes, as the JAX trainers
    decide it (AdmmTrainer._use_flat, build_admm_step): "lanes" for
    multi_rhs=False or dual_layout, "flat" when the blocks may fold into
    one problem (never under a mesh: the blocks keep their own problems
    there; never when `fits` is false, the stacked ids past int32:
    ops/tron_multi.py::stack_fits), "per_block" otherwise ("head_block"
    needs a per-block head)."""
    if not multi_rhs or dual_layout:
        return "lanes"
    if flat_blocks and pcg != "head_block" and mesh is None and fits:
        return "flat"
    return "per_block"


def blocked_problem(indices, values, y, weight, offset, head, dtype, n,
                    csc=None, k1=None) -> LRProblem:
    """The LRProblem the batched `tron` solves, straight from the blocked
    arrays ((B, ...) each, as stack_blocks takes them; `head` its 8-tuple
    with head_ids (H,) shared; n columns): every block keeps its own ids,
    int64, so nothing is stacked and no id nears int32; the priors left
    unset; a narrow head widened to the compute dtype (the JAX package's
    solve promotes it the same way); `csc` the (cols, rows, vals) dual
    layout, each (B, R*K), made on the card when not given. On the card the
    sorted streams' K1 ids (`k1`, objective.K1Streams) are made here when
    not given, once, over the sub-stacks that keep them inside int32
    (objective.with_sorted_streams)."""
    (head_x, head_ids, t_rows, t_cols, t_vals,
     tc_rows, tc_cols, tc_vals) = head
    B = y.shape[0]

    def ids(a):
        return None if a is None else a.long()

    kw = {}
    if head_x is not None:
        kw = dict(head_x=head_x.to(dtype),
                  head_ids=head_ids.long()[None].repeat(B, 1),
                  tail_rows=ids(t_rows), tail_cols=ids(t_cols),
                  tail_vals=t_vals, tail_c_rows=ids(tc_rows),
                  tail_c_cols=ids(tc_cols), tail_c_vals=tc_vals)
    prob = LRProblem(indices=indices.long(), values=values, y=y,
                     weight=weight, offset=offset, prior_mean=None,
                     prior_var_inv=None, **kw)
    # on the card X'v sums over the column-sorted copy with K1, in one
    # order every run (ops/objective.py::_sorted_sum)
    return with_sorted_streams(prob, n, csc, k1)


def stacked_k1(prob: MultiProblem, B: int, csc=None) -> K1Streams:
    """The K1 ids of a stacked problem's B blocks, one range: its stacked
    ids as they are (stack_blocks offsets rows by R and columns by n, as
    K1Streams does), with `csc` the stacked (cols, rows, vals) copy."""
    def pair(seg, idx):
        return None if seg is None else (
            seg.reshape(B, -1).to(torch.int32),
            idx.reshape(B, -1).to(torch.int32))
    return K1Streams(((0, B),), csc=None if csc is None else pair(*csc[:2]),
                     tail=pair(prob.tail_rows, prob.tail_cols),
                     tail_c=pair(prob.tail_c_cols, prob.tail_c_rows))


def unstack_problem(prob: MultiProblem, B: int, n: int, dtype,
                    csc_perm=None) -> LRProblem:
    """A stacked problem (stack_blocks: B blocks of R rows and n columns,
    ids offset) back to its blocks, as blocked_problem builds them: ids
    un-offset. On the card the stacked int32 ids are already K1's
    (K1Streams over the one range of all B); `csc_perm`, the column order
    of the stacked ELL entries (train/streaming.py::_column_order), gives
    the column-sorted copy."""
    R = prob.y.shape[0] // B
    K = prob.indices.shape[-1]
    boff = torch.arange(B, device=prob.y.device)[:, None]

    def ids(a, size):
        return None if a is None else a.reshape(B, -1).long() - boff * size

    def per_block(a):
        return None if a is None else a.reshape(B, -1)

    head = (None,) * 8
    if prob.head_x is not None:
        hx = prob.head_x if prob.head_x.dim() == 3 else prob.head_x[None]
        head = (hx, ids(prob.head_ids, n)[0], ids(prob.tail_rows, R),
                ids(prob.tail_cols, n), per_block(prob.tail_vals),
                ids(prob.tail_c_rows, R), ids(prob.tail_c_cols, n),
                per_block(prob.tail_c_vals))
    csc = None
    if csc_perm is not None:
        csc = (prob.indices.reshape(-1).index_select(0, csc_perm),
               csc_perm // K,
               prob.values.reshape(-1).index_select(0, csc_perm))
    k1 = stacked_k1(prob, B, csc) if prob.y.is_cuda else None
    if csc is not None:
        csc = (ids(csc[0], n), ids(csc[1], R), per_block(csc[2]))
    return blocked_problem(
        prob.indices.reshape(B, R, K).long() - boff[..., None] * n,
        prob.values.reshape(B, R, K), prob.y.reshape(B, R),
        prob.weight.reshape(B, R), prob.offset.reshape(B, R), head, dtype, n,
        csc, k1)


def x_prior(z: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Each block's prior mean z - u_b, (L, B, n)."""
    return z[:, None, :] - u


def multi_problem(prob: MultiProblem, mode: str, B: int) -> MultiProblem:
    """The stacked problem as the multi-RHS solve of `mode` takes it: a
    one-block per-block solve gets its head unbatched."""
    if B == 1 and mode == "per_block" and prob.head_x is not None \
            and prob.head_x.dim() == 3:
        return prob._replace(head_x=prob.head_x[0])
    return prob


def w_to_x(w: torch.Tensor, B: int, n: int) -> torch.Tensor:
    """A multi-RHS solution (B*n, L) as the (L, B, n) x-update (a view)."""
    return w.reshape(B, n, w.shape[1]).permute(2, 0, 1)


def _to_device(a, dtype, device) -> torch.Tensor:
    """A host number, list or array as a tensor of `dtype` on `device`,
    rounded on the host; on the card staged through page-locked memory and
    copied without a blocking copy (the copy is ordered on the current
    stream)."""
    t = torch.as_tensor(a, dtype=dtype)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _rho_table(rhos, last: int, config: AdmmConfig, boosted: bool,
               device) -> torch.Tensor:
    """rho_eff of iterations 0..last, (last + 1, L) on the device (row i
    from admm_math.rho_effective at max(i, 1)), without a blocking
    copy."""
    boost = config.initialize_boost_rate if boosted else 0.0
    return _to_device([
        [admm_math.rho_effective(
            r, max(i, 1), initialize_boost_rate=boost,
            rho_adapt_coefficient=config.rho_adapt_coefficient)
         for r in rhos] for i in range(last + 1)], config.dtype, device)


def _graph_pool(device):
    """A CUDA graph memory pool for one trainer's device loops (None off
    the card)."""
    return torch.cuda.graph_pool_handle() if device.type == "cuda" else None


def _close_loops(loops: dict) -> None:
    """Free the graphs of a trainer's _SolveLoops (they run no more)."""
    for lp in loops.values():
        lp.close()
    loops.clear()


def build_x_update(mode: str, max_newton_iter: int, max_cg_iter: int,
                   pcg: Any = True, relaxation: float = 1.0) -> Callable:
    """The (lambda x block) x-update of one set of blocks, without the
    consensus: solve(prob, present, z, u, rho_eff, eps) -> (x (L, B, n),
    trips) for present (B, n) bool, z (L, n), u (L, B, n), rho_eff (L,) and
    eps (B,) the blocks' tolerances; x is masked to the prior mean z - u_b
    where a feature is absent from block b and over-relaxed. `prob` is the
    blocks' stacked MultiProblem ("flat", "per_block") or their LRProblem
    ("lanes"), or a SubStacks of either ("per_block", "lanes"): each
    sub-stack solved in turn on its blocks. trips is a (k, 2) array of
    (Newton, CG) counts: one row for "flat", one per block for "per_block"
    (each block's own loops), one per (lambda, block) lane for "lanes"
    (accepted Newton iterations and CG iterations), as the JAX solves
    report them."""
    if mode not in ("flat", "per_block", "lanes"):
        raise ValueError(f"unknown solver mode {mode!r}")

    def solve(prob, present, z, u, rho_eff, eps):
        if isinstance(prob, SubStacks):
            parts = [solve(p, present[b0:b1], z, u[:, b0:b1], rho_eff,
                           eps[b0:b1])
                     for p, (b0, b1) in zip(prob.probs, prob.ranges)]
            return (torch.cat([x for x, _ in parts], 1),
                    np.concatenate([t for _, t in parts]))
        L, n = z.shape
        B = u.shape[1]
        prior_mean = x_prior(z, u)                            # (L, B, n)
        if mode == "lanes":
            P = L * B
            lanes = prob._replace(
                prior_mean=prior_mean.reshape(P, n),
                prior_var_inv=rho_eff[:, None, None].expand(L, B, n)
                .reshape(P, n))
            r = tron(lanes, z[:, None, :].expand(L, B, n).reshape(P, n),
                     eps.repeat(L), max_iter=max_newton_iter,
                     max_cg_iter=max_cg_iter)
            x = r.w.view(L, B, n)
            trips = torch.stack([r.iterations, r.cg_iterations],
                                1).cpu().numpy()
        else:
            blocks = B if mode == "per_block" else 1
            r = tron_multi(with_prior(multi_problem(prob, mode, B),
                                      prior_mean, rho_eff),
                           z.T.repeat(B, 1),
                           eps if blocks > 1 else eps.min(),
                           max_iter=max_newton_iter, max_cg_iter=max_cg_iter,
                           precondition=pcg, blocks=blocks)
            x = w_to_x(r.w, B, n)
            trips = r.block_trips
        return finish(x, present, prior_mean, z), trips

    def finish(x, present, prior_mean, z):
        # absent-feature exactness: features with no data in block b solve
        # to the prior mean z - u_b (LibLinear.java:373-397)
        x = torch.where(present[None, :, :], x, prior_mean)
        if relaxation != 1.0:
            # over-relaxation x_hat = alpha*x + (1-alpha)*z, post-masking
            # (Boyd et al. 2011 section 3.4.3; off, alpha = 1, by default)
            x = relaxation * x + (1.0 - relaxation) * z[:, None, :]
        return x

    solve.finish = finish
    return solve


def build_admm_step(nblocks: int, regularizer: int, intercept_index: int | None,
                    penalize_intercept: bool, reference_l1_compat: bool,
                    max_newton_iter: int, max_cg_iter: int,
                    relaxation: float = 1.0, mode: str = "flat",
                    pcg: Any = False, group=None) -> Callable:
    """Build the one-iteration function.

    step(prob, present, z, u, lam_vec, rho_eff, rho_base, eps,
    block_valid=None) takes the data problem of `mode` (see
    build_x_update), present (B, n) bool, z (L, n), u (L, B, n), lam_vec
    (L, n), rho_eff/rho_base (L,) and eps (B,); it returns (z_new, u_new,
    diffs (L,), stats) with stats the "newton_trips"/"cg_trips" maxima over
    the solve's counters, as the JAX trainer's loop reads them.

    With `group` (the block group of a mesh) the B blocks are this rank's
    share of the `nblocks` real ones: the partial sums of x and u are one
    all_reduce(SUM) over the group and the trip maxima one all_reduce(MAX),
    so every rank gets the same z. block_valid (B,) bool masks padded
    blocks out of the sums (torch.where, so a NaN in one cannot leak) and
    keeps their duals at 0. `step.solve` is the x-update (build_x_update)
    and `step.consensus(x, z, u, lam_vec, rho_base, block_valid)` the rest
    of the iteration, on the device; `step` reads the trip maxima to the
    host."""
    if regularizer not in (1, 2):
        raise ValueError("Only L1 and L2 regularization supported!")
    solve = build_x_update(mode, max_newton_iter, max_cg_iter, pcg,
                           relaxation)

    def consensus(x, z, u, lam_vec, rho_base, block_valid=None):
        """The consensus, z-update, dual update and diffs of an x-update
        (L, B, n), all on the device: (z_new, u_new, diffs (L,)). A
        bfloat16 run forms the z- and dual updates in float32 and rounds
        z and u once each (ops/tron_multi.py's rule; a bfloat16
        N rho / (lambda + N rho) is 0.24% off at lambda 1 and moves a
        lane's fixed point); float32 and float64 in their own type."""
        dtype = z.dtype
        acc = accumulate_dtype(dtype)
        if block_valid is not None:
            bv = block_valid[None, :, None]
            x = torch.where(bv, x, torch.zeros_like(x))
        # consensus means over real blocks only; under a mesh this is the
        # one collective replacing meanModel (RegressionAdmmTrain.java:362-364)
        sums = torch.stack([x.sum(1), u.sum(1)])             # (2, L, n)
        if group is not None:
            all_reduce(sums, "sum", group)
        v = (sums[0] / nblocks + sums[1] / nblocks).to(acc)   # xbar + ubar
        # rho_eff (boost/decay-adapted) shapes only the x-subproblem prior;
        # the consensus z-update uses the base rho
        # (RegressionAdmmTrain.java:368-380, :648-658)
        rho = rho_base[:, None].to(acc)
        lam_vec = lam_vec.to(acc)
        if regularizer == 2:
            z_new = admm_math.z_update_l2(v, lam_vec, rho, nblocks,
                                          intercept_index, penalize_intercept)
        else:
            z_new = admm_math.z_update_l1(
                v, lam_vec, rho, nblocks, intercept_index, penalize_intercept,
                reference_compat=reference_l1_compat)
        z_new = z_new.to(dtype)
        u_new = admm_math.u_update(u.to(acc), x.to(acc),
                                   z_new[:, None, :].to(acc)).to(dtype)
        if block_valid is not None:
            u_new = torch.where(bv, u_new, torch.zeros_like(u_new))
        diffs = admm_math.max_abs_diff(z_new, z, axis=-1)
        return z_new, u_new, diffs

    def step(prob, present, z, u, lam_vec, rho_eff, rho_base, eps,
             block_valid=None):
        x, trips = solve(prob, present, z, u, rho_eff, eps)
        z_new, u_new, diffs = consensus(x, z, u, lam_vec, rho_base,
                                        block_valid)
        trip_max = trips.max(0)
        if group is not None:
            trip_max = max_over(trip_max, group, z.device)
        stats = {"newton_trips": int(trip_max[0]),
                 "cg_trips": int(trip_max[1])}
        return z_new, u_new, diffs, stats

    step.solve = solve
    step.consensus = consensus
    return step


def sample_loglik_lanes(indices, values, y, weight, offset,
                        z: torch.Tensor) -> torch.Tensor:
    """Per-lambda mean weighted test loglik of consensus models z (L, n)
    (RegressionAdmmTrain.java:766-811):
    sum_i w_i * -log1p(exp(-+xbeta)) / sum_i w_i."""
    scores = (values[None] * z[:, indices]).sum(-1) + offset[None]
    yz = -y[None] * scores
    ll = -torch.logaddexp(yz.new_zeros(()), yz) * weight[None]
    return ll.sum(1) / weight.sum()


class AdmmTrainer:
    """The in-memory trainer. `mesh`: a 1-D block mesh
    (parallel/mesh.py::make_mesh); every rank of it builds the trainer from
    the whole host data and runs it (the device is then the mesh's: this
    rank's card, or the CPU of a gloo mesh). `data` then stays the rank's
    own blocks, padded."""

    def __init__(self, data: BlockedData, vocab, config: AdmmConfig,
                 test_rows: Sequence[Mapping] | None = None,
                 device: str | torch.device = "cuda", mesh=None):
        self.mesh = mesh
        if mesh is not None:
            device = mesh_device(mesh)
        self.device = dev = resolve_device(device)
        self.vocab = vocab
        self.config = config
        self.nblocks = data.nblocks      # real block count (the divisor)
        dtype = config.dtype

        if config.head_size > 0 and data.head is None:
            data = to_hybrid(data, config.head_size)
        self.block_valid = None
        self._group = None
        if mesh is not None:
            # the whole host data on every rank (the head ids are the full
            # data's), padded to the mesh; this rank keeps its own blocks
            data, valid = local_blocks(mesh, data)
            self.block_valid = torch.as_tensor(valid, device=dev)
            self._group = mesh.get_group(BLOCK_AXIS)
        self.data = data
        self.dim = data.dim
        self.lambdas = [float(l) for l in config.lambdas]
        self.rhos = config.resolved_rhos()

        def t(a, dt=None):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

        y = t(data.y, dtype)
        weight = t(data.weight, dtype)
        if config.positive_weight != 1.0:
            weight = torch.where(y == 1, config.positive_weight * weight,
                                 weight)
        self.present = t(data.present)
        # per-block class-balance tolerance factors (LibLinear.java:309-313)
        self.eps_scale = t(class_balance_eps_scale(data.y, data.nrows), dtype)

        head = (None,) * 8
        if data.head is not None:
            head_dtype = (config.head_dtype if config.head_dtype is not None
                          else dtype)
            head = (t(data.head, head_dtype), t(data.head_ids),
                    t(data.tail_rows), t(data.tail_cols),
                    t(data.tail_vals, dtype), t(data.tail_c_rows),
                    t(data.tail_c_cols), t(data.tail_c_vals, dtype))
        L = len(self.lambdas)
        self.mode = solver_mode(
            config.multi_rhs, config.flat_blocks, config.dual_layout,
            config.pcg, mesh,
            fits=stack_fits(data.nblocks, self.dim, data.padded_rows))
        arrays = (t(data.indices), t(data.values, dtype), y, weight,
                  t(data.offset, dtype), head)
        if self.mode == "lanes":
            csc = None
            if config.dual_layout:
                csc = tuple(t(a) for a in csc_arrays(data))
                csc = (csc[0], csc[1], csc[2].to(dtype))
            self.prob = blocked_problem(*arrays, dtype, self.dim, csc)
        else:
            # "flat" only while all B fit int32; "per_block" past it solves
            # consecutive sub-stacks (a SubStacks)
            self.prob = stack_substacks(
                *arrays,
                torch.zeros((L, data.nblocks, self.dim), dtype=dtype,
                            device=dev),
                torch.ones(L, dtype=dtype, device=dev))

        lam_vecs = np.stack([
            admm_math.per_feature_lambda(l, self.dim, config.lambda_map,
                                         vocab, dtype=np.float64)
            for l in self.lambdas])
        self.lam_vec = t(lam_vecs, dtype)

        # the solve's settings as `step` takes them, for its device loop
        self._solve_args = (config.pcg, config.max_newton_iter,
                            config.max_cg_iter)
        self._loops: dict[str, _SolveLoop] = {}   # freed with the trainer
        weakref.finalize(self, _close_loops, self._loops).atexit = False
        # run()'s clock: the x-update loop's branches and launch, and the
        # data passes' head (and its kernels' or torch's products' share)
        # and K1 parts (and K1's bf16 entry's share; ops/tron_multi.py)
        self.clock = DeviceClock(self.device, (
            "head_pass", "head_fused", "head_gemm", "tail_pass",
            "tail_bf16"))
        self.step = build_admm_step(
            nblocks=self.nblocks,
            regularizer=config.regularizer,
            intercept_index=vocab.intercept_index,
            penalize_intercept=config.penalize_intercept,
            reference_l1_compat=config.reference_l1_compat,
            max_newton_iter=config.max_newton_iter,
            max_cg_iter=config.max_cg_iter,
            relaxation=config.relaxation,
            mode=self.mode,
            pcg=config.pcg,
            group=self._group)

        # sample-test loglik arrays (first MAX_NTEST_EVENTS rows)
        self.test_arrays = None
        if test_rows:
            blk = pack_rows(list(test_rows)[:MAX_NTEST_EVENTS], vocab)
            self.test_arrays = (t(blk.indices), t(blk.values, dtype),
                                t(blk.y, dtype), t(blk.weight, dtype),
                                t(blk.offset, dtype))

    # ------------------------------------------------------------------
    def sample_loglik(self, z: torch.Tensor) -> np.ndarray:
        return sample_loglik_lanes(*self.test_arrays, z).to(
            torch.float64).cpu().numpy()

    def run_fused(self, z0: np.ndarray | None = None, *,
                  checkpoint_every: int | None = None,
                  callback: Callable | None = None) -> AdmmResult:
        """The whole ADMM driver loop on the device, run() without the host
        in the loop: the inner-eps ladder, the rho schedule (a table made
        on the host by admm_math.rho_effective, put on the device once),
        the stop rule, the per-iteration sample loglik and best-model
        tracking, as the JAX package's run_fused (one lax.while_loop per
        checkpoint chunk). On a CUDA device the loop is a CUDA graph that
        loops on the card (ops/device_loop.py): one launch and one blocking
        read per chunk, none inside it. On the CPU the same branches run
        eagerly. Either way the result is run()'s, bit for bit: the same
        ops on the same values in the same order.

        checkpoint_every=None runs the whole training as one chunk;
        checkpoint_every=C pauses every C iterations to call
        callback(iteration=, z=, u=, diffs=, inner_eps=, logliks=) with the
        latest state (z and u copies on the device, u gathered over a
        mesh's ranks as run() gives it, each loglik entry delivered once).
        compile_time holds the warm-up and capture seconds, which wall_time
        leaves out; iter_times is wall / iterations per iteration and
        solver_stats one entry of the trip totals (the sums of the
        per-iteration maxima); loop_counts what the loop ran
        (DeviceLoop.counts: branch executions, and on the card the K1, K2
        and all_reduce executions counted on the card). The loop's graphs
        and state are freed before run_fused returns.

        Every solve mode runs (flat, per-block and its sub-stacks,
        head-block, the lanes solve with or without the dual layout), and
        under a mesh every rank runs the loop over its own blocks: its two
        collectives a step are NCCL calls captured into the graphs on the
        card (a gloo group there cannot be captured: ValueError), eager
        gloo calls on the CPU. The stop rule reads only all-reduced values,
        so the ranks stop together; one all_reduce after the run checks
        that they did."""
        cfg = self.config
        if self.mesh is not None and self.device.type == "cuda":
            backend = torch.distributed.get_backend(self._group)
            if backend != "nccl":
                raise ValueError(
                    f"run_fused on a CUDA device captures the mesh's "
                    f"collectives into CUDA graphs, which needs NCCL; this "
                    f"mesh's group runs {backend!r}: use run()")
        L, max_it = len(self.lambdas), cfg.num_iters
        track_ll = self.test_arrays is not None and cfg.test_loglik_per_iter

        t0 = time.monotonic()
        st = _FusedRun(self, z0, track_ll)
        loop = st.loop
        try:
            loop.prepare()
            if st.on_card:
                torch.cuda.synchronize(self.device)
            compile_time = time.monotonic() - t0
            t_start = time.monotonic()
            chunk = (max_it if checkpoint_every is None
                     else max(int(checkpoint_every), 1))
            it_now, done, seen_ll = 1, False, 0
            while not done and it_now <= max_it:
                st.start_chunk(min(it_now + chunk - 1, max_it))
                loop.run()
                it_now = int(st.it)          # the chunk's one blocking read
                done = bool(st.done)
                if callback is None:
                    continue
                diffs_row = st.diffs_h[it_now - 1].to(torch.float64)
                logliks = None
                if track_ll:
                    ll_chunk = st.ll_h.to(torch.float64).cpu().numpy()
                    logliks = [
                        {"lambda": _lambda_key(lam), "iter": i,
                         "testLoglik": float(ll)}
                        for i in range(seen_ll + 1, it_now)
                        for lam, ll in zip(self.lambdas, ll_chunk[i])]
                    seen_ll = it_now - 1
                callback(iteration=it_now - 1, z=st.z.clone(),
                         u=self._global_u(st.u).clone(),
                         diffs=diffs_row.cpu().numpy(),
                         inner_eps=float(st.inner_eps), logliks=logliks)
            diffs_np = st.diffs_h.to(torch.float64).cpu().numpy()
            wall = time.monotonic() - t_start
            loop_counts = loop.counts()
        finally:
            loop.close()
            st.x_update.close()
        iterations = it_now - 1
        if self._group is not None:
            # the ranks stopped together: the same iteration on every rank
            its = torch.tensor([it_now, -it_now], dtype=torch.int64,
                               device=self.device)
            lo_hi = all_reduce(its, "max", self._group).tolist()
            if lo_hi[0] != -lo_hi[1]:
                raise RuntimeError(
                    f"run_fused: the mesh's ranks stopped at iterations "
                    f"{-lo_hi[1] - 1} to {lo_hi[0] - 1}")

        ll_np = st.ll_h.to(torch.float64).cpu().numpy()
        loglik_history: list[dict] = []
        if z0 is not None and track_ll:
            for lam, ll in zip(self.lambdas, self.sample_loglik(st.z0)):
                loglik_history.append({"lambda": _lambda_key(lam), "iter": 0,
                                       "testLoglik": float(ll)})
        diff_history = []
        for i in range(1, iterations + 1):
            diff_history.append({_lambda_key(lam): float(d) for lam, d
                                 in zip(self.lambdas, diffs_np[i])})
            if track_ll:
                for lam, ll in zip(self.lambdas, ll_np[i]):
                    loglik_history.append({"lambda": _lambda_key(lam),
                                           "iter": i,
                                           "testLoglik": float(ll)})
        best_model = best_lambda = None
        best_loglik = float(st.best_ll)
        if track_ll and best_loglik > -9999998.0:
            best_model = LinearModel.from_dense(
                st.best_z.to(torch.float64).cpu().numpy(), self.vocab)
            best_lambda = _lambda_key(self.lambdas[int(st.best_lam)])
        else:
            best_loglik = -9999999.0
        z_np = st.z.to(torch.float64).cpu().numpy()
        models = {
            _lambda_key(lam): LinearModel.from_dense(z_np[i], self.vocab)
            for i, lam in enumerate(self.lambdas)}
        return AdmmResult(
            models=models, best_model=best_model, best_lambda=best_lambda,
            best_loglik=best_loglik, iterations=iterations,
            sample_loglik_history=loglik_history, diff_history=diff_history,
            iter_times=[wall / max(iterations, 1)] * iterations,
            solver_stats=[{"newton_trips": int(st.nt_tot),
                           "cg_trips": int(st.cg_tot)}],
            z=z_np,
            u=self._global_u(st.u).to(torch.float64).cpu().numpy(),
            converged=done, wall_time=wall, compile_time=compile_time,
            loop_counts=loop_counts)

    # ------------------------------------------------------------------
    def _solve_loop(self, z, u, rho_eff, eps, **kw) -> "_SolveLoop":
        """This trainer's x-update as a _SolveLoop, its first state made
        from these inputs."""
        pcg, max_newton_iter, max_cg_iter = self._solve_args
        return _SolveLoop(self.mode, substacks_of(self.prob,
                                                  self.data.nblocks),
                          len(self.lambdas), self.dim, pcg, max_newton_iter,
                          max_cg_iter, z, u, rho_eff, eps, **kw)

    def _x_update(self, z, u, rho_eff, eps):
        """run()'s x-update through the trainer's _SolveLoop (made, and on
        the card captured, at the trainer's first iteration, then kept for
        every later one): (x (L, B, n), its (k, 2) (Newton, CG) trips), on
        the device."""
        loop = self._loops.get("x")
        if loop is None:
            loop = self._solve_loop(z, u, rho_eff, eps)
            loop.own_loop(_graph_pool(self.device), self.clock,
                          "x").prepare()
            self._loops["x"] = loop
        loop.solve(z, u, rho_eff, eps)
        x = self.step.solve.finish(loop.x(), self.present, x_prior(z, u), z)
        return x, loop.trips()

    def run(self, z0: np.ndarray | None = None,
            u0: np.ndarray | None = None, *, start_iteration: int = 1,
            inner_eps0: float | None = None, mindiff0: float = 99999999.0,
            best_loglik0: float = -9999999.0,
            callback: Callable | None = None) -> AdmmResult:
        """Run the driver loop.

        Each iteration is the JAX step's program on the device: the
        x-update through the trainer's _SolveLoop (on the card one launch
        of a CUDA graph that loops until every solve has stopped; captured
        at the trainer's first iteration and kept), then the consensus,
        z- and u-updates. The host reads the device once an iteration:
        the diffs, the trip maxima and the tracked sample logliks, in one
        copy (the JAX run()'s one sync at the diffs). rho_eff and eps
        reach the device without a blocking copy. Bit for bit what
        `step` (the host-driven solve) gives.

        z0/u0/start_iteration/inner_eps0/mindiff0/best_loglik0 resume from a
        checkpoint (utils/checkpoint, or a JAX run's state through
        mlease_tpu_torch.convert) — the analogue of restarting from the
        reference's iter-i/ HDFS state. The callback receives z and u as
        tensors on the trainer's device; under a mesh u0 is the global
        (L, B, n) (each rank takes its slice) and the callback's u is the
        global one, gathered over the ranks (every rank must take part)."""
        cfg = self.config
        L, n = len(self.lambdas), self.dim
        dtype, dev = cfg.dtype, self.device

        z = (torch.zeros((L, n), dtype=dtype, device=dev) if z0 is None
             else torch.as_tensor(np.broadcast_to(z0, (L, n)).copy(),
                                  dtype=dtype, device=dev))
        B_all = self.data.nblocks * (1 if self.mesh is None else axis_size(
            self.mesh, BLOCK_AXIS))
        u_np = np.zeros((L, B_all, n))
        if u0 is not None:
            u_np[:, :u0.shape[1], :] = np.asarray(u0)
        if self.mesh is not None:
            u_np = block_sharding(self.mesh, 1).take(u_np)
        u = torch.as_tensor(u_np, dtype=dtype, device=dev)

        inner_eps = (cfg.liblinear_epsilon if inner_eps0 is None
                     else float(inner_eps0))
        mindiff = mindiff0
        best_loglik = best_loglik0
        best_z: torch.Tensor | None = None
        best_lambda: str | None = None
        loglik_history: list[dict] = []
        diff_history: list[dict[str, float]] = []
        iter_times: list[float] = []
        solver_stats: list[dict] = []
        converged = False
        track_ll = self.test_arrays is not None and cfg.test_loglik_per_iter
        t_start = time.monotonic()

        # iteration-0 loglik when warm-started (RegressionAdmmTrain.java:277-280)
        if z0 is not None and track_ll:
            for lam, ll in zip(self.lambdas, self.sample_loglik(z)):
                loglik_history.append({"lambda": _lambda_key(lam), "iter": 0,
                                       "testLoglik": float(ll)})

        rho_base = torch.as_tensor(self.rhos, dtype=dtype, device=dev)
        rho_tab = _rho_table(self.rhos, cfg.num_iters, cfg, z0 is not None,
                             dev)
        consensus = self.step.consensus
        iteration = start_iteration - 1
        run_id = profiling.new_run()
        for iteration in range(start_iteration, cfg.num_iters + 1):
            t_iter = time.monotonic()
            inner_eps = admm_math.inner_eps_schedule(
                inner_eps, iteration, mindiff,
                aggressive=cfg.aggressive_liblinear_epsilon_decay)
            rho_eff = rho_tab[iteration]

            # the span the device idle share of an iteration is read over
            # (chip_smoke.py phase 21), with the trainer's clock on
            with profiling.span("admm_iteration", run=run_id,
                                iteration=iteration), self.clock.active():
                self.clock.idle_stamp()
                # the scalar rounded to the compute dtype first (as
                # run_fused)
                eps = _to_device(inner_eps, dtype, dev) * self.eps_scale
                x, trips = self._x_update(z, u, rho_eff, eps)
                z, u, diffs = consensus(x, z, u, self.lam_vec, rho_base,
                                        self.block_valid)
                trip_max = trips.amax(0).to(torch.int64)
                if self._group is not None:
                    all_reduce(trip_max, "max", self._group)
                read = [diffs, trip_max]
                if track_ll:
                    read.append(sample_loglik_lanes(*self.test_arrays, z))
                # the iteration's one host sync, the clock's slots beside
                host = self.clock.read(read)
            diffs_np = host[:L].numpy()
            lls = host[L + 2:].numpy()
            iter_times.append(time.monotonic() - t_iter)
            solver_stats.append({"newton_trips": int(host[L]),
                                 "cg_trips": int(host[L + 1])})
            mindiff = float(diffs_np.min())
            maxdiff = float(diffs_np.max())
            diff_history.append({_lambda_key(l): float(d)
                                 for l, d in zip(self.lambdas, diffs_np)})
            logger.info("iter %d: inner_eps=%g maxdiff=%g mindiff=%g (%.2fs)",
                        iteration, inner_eps, maxdiff, mindiff,
                        iter_times[-1])

            iter_logliks = None
            if track_ll:
                iter_logliks = []
                for li, (lam, ll) in enumerate(zip(self.lambdas, lls)):
                    ll = float(ll)
                    entry = {"lambda": _lambda_key(lam), "iter": iteration,
                             "testLoglik": ll}
                    loglik_history.append(entry)
                    iter_logliks.append(entry)
                    # best-model tracking (RegressionAdmmTrain.java:812-845)
                    if ll > best_loglik:
                        best_loglik = ll
                        best_lambda = _lambda_key(lam)
                        best_z = z[li].clone()

            if callback is not None:
                callback(iteration=iteration, z=z, u=self._global_u(u),
                         diffs=diffs_np, inner_eps=inner_eps,
                         logliks=iter_logliks)

            if admm_math.should_stop(maxdiff, inner_eps, cfg.epsilon,
                                     cfg.inner_eps_floor):
                converged = True
                break

        with profiling.span("admm_epilogue", run=run_id):
            z_np = z.to(torch.float64).cpu().numpy()
            models = {
                _lambda_key(lam): LinearModel.from_dense(z_np[i], self.vocab)
                for i, lam in enumerate(self.lambdas)}
            best_model = (None if best_z is None else LinearModel.from_dense(
                best_z.to(torch.float64).cpu().numpy(), self.vocab))
            u_np = self._global_u(u).to(torch.float64).cpu().numpy()
        return AdmmResult(
            models=models, best_model=best_model, best_lambda=best_lambda,
            best_loglik=best_loglik, iterations=iteration,
            sample_loglik_history=loglik_history, diff_history=diff_history,
            iter_times=iter_times, solver_stats=solver_stats,
            z=z_np, u=u_np,
            converged=converged, wall_time=time.monotonic() - t_start)

    def _global_u(self, u: torch.Tensor) -> torch.Tensor:
        """The (L, nblocks, n) duals: under a mesh every rank's blocks,
        gathered in block order, the padding dropped."""
        if self.mesh is not None:
            u = all_gather(u, self._group, dim=1)
        return u[:, :self.nblocks]


class _Part:
    """One solve of an x-update inside a device loop, over the blocks
    [b0, b1): the multi-RHS solve of a stacked problem (flat, per-block,
    or one sub-stack of a SubStacks) through MultiSolver, or the lanes
    solve through ops/tron.py's LaneSolver. Its priors, Newton state,
    running mask and CG state are static tensors, made here from the
    first inputs (z, u, rho_eff, eps), which `set_priors`, `init` and the
    loop's branches write in place with run()'s ops. `prior`: a fixed
    (prior mean, prior precision) of all the loop's blocks, each (L, B, n)
    (an expanded view will do), in place of z - u and rho_eff (the naive
    and item trainers' priors); u and rho_eff are then unused. `group`:
    the feature shards' process group of a multi-RHS solve whose columns
    are sharded (MultiSolver's, the feature-sharded trainer's)."""

    def __init__(self, mode: str, prob, b0: int, b1: int, L: int, n: int,
                 pcg, max_newton_iter: int, max_cg_iter: int,
                 z, u, rho_eff, eps, prior=None, group=None):
        self.L, self.n = L, n
        self.b0, self.b1 = b0, b1
        self.lanes = mode == "lanes"
        B = b1 - b0
        if self.lanes:
            self.prob = prob
            self.blocks = B
        else:
            self.blocks = B if mode == "per_block" else 1
            self.prob = multi_problem(prob, mode, B)
        self.fixed = prior is not None
        if self.fixed:
            pm, pvi = (t[:, b0:b1] for t in prior)
            # the (L*B, n) lanes or the lanes-major (L, B*n) multi-RHS
            # priors: the values tron and tron_multi are given
            pm, pvi = ((pm.reshape(L * B, n), pvi.reshape(L * B, n))
                       if self.lanes else
                       (pm.reshape(L, B * n), pvi.reshape(L, B * n)))
        else:
            pm, pvi = self._priors(z, u, rho_eff)
        self.pm, self.pvi = _materialize(pm), _materialize(pvi)
        if self.lanes:
            self.solver = LaneSolver(
                prob._replace(prior_mean=self.pm, prior_var_inv=self.pvi),
                max_newton_iter, max_cg_iter)
        else:
            self.solver = MultiSolver(
                self.prob._replace(prior_mean=self.pm,
                                   prior_var_inv=self.pvi),
                L, pcg, self.blocks, max_newton_iter, max_cg_iter, group)
        self.ns = _materialize(self._init_state(z, eps))
        self.running = _materialize(self.solver.running(self.ns))
        self.cs = _materialize(self.solver.cg_init(self.ns, self.running))

    def _priors(self, z, u, rho_eff):
        """(prior mean, prior precision) as run()'s solve sets them."""
        u = u[:, self.b0:self.b1]
        if self.lanes:
            L, B, n = u.shape
            return (x_prior(z, u).reshape(L * B, n),
                    rho_eff[:, None, None].expand(L, B, n).reshape(L * B, n))
        pl = lanes_major(with_prior(self.prob, x_prior(z, u), rho_eff))
        return pl.prior_mean, pl.prior_var_inv

    def _init_state(self, z, eps):
        eps = eps[self.b0:self.b1]
        if self.lanes:
            # z (L, n), every block's lanes starting from it, or the
            # (L*B, n) lanes' own starts
            L, n, B = self.L, self.n, self.blocks
            return self.solver.init(
                z.reshape(L, -1, n).expand(L, B, n).reshape(L * B, n),
                eps.repeat(L))
        return self.solver.init(z.T.repeat(self.b1 - self.b0, 1),
                                eps if self.blocks > 1 else eps.min())

    def state(self) -> list[torch.Tensor]:
        return [self.pm, self.pvi, self.running, *_leaves(self.ns),
                *_leaves(self.cs)]

    def shares_shapes(self, other: "_Part") -> bool:
        """The same state layout: every tensor of one shape and dtype."""
        mine, theirs = self._tree(), other._tree()
        return (mine[1] == theirs[1] and len(mine[0]) == len(theirs[0])
                and all((a is None) == (b is None) and (
                    a is None or (a.shape == b.shape and a.dtype == b.dtype))
                    for a, b in zip(mine[0], theirs[0])))

    def _tree(self):
        return pytree.tree_flatten((self.pm, self.pvi, self.running,
                                    self.ns, self.cs))

    def adopt(self, other: "_Part") -> None:
        """Take over `other`'s state tensors (shares_shapes): two solves
        run one after another keep one state."""
        self.pm, self.pvi = other.pm, other.pvi
        self.running, self.ns, self.cs = other.running, other.ns, other.cs
        self.solver.prob = self.solver.prob._replace(
            prior_mean=self.pm, prior_var_inv=self.pvi)

    def set_priors(self, z, u, rho_eff) -> None:
        if self.fixed:
            return
        pm, pvi = self._priors(z, u, rho_eff)
        self.pm.copy_(pm)
        self.pvi.copy_(pvi)

    def init(self, z, eps) -> None:
        _assign(self.ns, self._init_state(z, eps))
        self.running.copy_(self.solver.running(self.ns))

    def x(self) -> torch.Tensor:
        """The solve's x, (L, b1 - b0, n), before masking."""
        if self.lanes:
            return self.ns.w.view(self.L, -1, self.n)
        return w_to_x(self.ns.W.reshape(self.L, -1).T, self.b1 - self.b0,
                      self.n)

    def trips(self) -> torch.Tensor:
        """(k, 2) (Newton, CG) counts, as run()'s solve reports them."""
        if self.lanes:
            return torch.stack([self.ns.it - 1, self.ns.cg_total], 1)
        return self.solver.block_trips(self.ns)

    def lockstep_trips(self) -> torch.Tensor:
        """(2,) int64: the solve's lock-step Newton and CG trips, as
        tron and tron_multi report them."""
        if self.lanes:
            return self.solver.lockstep_trips(self.ns)
        return torch.stack([self.ns.trips, self.ns.cg_trips])


# the kernels a solve launches, counted on the card inside a device loop
_SOLVE_KERNELS = {"segment_sum_gather": segment_sum_sorted,
                  "gram_batched": gram_batched, "head_xv": head_xv,
                  "head_xtv": head_xtv}


class _SolveLoop:
    """One x-update, build_x_update's solve without its mask and
    relaxation, as branches over a static state: the counterpart of the
    JAX step's jitted solve, whose TRON loops are lax.while_loops.

    It has one part (`_Part`) per solve: the one stacked or lanes
    solve, or one per sub-stack of a SubStacks (`probs`, the
    [(problem, (b0, b1))] of substacks_of), solved in turn; each has
    three branches, CG_START (its cg_init), CG (one cg_trip) and EPILOGUE
    (the Newton epilogue and its next running mask), at phases first +
    3k + (2, 0, 1). `set_inputs(z, u, rho_eff, eps)` runs eagerly: every
    part's priors z - u and Newton init written in place, then the first
    phase chosen on the device (no host read). After it and after each
    EPILOGUE the phase goes to the CG_START of the first part, from that
    one on, whose Newton loop still runs, else to `after`: 0 stops a loop
    of its own, and AdmmTrainer.run_fused's loop goes on to the end of
    its iteration. `x()` and `trips()` are device tensors.

    `own_loop(pool, clock, name)` makes the loop of its own (`loop`, an
    ops/device_loop.DeviceLoop over the branches CG and EPILOGUE of each
    part, then CG_START of each; on the card captured once, into `pool`,
    at `prepare`; timed by the trainer's `clock` under `name`). `share`:
    loops of the same trainer; where one's parts
    keep state of the same layout, this one takes over its state tensors
    (the two solve one after another, never at once). `prior`: a fixed
    prior mean and precision for every part (_Part), the naive trainer's
    and the item trainer's TRON buckets', which then pass None for u and
    rho_eff and zeros (or the lanes' own starts) for z. `group`: a
    multi-RHS solve's feature shards (_Part): every dot, norm and Xv of
    the branches is then an all_reduce over it, which the loop of its own
    captures into the branches on the card (NCCL; DeviceLoop's
    "thread_local" capture), as run_fused's loop captures a mesh's."""

    def __init__(self, mode: str, probs, L: int, n: int, pcg,
                 max_newton_iter: int, max_cg_iter: int, z, u, rho_eff,
                 eps, *, first: int = 1, after: int = 0, phase=None,
                 share: Sequence["_SolveLoop"] = (), prior=None,
                 group=None):
        self.first, self.after = first, after
        self.group = group
        self.phase = (torch.zeros((), dtype=torch.int32, device=z.device)
                      if phase is None else phase)
        self.parts = [_Part(mode, p, b0, b1, L, n, pcg, max_newton_iter,
                            max_cg_iter, z, u, rho_eff, eps, prior, group)
                      for p, (b0, b1) in probs]
        for other in share:
            if len(other.parts) == len(self.parts) and all(
                    a.shares_shapes(b) for a, b in zip(self.parts,
                                                       other.parts)):
                for a, b in zip(self.parts, other.parts):
                    a.adopt(b)
                break
        self.loop: DeviceLoop | None = None
        many = len(self.parts) > 1

        def name(base, k):
            return f"{base}.{k}" if many else base

        self.cg_branches, self.init_branches = [], []
        for k in range(len(self.parts)):
            self.cg_branches += [
                (self._cg(k), name("cg_trip", k), self._branch(self.cg_trip, k)),
                (self._epi(k), name("newton_epilogue", k),
                 self._branch(self.epilogue, k))]
            self.init_branches.append((self._cgs(k), name("cg_init", k),
                                       self._branch(self.cg_init, k)))

    def state(self) -> list[torch.Tensor]:
        return [t for part in self.parts for t in part.state()]

    def state_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.state())

    def close(self) -> None:
        """Free the loop's graphs and drop the branches, which refer back
        to this object, so that its state and problem go with the last
        reference to it."""
        if self.loop is not None:
            self.loop.close()
        self.cg_branches, self.init_branches = [], []

    def own_loop(self, pool=None, clock=None, name="x") -> DeviceLoop:
        kernels = (_SOLVE_KERNELS if self.group is None
                   else dict(_SOLVE_KERNELS, all_reduce=all_reduce))
        self.loop = DeviceLoop(self.cg_branches + self.init_branches,
                               self.phase, self.state(), kernels, pool=pool,
                               clock=clock, name=name)
        return self.loop

    # part k's phases: CG, EPILOGUE, CG_START
    def _cg(self, k):
        return self.first + 3 * k

    def _epi(self, k):
        return self.first + 1 + 3 * k

    def _cgs(self, k):
        return self.first + 2 + 3 * k

    @staticmethod
    def _branch(fn, k):
        return lambda: fn(k)

    def _next(self, cond, yes, no):
        self.phase.copy_(torch.where(cond, yes, no))

    def _next_part(self, k):
        """The CG_START of the first part from k on whose Newton loop runs,
        else `after`."""
        nxt = self.after
        for j in reversed(range(k, len(self.parts))):
            nxt = torch.where(self.parts[j].running.any(), self._cgs(j), nxt)
        self.phase.copy_(nxt)

    def set_inputs(self, z, u, rho_eff, eps) -> None:
        """The solve's inputs, written in place (eager, no host read)."""
        for part in self.parts:
            part.set_priors(z, u, rho_eff)
            part.init(z, eps)
        self._next_part(0)

    # -- branches ---------------------------------------------------------
    def cg_init(self, k):
        part = self.parts[k]
        _assign(part.cs, part.solver.cg_init(part.ns, part.running))
        self._next(part.solver.cg_open(part.cs), self._cg(k), self._epi(k))

    def cg_trip(self, k):
        part = self.parts[k]
        _assign(part.cs, part.solver.cg_trip(part.ns, part.cs))
        self._next(part.solver.cg_open(part.cs), self._cg(k), self._epi(k))

    def epilogue(self, k):
        part = self.parts[k]
        _assign(part.ns, part.solver.epilogue(part.ns, part.cs))
        part.running.copy_(part.solver.running(part.ns))
        self._next_part(k)

    # -- results ----------------------------------------------------------
    def x(self) -> torch.Tensor:
        """The x-update before masking, (L, B, n): views of the state (the
        next set_inputs overwrites them)."""
        if len(self.parts) > 1:
            return torch.cat([p.x() for p in self.parts], 1)
        return self.parts[0].x()

    def trips(self) -> torch.Tensor:
        """(k, 2) (Newton, CG) counts, as build_x_update's solve reports
        them."""
        return torch.cat([p.trips() for p in self.parts])

    def lockstep_trips(self) -> torch.Tensor:
        """(2,) int64: the lock-step Newton and CG trips, the maxima over
        the parts (as ops/tron_multi.py::join_block_results joins
        sub-stacks)."""
        return torch.stack([p.lockstep_trips() for p in self.parts]).amax(0)

    def solve(self, z, u, rho_eff, eps) -> None:
        """set_inputs, then the loop (one graph launch on the card)."""
        self.set_inputs(z, u, rho_eff, eps)
        self.loop.run()


class _Solved(NamedTuple):
    """A one-shot solve of the naive or the item trainer (train/naive.py::
    _solve_keys, train/item.py::_solve_bucket): its solution and lock-step
    trips ((1,) Newton, or (2,) Newton and CG; int64), on the device; the
    seconds of its loop's warm-up and capture; the loop, to close after the
    caller's read (None for a solve without one)."""

    w: torch.Tensor
    trips: torch.Tensor
    capture_s: float = 0.0
    loop: Any = None


class _FusedRun:
    """run_fused's static state and the branches of its device loop.

    Every tensor here is made before the loop; each branch reads and
    writes only these (the solvers' states copied in place) and sets the
    next phase. The x-update is a `_SolveLoop` (one part per solve, each
    with its three branches) whose phases start at 3 and which goes on to
    ITER_END when no part's Newton loop runs. A pass of the loop takes the
    branches in the order CG and EPILOGUE of each part, ITER_END,
    ITER_START, CG_START of each part, so one pass can run a CG trip, the
    Newton step after it, the end of the ADMM iteration and the next one's
    start. Each branch does what run() does at that point, with the same
    ops in the same order:

      ITER_START  the inner-eps ladder, the rho row, eps, and the solve's
                  set_inputs (every part's priors z - u, Newton init and
                  running mask, and the first phase);
      CG_START    the part's cg_init;
      CG          one cg_trip of the part;
      EPILOGUE    the part's Newton epilogue and its next running mask;
      ITER_END    the mask and relaxation of the x-update, the consensus,
                  z- and u-updates and diffs (step.consensus: under a mesh
                  its all_reduce(SUM)), the trip maxima (under a mesh an
                  all_reduce(MAX) of a device tensor), the sample loglik
                  and best-model tracking and the stop rule (maxdiff in
                  float64 against epsilon, as run() compares), then the
                  next iteration or a stop.

    Under a mesh every rank runs its own phases over its own blocks and
    passes ITER_END once an iteration, so the collectives pair up across
    the ranks in order."""

    ITER_END, ITER_START = 1, 2

    def __init__(self, trainer: AdmmTrainer, z0, track_ll: bool):
        self.tr = tr = trainer
        cfg = tr.config
        dev, dtype = tr.device, cfg.dtype
        self.on_card = dev.type == "cuda"
        L, n, B = len(tr.lambdas), tr.dim, tr.data.nblocks
        self.max_it = max_it = cfg.num_iters
        self.track_ll = track_ll
        self.B, self.n = B, n

        def full(shape, value, dt=dtype):
            return torch.full(shape, value, dtype=dt, device=dev)

        self.z0 = (None if z0 is None else torch.as_tensor(
            np.broadcast_to(z0, (L, n)).copy(), dtype=dtype, device=dev))
        self.z = (full((L, n), 0.0) if z0 is None else self.z0.clone())
        self.u = full((L, B, n), 0.0)
        self.inner_eps = full((), cfg.liblinear_epsilon, torch.float64)
        self.mindiff = full((), 99999999.0, torch.float64)
        self.it = full((), 1, torch.int64)
        self.chunk_end = full((), 0, torch.int64)
        self.done = full((), False, torch.bool)
        self.diffs_h = full((max_it + 1, L), float("nan"))
        self.ll_h = full((max_it + 1, L), float("nan"))
        self.best_ll = full((), -9999999.0)
        self.best_z = full((n,), 0.0)
        self.best_lam = full((), 0, torch.int64)
        self.best_it = full((), 0, torch.int64)
        self.nt_tot = full((), 0, torch.int64)
        self.cg_tot = full((), 0, torch.int64)
        self.phase = full((), 0, torch.int32)
        # rho_eff per iteration, made by run()'s own function (row 0 is
        # iteration 1's, never read)
        self.rho_tab = _rho_table(tr.rhos, max_it, cfg, z0 is not None, dev)
        self.rho_base = torch.as_tensor(tr.rhos, dtype=dtype, device=dev)

        # the solve, over the problem with its priors in place
        self.solve = tr.step.solve
        self.x_update = tr._solve_loop(self.z, self.u, self.rho_tab[1],
                                       self.eps(), first=3,
                                       after=self.ITER_END, phase=self.phase)

        state = [self.z, self.u, self.inner_eps, self.mindiff, self.it,
                 self.done, self.diffs_h, self.ll_h, self.best_ll,
                 self.best_z, self.best_lam, self.best_it, self.nt_tot,
                 self.cg_tot, *self.x_update.state()]
        branches = (self.x_update.cg_branches
                    + [(self.ITER_END, "iteration_end", self.iteration_end),
                       (self.ITER_START, "iteration_start",
                        self.iteration_start)]
                    + self.x_update.init_branches)
        self.loop = DeviceLoop(branches, self.phase, state,
                               kernels=dict(_SOLVE_KERNELS,
                                            all_reduce=all_reduce))

    def eps(self):
        # run() computes inner_eps * eps_scale from a Python float: the
        # scalar is rounded to the compute dtype, as here
        return self.inner_eps.to(self.tr.config.dtype) * self.tr.eps_scale

    def _next(self, cond, yes, no):
        self.phase.copy_(torch.where(cond, yes, no))

    def start_chunk(self, last_iteration: int) -> None:
        """Run iterations up to `last_iteration` (no host read)."""
        self.chunk_end.fill_(last_iteration)
        self.phase.fill_(self.ITER_START)

    # -- branches ---------------------------------------------------------
    def iteration_start(self):
        cfg = self.tr.config
        it, ie = self.it, self.inner_eps
        if cfg.aggressive_liblinear_epsilon_decay:
            ie_new = torch.where(it > 5, ie / 10.0, ie)
        else:
            ie_new = torch.where((it > 1) & (self.mindiff < 0.001),
                                 ie / 10.0, ie)
        ie.copy_(ie_new)
        rho = self.rho_tab.index_select(0, it.view(1))[0]
        self.x_update.set_inputs(self.z, self.u, rho, self.eps())

    def iteration_end(self):
        tr, cfg, it = self.tr, self.tr.config, self.it
        prior_mean = x_prior(self.z, self.u)
        x = self.solve.finish(self.x_update.x(), tr.present, prior_mean,
                              self.z)
        z_new, u_new, diffs = tr.step.consensus(x, self.z, self.u,
                                                tr.lam_vec, self.rho_base,
                                                tr.block_valid)
        self.diffs_h.index_copy_(0, it.view(1), diffs[None])
        trip_max = self.x_update.trips().amax(0).to(torch.int64)
        if tr._group is not None:
            all_reduce(trip_max, "max", tr._group)
        self.nt_tot += trip_max[0]
        self.cg_tot += trip_max[1]
        d64 = diffs.to(torch.float64)
        self.mindiff.copy_(d64.min())
        if self.track_ll:
            ll = sample_loglik_lanes(*tr.test_arrays, z_new)
            self.ll_h.index_copy_(0, it.view(1), ll[None])
            # run()'s lambda-order scan with a strict >: the first maximum
            bi = torch.argmax(ll)
            top = ll.index_select(0, bi.view(1))[0]
            better = top > self.best_ll
            self.best_ll.copy_(torch.where(better, top, self.best_ll))
            self.best_z.copy_(torch.where(
                better, z_new.index_select(0, bi.view(1))[0], self.best_z))
            self.best_lam.copy_(torch.where(better, bi, self.best_lam))
            self.best_it.copy_(torch.where(better, it, self.best_it))
        self.done.copy_((d64.max() < cfg.epsilon)
                        & (self.inner_eps <= cfg.inner_eps_floor))
        self.z.copy_(z_new)
        self.u.copy_(u_new)
        it += 1
        self._next(~self.done & (it <= self.chunk_end), self.ITER_START, 0)


def _leaves(tree) -> list[torch.Tensor]:
    return [t for t in pytree.tree_leaves(tree) if t is not None]


def _materialize(tree):
    """A copy of every tensor of a state (NamedTuples nested, None kept),
    dense and owned, to be written in place by the device loop."""
    leaves, spec = pytree.tree_flatten(tree)
    return pytree.tree_unflatten(
        [None if t is None else torch.empty_like(
            t, memory_format=torch.contiguous_format).copy_(t)
         for t in leaves], spec)


def _assign(dst, src) -> None:
    """Copy a state into the static state of the same structure."""
    for d, s in zip(_leaves(dst), _leaves(src), strict=True):
        d.copy_(s)
