"""The host-driven solves the per-key trainers' device loops replaced, as
replacements of the trainers' seams (train/item.py::_solve_bucket,
train/naive.py::_solve_keys): newton_cholesky / tron on an item bucket,
tron_multi on each stacked naive problem or sub-stack and tron on the
naive lanes, each reading the host once a trip. The loops are held to
them bit for bit, by the CPU tests, the card tests and chip_smoke.py
(which loads this file by its path). Imports torch and the port only."""

import torch

from mlease_tpu_torch.ops import tron_multi as tm
from mlease_tpu_torch.ops.newton import newton_cholesky
from mlease_tpu_torch.ops.tron import tron
from mlease_tpu_torch.train.admm import _Solved, w_to_x


def host_bucket(prob, w0, eps_t, cfg, pool=None) -> _Solved:
    """_solve_bucket through newton_cholesky or tron."""
    if cfg.solver == "cholesky":
        r = newton_cholesky(prob, w0, eps_t,
                            max_iter=min(cfg.max_newton_iter, 100))
        trips = [r.trips]
    else:
        r = tron(prob, w0, eps_t, max_iter=cfg.max_newton_iter,
                 max_cg_iter=cfg.max_cg_iter)
        trips = [r.newton_trips, r.cg_trips]
    return _Solved(r.w, torch.tensor(trips, device=w0.device))


def host_keys(mode, probs, L, n, eps, prior, cfg) -> _Solved:
    """_solve_keys through tron_multi (each stacked problem or sub-stack)
    or tron (the lanes)."""
    pm3, pvi3 = prior
    common = dict(max_iter=cfg.max_newton_iter, max_cg_iter=cfg.max_cg_iter)
    zeros = dict(dtype=cfg.dtype, device=eps.device)
    if mode == "lanes":
        prob, _ = probs[0]
        K = prob.y.shape[0]
        r = tron(prob._replace(prior_mean=pm3.reshape(L * K, n),
                               prior_var_inv=pvi3.reshape(L * K, n)),
                 torch.zeros((L * K, n), **zeros), eps.repeat(L), **common)
        return _Solved(r.w.view(L, K, n), torch.tensor(
            [r.newton_trips, r.cg_trips], device=eps.device))
    xs, trips = [], []
    for prob, (b0, b1) in probs:
        k = b1 - b0
        blocks = k if mode == "per_block" else 1
        r = tm.tron_multi(prob._replace(
            prior_mean=pm3[:, b0:b1].reshape(L, -1).T,
            prior_var_inv=pvi3[:, b0:b1].reshape(L, -1).T),
            torch.zeros((k * n, L), **zeros),
            eps[b0:b1] if blocks > 1 else eps[b0:b1].min(),
            precondition=cfg.pcg, blocks=blocks, **common)
        xs.append(w_to_x(r.w, k, n))
        trips.append([r.newton_trips, r.cg_trips])
    return _Solved(torch.cat(xs, 1),
                   torch.tensor(trips, device=eps.device).amax(0))
