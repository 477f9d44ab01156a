"""The bfloat16 rule in the consensus and the multi-RHS solver's scalars
(ops/tron_multi.py's docstring): a bfloat16 run forms the z- and dual
updates in float32 and rounds z and u once each, in build_admm_step's
consensus and in the streaming trainer's; the solver's dots, norms and
trust-region scalars stay float32. Float32 keeps its own formulas bit for
bit."""

import numpy as np
import pytest
import torch

from mlease_tpu_torch.ops import admm_math, tron_multi
from mlease_tpu_torch.train.admm import build_admm_step
from test_torch_bf16_spans import trainer

N = 8


def step():
    return build_admm_step(nblocks=N, regularizer=2, intercept_index=None,
                           penalize_intercept=False,
                           reference_l1_compat=False, max_newton_iter=5,
                           max_cg_iter=5)


def operands(dtype, L=3, n=4096, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((L, N, n), generator=g).to(dtype)
    u = (0.1 * torch.randn((L, N, n), generator=g)).to(dtype)
    z = torch.randn((L, n), generator=g).to(dtype)
    lam = torch.tensor([1.0, 10.0, 100.0])[:L, None].expand(L, n)
    return x, z, u, lam.to(dtype), torch.ones(L, dtype=dtype)


def test_bf16_consensus_rounds_once_from_float32():
    """lambda 1, rho 1, 8 blocks: kappa is 8/9 in float32 (a bfloat16 8/9
    is 0.8867), and u + x - z is formed in float32 from the rounded z."""
    x, z, u, lam, rho = operands(torch.bfloat16)
    z_new, u_new, _ = step().consensus(x, z, u, lam, rho)
    assert z_new.dtype == u_new.dtype == torch.bfloat16
    v = (x.sum(1) / N + u.sum(1) / N).float()
    kappa = N * 1.0 / (lam.float() + N * 1.0)
    want_z = (kappa * v).to(torch.bfloat16)
    want_u = (u.float() + x.float()
              - want_z.float()[:, None, :]).to(torch.bfloat16)
    assert torch.equal(z_new, want_z)
    assert torch.equal(u_new, want_u)
    # the bfloat16 formulas the rule forbids give other bits
    v16 = x.sum(1) / N + u.sum(1) / N
    nrho = N * rho[:, None]
    assert not torch.equal(z_new[0], ((nrho / (lam + nrho)) * v16)[0])
    assert not torch.equal(u_new, u + x - z_new[:, None, :])


def test_float32_consensus_keeps_its_formula():
    x, z, u, lam, rho = operands(torch.float32)
    z_new, u_new, diffs = step().consensus(x, z, u, lam, rho)
    v = x.sum(1) / N + u.sum(1) / N
    nrho = N * rho[:, None]
    want_z = (nrho / (lam + nrho)) * v
    assert torch.equal(z_new, want_z)
    assert torch.equal(u_new, u + x - want_z[:, None, :])
    assert torch.equal(diffs, (want_z - z).abs().amax(-1))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dot_lm_sums_and_keeps_the_accumulate_type(dtype):
    g = torch.Generator().manual_seed(1)
    a = torch.randn((3, 2, 5000), generator=g).to(dtype)
    b = torch.randn((3, 2, 5000), generator=g).to(dtype)
    got = tron_multi._dot_lm(a, b)
    assert got.dtype == torch.float32
    assert torch.equal(got, (a.float() * b.float()).sum(-1))


@pytest.mark.parametrize("kind", ["admm", "stream"])
def test_bf16_run_keeps_the_solver_scalars_in_float32(kind, monkeypatch):
    """Every Newton state of a bfloat16 run: W and G in bfloat16, F, the
    trust region and the gradient norms in float32."""
    seen = []
    epilogue = tron_multi.MultiSolver.epilogue

    def watched(self, ns, cs):
        out = epilogue(self, ns, cs)
        seen.append(out)
        return out
    monkeypatch.setattr(tron_multi.MultiSolver, "epilogue", watched)
    res = trainer(kind, torch.bfloat16).run()
    assert np.isfinite(res.z).all() and seen
    for ns in seen:
        assert ns.W.dtype == ns.G.dtype == torch.bfloat16
        for f in (ns.F, ns.delta, ns.gnorm, ns.gnorm1):
            assert f.dtype == torch.float32


def test_streaming_bf16_consensus_rounds_once_from_float32():
    """Each iteration of the streaming trainer: z is the z-update of the
    groups' bfloat16 partial sums formed in float32 and rounded once, and
    each group's u is u + x - z formed in float32 and rounded once."""
    tr = trainer("stream", torch.bfloat16)
    cfg, iterate, solve_group = tr.config, tr._iterate, tr._solve_group
    xs: list = []
    checked = []

    def solve(gi, *a, **kw):
        x, trip = solve_group(gi, *a, **kw)
        xs.append(x.clone())
        return x, trip

    def watched(z, u_groups, rho_eff, rho_base, *a, **kw):
        u0 = [u.clone() for u in u_groups]
        xs.clear()
        out = iterate(z, u_groups, rho_eff, rho_base, *a, **kw)
        z_new = out[0]
        xsum = usum = None
        for x, u in zip(xs, u0):
            xsum = x.sum(1) if xsum is None else xsum + x.sum(1)
            usum = u.sum(1) if usum is None else usum + u.sum(1)
        v = (xsum + usum) / tr.nblocks
        args = (tr.nblocks, tr.vocab.intercept_index,
                cfg.penalize_intercept)
        want = admm_math.z_update_l2(v.float(), tr.lam_vec.float(),
                                     rho_base[:, None].float(), *args)
        assert z_new.dtype == torch.bfloat16
        assert torch.equal(z_new, want.to(torch.bfloat16))
        narrow = admm_math.z_update_l2(v, tr.lam_vec,
                                       rho_base[:, None], *args)
        checked.append(not torch.equal(z_new, narrow))
        for x, u, u_new in zip(xs, u0, u_groups):
            assert torch.equal(u_new, (u.float() + x.float()
                                       - z_new.float()[:, None, :])
                               .to(torch.bfloat16))
        return out

    tr._solve_group, tr._iterate = solve, watched
    tr.run()
    # every iteration checked; the bfloat16 formula the rule forbids gave
    # other bits at least once
    assert len(checked) == cfg.num_iters and any(checked)
