"""The dense head's routes through the data passes (ops/head_pass.py,
ops/tron_multi.py) on the CPU.

The kernels of ops/head_pass.py take a head stored in bfloat16 under a
float32 solve on the card (`takes`); a float32 head, a bfloat16 solve and
every CPU tensor keep the widening route: each block widened, one cuBLAS
(here CPU) product. On the CPU the passes give the widening route's bits
exactly, and never call the kernels' wrappers, which refuse a head off
the card. The kernels themselves run in tests/test_torch_cuda.py on the
card.
"""

import numpy as np
import pytest
import torch

import mlease_tpu_torch.ops.tron_multi as tm
from mlease_tpu_torch.ops import head_pass
from mlease_tpu_torch.ops.head_pass import head_xtv, head_xv, takes


def head_problem(seed, B=3, Rb=50, H=12, L=3, head_dtype=torch.bfloat16,
                 dtype=torch.float32, flat=True):
    """A head-only problem (no ELL slots, no tail): its passes are the head
    products alone, so their bits can be held to a formula."""
    gen = torch.Generator().manual_seed(seed)
    R = B * Rb
    n = B * H + 5
    x = torch.randn((B, Rb, H) if flat else (R, H), generator=gen)
    ids = torch.randperm(n, generator=gen)[:(B * H if flat else H)]
    prob = tm.MultiProblem(
        indices=torch.zeros((R, 0), dtype=torch.int32),
        values=torch.zeros((R, 0), dtype=dtype),
        y=torch.where(torch.rand(R, generator=gen) < 0.5, -1.0, 1.0).to(dtype),
        weight=torch.ones(R, dtype=dtype), offset=torch.zeros(R, dtype=dtype),
        prior_mean=torch.zeros((L, n), dtype=dtype),
        prior_var_inv=torch.ones((L, n), dtype=dtype),
        head_x=x.to(head_dtype), head_ids=ids.to(torch.int32))
    V = torch.randn((L, n), generator=gen).to(dtype)
    D = torch.randn((L, R), generator=gen).to(dtype)
    return prob, V, D


def widened(hx, dtype, square=False):
    """The widening route's operand (the parent's `_widen`)."""
    hb = hx * hx if square else hx
    return hb if hb.dtype == dtype else hb.to(dtype)


def parent_head_t(hx, D, square=False):
    if hx.dim() == 3:
        B, Rb, H = hx.shape
        Db = D.reshape(D.shape[0], B, Rb)
        return torch.cat([Db[:, b] @ widened(hx[b], D.dtype, square)
                          for b in range(B)], dim=1)
    return D @ widened(hx, D.dtype, square)


def parent_xv(prob, V):
    """The widening route's Xv of a head-only problem, as written before
    the kernels."""
    hx, L, R = prob.head_x, V.shape[0], prob.y.shape[0]
    acc = torch.float32 if V.dtype == torch.bfloat16 else V.dtype
    out = torch.zeros((L, R), dtype=acc)
    hw = V[:, prob.head_ids]
    if hx.dim() == 3 and hx.dtype == V.dtype:
        B, Rb, H = hx.shape
        prod = torch.bmm(hx, hw.reshape(L, B, H).permute(1, 2, 0))
        return out + prod.permute(2, 0, 1).reshape(L, R)
    if hx.dim() == 3:
        B, Rb, H = hx.shape
        hwb = hw.reshape(L, B, H)
        outb = out.view(L, B, Rb)
        for b in range(B):
            outb[:, b] += hwb[:, b] @ widened(hx[b], V.dtype).T
        return out
    return out + hw @ widened(hx, V.dtype).T


def parent_xtv(prob, D, Dm=None):
    n = prob.prior_mean.shape[-1]
    L = D.shape[0]
    acc = torch.float32 if D.dtype == torch.bfloat16 else D.dtype
    hx = prob.head_x
    if Dm is None:
        out = torch.zeros((L, n), dtype=acc)
        return out.index_add_(1, prob.head_ids, parent_head_t(hx, D).to(acc))
    out = torch.zeros((2 * L, n), dtype=acc)
    out.index_add_(1, prob.head_ids, torch.cat(
        [parent_head_t(hx, D), parent_head_t(hx, Dm, square=True)]).to(acc))
    return out[:L], out[L:]


@pytest.fixture
def no_kernels(monkeypatch):
    """The kernels' wrappers, as tron_multi calls them, raise."""
    def refuse(*a, **kw):
        raise AssertionError("the head kernels ran on a CPU route")
    monkeypatch.setattr(tm, "head_xv", refuse)
    monkeypatch.setattr(tm, "head_xtv", refuse)


@pytest.mark.parametrize("head_dtype,dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16)],
    ids=["bf16-head", "f32-head", "bf16-solve"])
@pytest.mark.parametrize("flat", [True, False], ids=["3d", "2d"])
@pytest.mark.parametrize("H", [1, 12, 130])
def test_cpu_passes_are_the_widening_route_bit_for_bit(no_kernels, head_dtype,
                                                       dtype, flat, H):
    prob, V, D = head_problem(H, H=H, head_dtype=head_dtype, dtype=dtype,
                              flat=flat)
    assert not takes(prob.head_x, dtype)
    assert torch.equal(tm._xv_lm(prob, V), parent_xv(prob, V))
    assert torch.equal(tm._xtv_lm(prob, D), parent_xtv(prob, D))
    Dm = D.abs()
    g, h = tm._xtv_and_sqdiag_lm(prob, D, Dm)
    want_g, want_h = parent_xtv(prob, D, Dm)
    assert torch.equal(g, want_g) and torch.equal(h, want_h)
    diag = tm._hessian_diagonal_lm(prob, Dm)
    acc = torch.float32 if dtype == torch.bfloat16 else dtype
    want = torch.zeros_like(diag).index_add_(
        1, prob.head_ids, parent_head_t(prob.head_x, Dm, square=True)
        .to(acc)) + prob.prior_var_inv
    assert torch.equal(diag, want)


def test_takes_only_a_bf16_head_under_a_float32_solve_on_the_card():
    x = torch.zeros((2, 4, 8), dtype=torch.bfloat16)
    assert not takes(None, torch.float32)
    assert not takes(x, torch.float32)                  # the CPU
    assert not takes(x.to("meta"), torch.float32)       # not a card
    assert not takes(x.float(), torch.float32)
    assert not takes(x, torch.bfloat16)
    assert not takes(x, torch.float64)
    # where the head is used: a host head bound for the card is taken
    assert takes(x, torch.float32, "cuda")
    assert takes(x[0], torch.float32, torch.device("cuda", 1))
    assert not takes(x, torch.float32, "cpu")
    assert not takes(x, torch.bfloat16, "cuda")
    assert not takes(x[0, 0], torch.float32, "cuda")
    assert not takes(None, torch.float32, "cuda")


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((2, 4, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        head_xv(x.float(), torch.zeros((1, 16)), torch.zeros((1, 8)))
    with pytest.raises(ValueError, match="float32"):
        head_xv(x, torch.zeros((1, 16), dtype=torch.float64),
                torch.zeros((1, 8)))
    with pytest.raises(ValueError, match="lanes"):
        head_xv(x, torch.zeros((2, 16)), torch.zeros((1, 8)))
    with pytest.raises(ValueError, match="cover"):
        head_xv(x, torch.zeros((1, 15)), torch.zeros((1, 8)))
    with pytest.raises(ValueError, match="unit stride"):
        head_xv(x, torch.zeros((1, 16)), torch.zeros((8, 2))[:, :1].T)
    with pytest.raises(ValueError, match="ids"):
        head_xtv(x, torch.zeros((1, 8)), torch.arange(15),
                 torch.zeros((1, 20)))
    with pytest.raises(ValueError, match="ids"):
        head_xtv(x, torch.zeros((1, 8)), torch.arange(16).float(),
                 torch.zeros((1, 20)))


@pytest.mark.parametrize("dim", [2, 3])
def test_wrappers_refuse_a_head_off_the_card(dim):
    """The CPU's head products are the widening route's (tron_multi):
    the wrappers take a head on the card alone."""
    x = torch.zeros((2, 4, 8), dtype=torch.bfloat16)
    x = x if dim == 3 else x[0]
    B = 2 if dim == 3 else 1
    with pytest.raises(ValueError, match="on the card"):
        head_xv(x, torch.zeros((1, 8 * B)), torch.zeros((1, 4 * B)))
    with pytest.raises(ValueError, match="on the card"):
        head_xtv(x, torch.zeros((1, 4 * B)), torch.arange(8 * B),
                 torch.zeros((1, 8 * B)), square_from=0)


def test_the_head_bytes_a_pass_reads():
    """The bound's numerator: ctr-12m's block of 1,562,500 x 128 bfloat16
    values, 0.119 ms at 3.35 TB/s."""
    assert head_pass.min_bytes(1_562_500, 128) == 400_000_000
    assert round(head_pass.min_bytes(1_562_500, 128) / 3.35e12 * 1e3,
                 3) == 0.119
    assert np.isclose(head_pass.min_bytes(12_500_000, 128) / 3.35e12 * 1e3,
                      0.955, atol=5e-4)
