"""The bfloat16 solve's spans on the CPU (ops/tron_multi.py): `head_gemm`
inside `head_pass` around the head's torch products and `tail_bf16` inside
`tail_pass` around the K1 calls that read bfloat16, in run() of the
in-memory and of the streaming trainer; a float32 solve records no
`tail_bf16`. On the CPU every head pass takes torch's products (the head
kernels run on the card only), so `head_gemm` fires in both dtypes."""

import collections

import numpy as np
import pytest
import torch

from mlease_tpu_torch.core.dataset import BlockedData, split_blocks
from mlease_tpu_torch.core.vocab import FeatureVocab
from mlease_tpu_torch.ops import tron_multi
from mlease_tpu_torch.ops.device_loop import DeviceClock
from mlease_tpu_torch.train.admm import AdmmConfig, AdmmTrainer
from mlease_tpu_torch.train.streaming import StreamingAdmmTrainer
from mlease_tpu_torch.utils import profiling

NF = 150
SLOTS = ("head_pass", "head_fused", "head_gemm", "tail_pass", "tail_bf16")


def blocked_data(seed=3, B=4, R=200, nnz=6):
    rng = np.random.default_rng(seed)
    n = NF + 1
    cols = (rng.zipf(1.3, size=(B, R, nnz)) - 1) % NF
    indices = np.concatenate([cols, np.full((B, R, 1), NF)],
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


def trainer(kind, dtype):
    torch.set_num_threads(1)
    vocab = FeatureVocab.from_names(f"f{i}" for i in range(NF))
    cfg = AdmmConfig(lambdas=[1.0, 10.0], num_iters=3, head_size=16,
                     head_dtype=torch.bfloat16, dtype=dtype, epsilon=0.0)
    data = blocked_data()
    if kind == "admm":
        return AdmmTrainer(data, vocab, cfg, device="cpu")
    return StreamingAdmmTrainer(split_blocks(data, 2), vocab, cfg,
                                device="cpu")


def executions():
    """Each device span's executions over the store."""
    out = collections.Counter()
    for s in profiling.recorded()["spans"]:
        if s.device is not None:
            out[s.name] += s.executions
    return out


@pytest.fixture(autouse=True)
def empty_store():
    profiling.reset()
    yield
    profiling.reset()


@pytest.mark.parametrize("kind", ["admm", "stream"])
def test_bf16_run_stamps_every_head_and_tail_pass_in_its_own_span(kind):
    tr = trainer(kind, torch.bfloat16)
    assert tr.clock.rows.keys() >= set(SLOTS)
    profiling.reset()
    res = tr.run()
    assert np.isfinite(res.z).all()
    got = executions()
    assert got["head_pass"] > 0 and got["tail_pass"] > 0
    assert got["head_gemm"] == got["head_pass"]
    assert got["tail_bf16"] == got["tail_pass"]
    assert got["head_fused"] == 0


@pytest.mark.parametrize("kind", ["admm", "stream"])
def test_float32_run_records_no_bf16_tail(kind):
    tr = trainer(kind, torch.float32)
    profiling.reset()
    tr.run()
    got = executions()
    assert got["tail_pass"] > 0 and "tail_bf16" not in got
    assert got["head_gemm"] == got["head_pass"] > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_each_pass_stamps_its_head_route_and_bf16_tail_once(dtype):
    """The three data passes of a stacked problem: one head_gemm a pass,
    one tail_bf16 a K1 call in bfloat16 and none in float32."""
    prob = tron_multi.lanes_major(trainer("admm", dtype).prob)
    clock = DeviceClock("cpu", SLOTS)
    L, n = prob.prior_mean.shape
    V = torch.ones((L, n), dtype=prob.prior_mean.dtype)
    D = torch.ones((L, prob.y.shape[0]), dtype=prob.prior_mean.dtype)
    with clock.active():
        tron_multi._xv_lm(prob, V)
        tron_multi._xtv_lm(prob, D)
        tron_multi._xtv_and_sqdiag_lm(prob, D, D)
    runs = {name: int(clock.table[clock.rows[name], 2]) for name in SLOTS}
    assert runs["head_pass"] == runs["head_gemm"] == 3
    assert runs["tail_pass"] == 3
    assert runs["tail_bf16"] == (3 if dtype == torch.bfloat16 else 0)
