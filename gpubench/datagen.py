"""The benchmark's CTR data, made on the device from the seed.

The law is the JAX package's `bench.py` generator (the one
`chip_smoke.py::synth_blocked_data` copies): every row has `nnz` columns
drawn as (zipf(a) - 1) mod n_features and the intercept column
(n_features) with value 1; the drawn columns carry N(0, value_std^2)
values; the label is +1 with probability sigmoid(x . w*), w* ~ N(0,
w_std^2) with the intercept's weight fixed. A row may draw one column
twice: both entries are kept, as that generator keeps them (they sum).

Every seed gets the same shapes: which slot of which row holds which
popularity rank is one fixed draw (LAYOUT_SEED), and the seed draws a
relabelling of the feature columns (a permutation: the rank r column is
column perm[r]), the values, w* and the labels. So every seed sorts, packs
and holds the same sizes, in another order: the program's host memory
follows those sizes, and a seed must not move a metric by its draw.

Draws are made with torch's generator on the device, one stream a block
(and one for w*, one for the held-out rows, one for the relabelling), and every sum that shapes
them is made in one fixed order, so the same seed gives the same arrays
on the same kind of device, every time (the harness checks it: the
reference's remade blocks carry the fingerprints of the program's). The zipf draw is an
inverse CDF: a table of the exact CDF for k <= ZIPF_TABLE and the
Hurwitz-zeta tail, sum_{j>k} j^-a ~ (k + 1/2)^(1-a) / (a - 1), beyond it
(its error there is below 1e-12 of the mass). Nothing here imports the
program: the harness hands these arrays to it, and the reference makes
them again from the seed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

ZIPF_TABLE = 1 << 20
W_STREAM = 1 << 40          # stream ids past any block index
TEST_STREAM = W_STREAM + 1
PERM_STREAM = W_STREAM + 2
LAYOUT_SEED = 0            # the fixed draw of the rows' popularity ranks
_MASK64 = (1 << 64) - 1


@dataclass(frozen=True)
class DataSpec:
    """The data's shape and law (a configuration file's "data")."""

    rows: int
    blocks: int
    n_features: int
    nnz: int
    zipf_a: float
    value_std: float
    w_std: float
    intercept_weight: float
    test_rows: int

    @classmethod
    def from_config(cls, data: dict) -> "DataSpec":
        return cls(**{k: data[k] for k in cls.__dataclass_fields__})

    @property
    def rows_per_block(self) -> int:
        if self.rows % self.blocks:
            raise ValueError(f"{self.rows} rows do not split into "
                             f"{self.blocks} equal blocks")
        return self.rows // self.blocks

    @property
    def dim(self) -> int:
        """Columns: the features and the intercept (the last)."""
        return self.n_features + 1


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for stream `stream` of run seed `seed`
    (splitmix64 of the pair: any whole seed, negative or past 32 bits)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(stream) + 1) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


class Zipf:
    """Inverse-CDF sampler of zipf(a) on {1, 2, ...}, float64 on the
    device."""

    def __init__(self, a: float, device):
        # the table on the host, summed in one order (numpy's cumsum runs
        # left to right): a scan on the card may associate differently
        # from one call to the next, and one ulp of the table moves a draw
        k = np.arange(1, ZIPF_TABLE + 1, dtype=np.float64)
        pk = k ** -a
        m = float(ZIPF_TABLE)
        # zeta(a) by the table and the Euler-Maclaurin tail
        zeta = (float(np.sum(pk)) + m ** (1 - a) / (a - 1)
                - 0.5 * m ** (-a) + a * m ** (-a - 1) / 12)
        self.cdf = torch.from_numpy(np.cumsum(pk) / zeta).to(device)
        self.a, self.zeta = a, zeta

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        """k (float64, exact integers below 2^53) for uniforms u."""
        k = torch.searchsorted(self.cdf, u).to(torch.float64) + 1.0
        a = self.a
        tail = torch.ceil(torch.pow((1.0 - u) * self.zeta * (a - 1),
                                    1.0 / (1.0 - a)) - 0.5)
        tail = torch.clamp(tail, min=float(ZIPF_TABLE + 1))
        return torch.where(u > self.cdf[-1], tail, k)


def w_true(spec: DataSpec, seed: int, device) -> torch.Tensor:
    g = generator(seed, W_STREAM, device)
    w = torch.randn(spec.dim, dtype=torch.float32, device=device,
                    generator=g) * spec.w_std
    w[spec.n_features] = spec.intercept_weight
    return w


def column_perm(spec: DataSpec, seed: int, device) -> torch.Tensor:
    """The seed's relabelling of the feature columns: rank r -> perm[r]."""
    return torch.randperm(spec.n_features, device=device,
                          generator=generator(seed, PERM_STREAM, device))


def draw_rows(spec: DataSpec, seed: int, stream: int, rows: int,
              w: torch.Tensor, zipf: Zipf, perm: torch.Tensor, device):
    """(indices (rows, nnz + 1) int32, values float32, y (rows,) float32
    in {+1, -1}) of one stream, on `device`: the ranks from the fixed
    layout, relabelled by `perm`; values and labels from the seed."""
    u = torch.rand((rows, spec.nnz), dtype=torch.float64, device=device,
                   generator=generator(LAYOUT_SEED, stream, device))
    ranks = torch.fmod(zipf(u) - 1.0, float(spec.n_features)).long()
    del u
    idx = torch.empty((rows, spec.nnz + 1), dtype=torch.int32,
                      device=device)
    idx[:, :spec.nnz] = perm[ranks].to(torch.int32)
    del ranks
    g = generator(seed, stream, device)
    idx[:, spec.nnz] = spec.n_features
    val = torch.empty((rows, spec.nnz + 1), dtype=torch.float32,
                      device=device)
    val[:, :spec.nnz] = torch.randn((rows, spec.nnz), dtype=torch.float32,
                                    device=device,
                                    generator=g) * spec.value_std
    val[:, spec.nnz] = 1.0
    score = (val * w[idx.long()]).sum(1)
    p = torch.sigmoid(score)
    y = torch.where(torch.rand(rows, dtype=torch.float32, device=device,
                               generator=g) < p, 1.0, -1.0)
    return idx, val, y


def blocks(spec: DataSpec, seed: int, device, which=None):
    """Yield (b, indices, values, y) of each block (all, or those in
    `which`), made on `device`."""
    zipf = Zipf(spec.zipf_a, device)
    w = w_true(spec, seed, device)
    perm = column_perm(spec, seed, device)
    for b in (range(spec.blocks) if which is None else which):
        yield (b, *draw_rows(spec, seed, b, spec.rows_per_block, w, zipf,
                             perm, device))


def test_rows(spec: DataSpec, seed: int, device):
    """The held-out rows: (indices (T, nnz + 1), values, y), made on
    `device`."""
    zipf = Zipf(spec.zipf_a, device)
    return draw_rows(spec, seed, TEST_STREAM, spec.test_rows,
                     w_true(spec, seed, device), zipf,
                     column_perm(spec, seed, device), device)
