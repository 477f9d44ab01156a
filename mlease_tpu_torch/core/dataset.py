"""Device data layout: padded sparse blocks for the solver.

Copied from mlease_tpu/core/dataset.py (logic unchanged); the layout notes
below explain why the JAX package chose it for the TPU, and the port keeps
the same host arrays so both packages train on identical inputs.

The reference materializes per-reducer CSR-ish `FeatureNode[][]` rows
(reference: LibLinearDataset.java:586-658). TPUs need static shapes, so each
data block is packed into a padded ELL-style layout:

    indices : (rows, max_nnz) int32   — vocab column per nonzero (0 when padded)
    values  : (rows, max_nnz) float   — 0.0 on padding (contributes nothing to
                                        either Xv gathers or X'v scatter-adds)
    y       : (rows,) float           — +1 / -1 (response 0 mapped to -1 as in
                                        LibLinearDataset.java:333-335); +1 on
                                        padding rows
    weight  : (rows,) float           — per-instance weight, 0.0 on padding
                                        rows so they are exact no-ops in the
                                        objective
    offset  : (rows,) float

The intercept keeps the reference's "bias as last feature" encoding
(LibLinearDataset.java:592-615): one extra nonzero slot holding
(intercept_index, bias) per real row.

A multi-block dataset stacks B such blocks with common (rows, max_nnz) and
carries a per-block feature presence mask used to pin features with no data in
a block to their prior mean, exactly as LibLinear.train does for features
absent from the dataset (reference: LibLinear.java:373-397).
"""

from __future__ import annotations

from typing import Iterable, Mapping, NamedTuple, Sequence

import numpy as np


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class Block(NamedTuple):
    """One packed data block (host numpy; device transfer happens in train)."""

    indices: np.ndarray   # (R, K) int32
    values: np.ndarray    # (R, K) float
    y: np.ndarray         # (R,) float
    weight: np.ndarray    # (R,) float
    offset: np.ndarray    # (R,) float
    nrows: int            # real (unpadded) row count


class BlockedData(NamedTuple):
    """B stacked blocks, ready for vmap/sharding over the leading axis.

    `head` is the optional dense-head hybrid layout: with a
    frequency-ordered vocabulary, the hottest `H` columns (indices 0..H-1,
    which in power-law data cover most nonzeros) are stored as a dense
    (B, R, H) matrix whose mat-vecs ride the MXU, while `indices`/`values`
    hold only the cold tail. TPUs have no vector gather hardware (see
    DESIGN.md section 3), so moving the hot mass into dense matmuls is the
    difference between bandwidth-bound and scatter-bound solves.
    """

    indices: np.ndarray   # (B, R, K) int32 — all nonzeros, or tail-only when head is set
    values: np.ndarray    # (B, R, K) float
    y: np.ndarray         # (B, R) float
    weight: np.ndarray    # (B, R) float
    offset: np.ndarray    # (B, R) float
    present: np.ndarray   # (B, n) bool — feature occurs in block's data
    nrows: np.ndarray     # (B,) int32 real row counts
    nblocks: int
    dim: int              # n = vocab.size (including intercept column)
    head: np.ndarray | None = None       # (B, R, H) dense hot columns
    head_ids: np.ndarray | None = None   # (H,) int32 vocab ids of head slots
    tail_rows: np.ndarray | None = None  # (B, T) int32 flat-COO tail rows
    tail_cols: np.ndarray | None = None  # (B, T) int32 flat-COO tail columns
    tail_vals: np.ndarray | None = None  # (B, T) flat-COO tail values
    # the same tail nonzeros sorted by column id: X'v and diag(H) become
    # sorted segment-sums instead of scatter-adds (~1.6x on TPU, where
    # scatter is the slowest primitive); tail_rows stays row-sorted for the
    # Xv segment-sum. 2x tail storage for the tail's ~10% of nonzeros.
    tail_c_rows: np.ndarray | None = None  # (B, T) int32
    tail_c_cols: np.ndarray | None = None  # (B, T) int32 ascending per block
    tail_c_vals: np.ndarray | None = None  # (B, T)

    @property
    def padded_rows(self) -> int:
        return self.indices.shape[1]

    @property
    def max_nnz(self) -> int:
        return self.indices.shape[2]

    @property
    def head_size(self) -> int:
        return 0 if self.head is None else self.head.shape[2]


def pack_rows(rows: Sequence[Mapping], vocab, *, bias: float = 1.0,
              dtype=np.float32, pad_rows_to: int | None = None,
              pad_nnz_to: int | None = None, row_multiple: int = 8,
              nnz_multiple: int = 8) -> Block:
    """Canonical rows -> one padded Block in vocab coordinates.

    Unknown features (not in the frozen vocab) are dropped, matching scoring
    against a fixed model where unseen features contribute nothing
    (reference: LinearModel.eval, LinearModel.java:247-255).
    """
    has_intercept = vocab.intercept_index is not None and bias > 0
    icpt = vocab.intercept_index if has_intercept else 0

    nrows = len(rows)
    max_nnz = 0
    parsed = []
    for row in rows:
        # Accumulate duplicate feature keys within a row; the reference's
        # dense-Hessian path rejects duplicate indices outright
        # (LogisticRegressionL2.java:276-280), summed values are equivalent
        # for every objective term.
        acc: dict[int, float] = {}
        for key, v in row["features"]:
            j = vocab.get(key)
            if j is not None:
                acc[j] = acc.get(j, 0.0) + v
        if has_intercept:
            acc[icpt] = acc.get(icpt, 0.0) + bias
        idx = list(acc.keys())
        val = [acc[j] for j in idx]
        parsed.append((idx, val, row))
        max_nnz = max(max_nnz, len(idx))

    R = pad_rows_to if pad_rows_to is not None else _round_up(max(nrows, 1), row_multiple)
    K = pad_nnz_to if pad_nnz_to is not None else _round_up(max(max_nnz, 1), nnz_multiple)
    if nrows > R:
        raise ValueError(f"pad_rows_to={R} < nrows={nrows}")
    if max_nnz > K:
        raise ValueError(f"pad_nnz_to={K} < max_nnz={max_nnz}")

    indices = np.zeros((R, K), dtype=np.int32)
    values = np.zeros((R, K), dtype=dtype)
    y = np.ones(R, dtype=dtype)
    weight = np.zeros(R, dtype=dtype)
    offset = np.zeros(R, dtype=dtype)

    for i, (idx, val, row) in enumerate(parsed):
        k = len(idx)
        indices[i, :k] = idx
        values[i, :k] = val
        y[i] = 1.0 if row["response"] == 1 else -1.0
        weight[i] = row.get("weight", 1.0)
        offset[i] = row.get("offset", 0.0)

    return Block(indices, values, y, weight, offset, nrows)


def pack_blocks(block_rows: Sequence[Sequence[Mapping]], vocab, *,
                bias: float = 1.0, dtype=np.float32,
                row_multiple: int = 8, nnz_multiple: int = 8) -> BlockedData:
    """List of per-block row lists -> stacked BlockedData with uniform padding."""
    nblocks = len(block_rows)
    max_rows = max((len(rows) for rows in block_rows), default=0)
    max_nnz = 0
    for rows in block_rows:
        for row in rows:
            nnz = sum(1 for k, _ in row["features"] if k in vocab)
            if vocab.intercept_index is not None and bias > 0:
                nnz += 1
            max_nnz = max(max_nnz, nnz)

    R = _round_up(max(max_rows, 1), row_multiple)
    K = _round_up(max(max_nnz, 1), nnz_multiple)

    blocks = [pack_rows(rows, vocab, bias=bias, dtype=dtype,
                        pad_rows_to=R, pad_nnz_to=K)
              for rows in block_rows]

    n = vocab.size
    present = np.zeros((nblocks, n), dtype=bool)
    for b, blk in enumerate(blocks):
        real = blk.weight > 0
        cols = blk.indices[real].ravel()
        vals = blk.values[real].ravel()
        present[b, cols[vals != 0]] = True
        if vocab.intercept_index is not None and bias > 0 and blk.nrows > 0:
            present[b, vocab.intercept_index] = True

    return BlockedData(
        indices=np.stack([b.indices for b in blocks]),
        values=np.stack([b.values for b in blocks]),
        y=np.stack([b.y for b in blocks]),
        weight=np.stack([b.weight for b in blocks]),
        offset=np.stack([b.offset for b in blocks]),
        present=present,
        nrows=np.array([b.nrows for b in blocks], dtype=np.int32),
        nblocks=nblocks,
        dim=n,
    )


def to_hybrid(data: BlockedData, head_size: int, *,
              nnz_multiple: int = 8,
              column_sorted: bool = True,
              head_dtype=None) -> BlockedData:
    """Split a packed dataset into dense-head + sparse-tail hybrid layout.

    head_dtype: store the dense head in this dtype (e.g. bfloat16) instead
    of the values dtype. At 100M-row scale the f32 head is the largest
    single host allocation (~51 GB); building-then-casting per call keeps
    the peak at one group's f32 head instead of all of them (the streaming
    trainer's later dtype normalization then no-ops on the head).

    head_ids = the `head_size` most frequent columns across all blocks
    (weighted by nonzero count; the intercept's bias column is in every row,
    so it always lands in the head). Nonzeros on head columns move into the
    dense (B, R, H) matrix; the ELL arrays are repacked with only the tail,
    whose per-row width shrinks accordingly.

    column_sorted=False skips building the column-sorted tail copy (the
    tail_c_* arrays are left None): the streaming trainer derives it ON
    DEVICE per transfer (a stable argsort is a pure function of tail_cols),
    which removes both the host-side sort at pack time and ~43% of the
    per-iteration tail wire traffic.
    """
    B, R, K = data.indices.shape
    H = min(head_size, data.dim)
    if H <= 0:
        return data

    flat_idx = data.indices.reshape(-1)
    flat_val = data.values.reshape(-1)
    counts = np.bincount(flat_idx[flat_val != 0], minlength=data.dim)
    head_ids = np.sort(np.argsort(-counts, kind="stable")[:H]).astype(np.int32)
    head_pos = np.full(data.dim, -1, np.int32)
    head_pos[head_ids] = np.arange(H, dtype=np.int32)

    is_head = (head_pos[data.indices] >= 0) & (data.values != 0)  # (B,R,K)

    b_ix, r_ix, k_ix = np.nonzero(is_head)
    h_ix = head_pos[data.indices[b_ix, r_ix, k_ix]]
    vals = data.values[b_ix, r_ix, k_ix]
    flat = (b_ix * R + r_ix) * np.int64(H) + h_ix
    # duplicate-free fast path (the overwhelmingly common case: a feature
    # appears once per row): scatter the values STRAIGHT into the target
    # dtype — skips both np.add.at (~10x slower than fancy assignment at
    # 100M-scale head nnz) and the separate whole-head cast pass (the two
    # dominant terms of the measured hybrid phase). Exact: one contribution
    # per slot makes assign-with-convert bitwise equal to cast(sum).
    # sampled early exit: dup-heavy corpora (the CTR set runs ~29% dup
    # pairs) reveal themselves in the first chunk for ~ms instead of a
    # full 2-3 s sort; only a clean sample pays the exact whole-set check
    probe = np.sort(flat[:min(len(flat), 1 << 20)])
    has_dup = bool(np.any(probe[1:] == probe[:-1]))
    del probe
    if not has_dup and len(flat) > (1 << 20):
        flat_sorted = np.sort(flat)
        has_dup = bool(np.any(flat_sorted[1:] == flat_sorted[:-1]))
        del flat_sorted
    if not has_dup:
        head = np.zeros((B, R, H),
                        head_dtype if head_dtype is not None
                        else data.values.dtype)
        head.reshape(-1)[flat] = vals
    else:  # exact duplicate-summing fallback (reference ELL semantics)
        head = np.zeros((B, R, H), data.values.dtype)
        np.add.at(head.reshape(-1), flat, vals)
    del flat, vals, h_ix

    # tail goes to flat COO per block: no per-row padding at all (an ELL tail
    # would be almost entirely padding since hot columns carry most nonzeros)
    tail_mask = (~is_head) & (data.values != 0)
    per_block = tail_mask.reshape(B, -1).sum(axis=1)
    T = _round_up(max(int(per_block.max(initial=0)), 1), 128)
    # pad entries carry (row R-1, col n-1, val 0): the zero value makes
    # them semantic no-ops under every reduce; row R-1 keeps the appended
    # padding SORTED in the row stream (the boundary-diff reduce in
    # ops/segsum.py requires truly ascending ids, not just the
    # indices_are_sorted hint a scatter-add ignores); col n-1 makes the
    # stable column sort place the same pads at the END of the
    # column-sorted copy too, so padding never SHIFTS real entries across
    # prefix tiles — layout padding stays a bit-exact no-op
    tail_rows = np.full((B, T), R - 1, np.int32)
    tail_cols = np.full((B, T), data.dim - 1, np.int32)
    tail_vals = np.zeros((B, T), data.values.dtype)
    row_of_slot = np.broadcast_to(
        np.arange(R, dtype=np.int32)[:, None], (R, K))
    for b in range(B):
        m = tail_mask[b]
        t = int(m.sum())
        tail_rows[b, :t] = row_of_slot[m]
        tail_cols[b, :t] = data.indices[b][m]
        tail_vals[b, :t] = data.values[b][m]

    # column-sorted copy of the tail; padding (val 0, col n-1) sorts to
    # the END and contributes nothing to the last segment
    tc_rows = tc_cols = tc_vals = None
    if column_sorted:
        tc_rows = np.zeros_like(tail_rows)
        tc_cols = np.zeros_like(tail_cols)
        tc_vals = np.zeros_like(tail_vals)
        for b in range(B):
            ordc = np.argsort(tail_cols[b], kind="stable")
            tc_rows[b] = tail_rows[b][ordc]
            tc_cols[b] = tail_cols[b][ordc]
            tc_vals[b] = tail_vals[b][ordc]

    if head_dtype is not None and head.dtype != np.dtype(head_dtype):
        head = np.asarray(head, head_dtype)
    empty = np.zeros((B, R, 0))
    return data._replace(indices=empty.astype(np.int32),
                         values=empty.astype(data.values.dtype),
                         head=head, head_ids=head_ids,
                         tail_rows=tail_rows, tail_cols=tail_cols,
                         tail_vals=tail_vals,
                         tail_c_rows=tc_rows, tail_c_cols=tc_cols,
                         tail_c_vals=tc_vals)


def csc_arrays(data: BlockedData) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Column-sorted dual layout of every block's nonzeros.

    Returns (cols, rows, vals), each (B, R*K): the same nonzeros as the ELL
    layout flattened and stably sorted by column id per block. Padding slots
    (value 0, column 0) sort to the front and contribute nothing. Static per
    dataset — computed once at pack time, reused every solver pass.
    """
    B, R, K = data.indices.shape
    cols = data.indices.reshape(B, -1)
    vals = data.values.reshape(B, -1)
    rows = np.broadcast_to(np.arange(R, dtype=np.int32)[:, None],
                           (R, K)).reshape(-1)
    out_cols = np.empty_like(cols)
    out_rows = np.empty((B, R * K), np.int32)
    out_vals = np.empty_like(vals)
    for b in range(B):
        order = np.argsort(cols[b], kind="stable")
        out_cols[b] = cols[b][order]
        out_rows[b] = rows[order]
        out_vals[b] = vals[b][order]
    return out_cols, out_rows, out_vals


def partition_rows(rows: Iterable[Mapping], keys: Iterable[str],
                   nblocks: int) -> list[list[Mapping]]:
    """Group prepared rows by integer partition key into nblocks lists."""
    out: list[list[Mapping]] = [[] for _ in range(nblocks)]
    for row, key in zip(rows, keys):
        k = int(key)
        if k < 0 or k >= nblocks:
            raise ValueError(
                f"Map key is wrong! key has to be in the range of [0,{nblocks - 1}].")
        out[k].append(row)
    return out


def split_blocks(data: BlockedData, n_groups: int) -> list[BlockedData]:
    """Split a packed dataset into n_groups block-axis groups for the
    streaming (>HBM) trainer. Block-leading arrays slice; head_ids (shared
    column ids) replicate. Groups cover all blocks in order."""
    B = data.nblocks
    n_groups = max(1, min(n_groups, B))
    bounds = np.linspace(0, B, n_groups + 1).astype(int)

    def sl(a, lo, hi):
        return None if a is None else a[lo:hi]

    out = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi <= lo:
            continue
        out.append(BlockedData(
            indices=data.indices[lo:hi], values=data.values[lo:hi],
            y=data.y[lo:hi], weight=data.weight[lo:hi],
            offset=data.offset[lo:hi], present=data.present[lo:hi],
            nrows=data.nrows[lo:hi], nblocks=int(hi - lo), dim=data.dim,
            head=sl(data.head, lo, hi), head_ids=data.head_ids,
            tail_rows=sl(data.tail_rows, lo, hi),
            tail_cols=sl(data.tail_cols, lo, hi),
            tail_vals=sl(data.tail_vals, lo, hi),
            tail_c_rows=sl(data.tail_c_rows, lo, hi),
            tail_c_cols=sl(data.tail_c_cols, lo, hi),
            tail_c_vals=sl(data.tail_c_vals, lo, hi)))
    return out
