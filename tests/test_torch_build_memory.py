"""The streaming build's host memory: the train pipeline hands the
StreamingAdmmTrainer the only reference to each group
(train/pipeline.py::_streaming_trainer), so each group's host arrays are
freed once their page-locked copies exist, and a group's ELL once its
hybrid form exists. On the card `_lock` copies into page-locked memory;
on the CPU it returns its input, so here it is stubbed with a copy, as
the card makes one.

The breast-cancer job (float64, 4 blocks) streamed in 2 groups with
head.size 16, 2 iterations, through the three routes of the pipeline: the
pack cache written (the pipeline converts to hybrid), the pack cache hit
(the groups loaded from it), and no cache (the trainer converts). Held:
no weakref to an original array survives where it should be gone (the
packed data once split, a group's ELL once the next group is converted,
a handed group once the next group is pinned, all of them once the build
returns); a trainer built from a list its caller keeps leaves that list
intact and pins the same bits; both give the same z bit for bit, and the
pipeline's z equals the JAX pipeline's to 1e-8 (the tolerance of
tests/test_torch_pipeline.py's streamed jobs).
"""

import os
import weakref

import numpy as np
import pytest
import torch

from mlease_tpu.train.pipeline import run_regression_pipeline as jax_pipeline
from mlease_tpu.utils.config import JobConfig
import mlease_tpu_torch.train.pipeline as tpl
import mlease_tpu_torch.train.streaming as tst
from mlease_tpu_torch.core.dataset import BlockedData
from mlease_tpu_torch.train.streaming import StreamingAdmmTrainer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "examples", "data", "breast-cancer")
ITERS = 2


def job(out, **extra) -> JobConfig:
    props = dict(JobConfig.from_file(os.path.join(REPO, "examples", "data",
                                                  "breast-cancer.job")))
    props.update({"input.paths": os.path.join(DATA, "train"),
                  "test.path": os.path.join(DATA, "test"),
                  "output.base.path": out, "head.size": "16",
                  "streaming.groups": "2", "num.iters": str(ITERS)})
    props.update(extra)
    return JobConfig(props)


def arrays(g: BlockedData, fields=BlockedData._fields):
    """The arrays of a group's fields, each numpy array with the arrays it
    views (a view keeps its base alive)."""
    for f in fields:
        a = getattr(g, f)
        while isinstance(a, (np.ndarray, torch.Tensor)):
            yield a
            a = a.base if isinstance(a, np.ndarray) else None


def copied(g: BlockedData) -> BlockedData:
    return g._replace(**{f: (a.clone() if isinstance(a, torch.Tensor)
                             else np.array(a))
                         for f, a in g._asdict().items()
                         if isinstance(a, (np.ndarray, torch.Tensor))})


def same_bits(a, b) -> bool:
    if isinstance(a, np.ndarray):
        a, b = torch.from_numpy(np.ascontiguousarray(a)), \
            torch.from_numpy(np.ascontiguousarray(b))
    return (a.dtype == b.dtype and a.shape == b.shape
            and (a.numel() == 0
                 or torch.equal(a.contiguous().view(torch.uint8),
                                b.contiguous().view(torch.uint8))))


def held(tr):
    """Every array the trainer keeps for its groups, in order."""
    return [a for a in tst._flat_tensors(
        (tr.groups, list(tr._wire.values()), tr.csc_perms))] + \
        [g.nrows for g in tr.groups]


class Watch:
    """Weakrefs to the arrays that must go, and where they were found
    still alive."""

    def __init__(self):
        self.refs: list = []    # (what, group index, weakref)
        self.late: list = []
        self.runs: list = []    # (z of the hand-off build, of the kept one)
        self.checked = []
        self.active = True      # until the pipeline's trainer is built

    def track(self, what, gi, group, fields=BlockedData._fields):
        self.refs += [(what, gi, weakref.ref(a))
                      for a in arrays(group, fields)]

    def gone(self, what, below, where):
        alive = {gi for w, gi, r in self.refs
                 if w == what and gi < below and r() is not None}
        self.late += [f"{what} of group {gi} alive {where}"
                      for gi in sorted(alive)]


def watched(monkeypatch):
    """The pipeline with `_lock` copying, and watches on its split, its
    and the trainer's hybrid conversions, the trainer's pinning and the
    trainer it builds."""
    w = Watch()
    monkeypatch.setattr(StreamingAdmmTrainer, "_lock",
                        lambda self, t: t.clone())
    split = tpl.split_blocks

    def watched_split(data, n):
        w.track("data", 0, data)
        out = split(data, n)
        for gi, g in enumerate(out):
            w.track("ell", gi, g, ("indices", "values"))
        return out
    monkeypatch.setattr(tpl, "split_blocks", watched_split)

    for module in (tpl, tst):
        def watched_hybrid(g, *a, _to=module.to_hybrid, **kw):
            if not w.active:
                return _to(g, *a, **kw)
            k = sum(r[0] == "hybrid" for r in w.checked)
            w.checked.append(("hybrid", k))
            w.gone("data", 1, "at the first hybrid conversion")
            w.gone("ell", k, f"when group {k} is converted")
            return _to(g, *a, **kw)
        monkeypatch.setattr(module, "to_hybrid", watched_hybrid)

    host_group = StreamingAdmmTrainer._host_group

    def watched_host_group(self, g):
        if getattr(self, "_watch", None) is w:
            k = len(self.groups)
            w.checked.append(("pin", k))
            w.gone("handed", k, f"when group {k} is pinned")
        return host_group(self, g)
    monkeypatch.setattr(StreamingAdmmTrainer, "_host_group",
                        watched_host_group)

    class Probe(StreamingAdmmTrainer):
        def __init__(self, groups, vocab, cfg, **kw):
            items = list(groups)       # what the pipeline handed over
            for gi in range(len(items)):
                w.track("handed", gi, items[gi])
            kept = [copied(g) for g in items]
            snapshot = [copied(g) for g in items]

            def hand():
                while items:
                    yield items.pop(0)
            self._watch = w
            super().__init__(hand(), vocab, cfg, **kw)
            for what in ("data", "ell", "handed"):
                w.gone(what, len(kept), "once the build returned")
            w.active = False
            # a caller that keeps its list: left intact, the same bits
            entries = list(kept)
            self._kept = StreamingAdmmTrainer(kept, vocab, cfg, **kw)
            assert all(a is b for a, b in zip(kept, entries))
            assert len(kept) == len(entries)
            for g, s in zip(kept, snapshot):
                assert all(same_bits(a, b) for a, b in zip(
                    arrays(g, g._fields), arrays(s, s._fields)))
            mine, theirs = held(self), held(self._kept)
            assert len(mine) == len(theirs) > 0
            assert all(same_bits(a, b) for a, b in zip(mine, theirs))

        def run(self, *a, **kw):
            res = super().run(*a, **kw)
            kw.pop("callback", None)
            w.runs.append((res.z, self._kept.run(*a, **kw).z))
            return res
    monkeypatch.setattr(tpl, "StreamingAdmmTrainer", Probe)
    return w


@pytest.fixture(scope="module")
def jax_z(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax-out"))
    return jax_pipeline(job(out)).z


@pytest.mark.parametrize("route", ["cache-write", "cache-hit", "no-cache"])
def test_each_group_is_freed_once_pinned(route, tmp_path, monkeypatch,
                                         jax_z):
    extra = ({} if route == "no-cache"
             else {"pack.cache.dir": str(tmp_path / "cache")})
    if route == "cache-hit":            # write the cache first, unwatched
        monkeypatch.setattr(StreamingAdmmTrainer, "_lock",
                            lambda self, t: t.clone())
        tpl.run_regression_pipeline(job(str(tmp_path / "first"), **extra),
                                    device="cpu")
        monkeypatch.undo()
    w = watched(monkeypatch)
    res = tpl.run_regression_pipeline(job(str(tmp_path / "out"), **extra),
                                      device="cpu")
    assert not w.late, w.late
    kinds = [k for k, _ in w.checked]
    assert kinds.count("pin") == 2
    assert kinds.count("hybrid") == (0 if route == "cache-hit" else 2)
    assert {r[0] for r in w.refs} == (
        {"handed"} if route == "cache-hit" else {"data", "ell", "handed"})
    assert all(r() is None for _w, _gi, r in w.refs)
    assert res.iterations == ITERS and len(w.runs) == 1
    z, z_kept = w.runs[0]
    assert same_bits(torch.as_tensor(z), torch.as_tensor(z_kept))
    np.testing.assert_allclose(res.z, jax_z, rtol=0, atol=1e-8)


@pytest.mark.parametrize("replicates", [1, 2])
def test_pack_in_chunks_equals_the_jax_pack(monkeypatch, replicates):
    """pack_blocks_columnar expands PACK_CHUNK_ROWS rows at a time (the
    JAX package all at once): at chunks of 7 rows, the breast-cancer rows
    pack to the JAX package's arrays."""
    import mlease_tpu.core.ingest as jingest
    import mlease_tpu_torch.core.ingest as tingest

    dec = tingest.decode_files_parallel(
        [os.path.join(DATA, "train", f)
         for f in sorted(os.listdir(os.path.join(DATA, "train")))])
    dec = tingest.merge_decoded(dec)
    prep = tingest.prepare_columnar(dec, 4,
                                    num_click_replicates=replicates, seed=3)
    monkeypatch.setattr(tingest, "PACK_CHUNK_ROWS", 7)
    got = tingest.pack_blocks_columnar(
        dec, *prep, tingest.vocab_from_names(dec.vocab_names), nblocks=4)
    want = jingest.pack_blocks_columnar(
        dec, *prep, jingest.vocab_from_names(dec.vocab_names), nblocks=4)
    assert len(prep[0]) > 7 * 10
    for f in ("indices", "values", "y", "weight", "offset", "present",
              "nrows"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
