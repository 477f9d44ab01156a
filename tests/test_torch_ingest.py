"""The port's native Avro codec and columnar ingest (mlease_tpu_torch/native,
io/fast_decode.py, io/fast_encode.py, core/ingest.py, the `item` CLI's
columnar route) against the JAX package's, on the same Avro files.

The JAX functions run on a library compiled here from the JAX package's own
`native/*.cpp` (unedited) into a temporary directory and bound through
`mlease_tpu.io.fast_decode`: that module's shared library is built in place
at first use, which several test workers may race for, and a test here must
count the same in every run. Both libraries need a C++ compiler: these tests
skip only where none is on PATH, and fail when one is present and a build
fails.

Tolerances: decoded arrays, encoder bytes and packed arrays are equal
exactly; the item models of the columnar CLI route to 1e-6 (float64).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import mlease_tpu.core.ingest as jingest
import mlease_tpu.io.fast_decode as jfd
import mlease_tpu.io.fast_encode as jfe
import mlease_tpu_torch.core.ingest as tingest
import mlease_tpu_torch.io.fast_decode as tfd
import mlease_tpu_torch.io.fast_encode as tfe
from mlease_tpu.cli import main as jmain
from mlease_tpu.io import avro as javro
from mlease_tpu.io.records import normalize_row
from mlease_tpu_torch.cli import main as tmain
from mlease_tpu_torch.io import _native_build
from mlease_tpu_torch.io import avro as tavro

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ITEM_SCHEMA = {
    "type": "record", "name": "row", "fields": [
        {"name": "item", "type": "string"},
        {"name": "response", "type": "int"},
        {"name": "features", "type": {"type": "array", "items": {
            "type": "record", "name": "feature", "fields": [
                {"name": "name", "type": "string"},
                {"name": "term", "type": "string"},
                {"name": "value", "type": "float"}]}}},
        {"name": "weight", "type": "float"},
        {"name": "offset", "type": "float"},
    ]}

CTR_SCHEMA = {
    "type": "record", "name": "CtrRow", "namespace": "mlease.examples",
    "fields": [
        {"name": "response", "type": "int"},
        {"name": "features", "type": {"type": "array", "items": {
            "type": "record", "name": "feature", "fields": [
                {"name": "name", "type": "string"},
                {"name": "term", "type": "string"},
                {"name": "value", "type": "float"}]}}},
        {"name": "weight", "type": "float"},
        {"name": "offset", "type": "float"},
    ]}

FIELDS = ("response", "weight", "offset", "row_start", "feat_id", "feat_val")


def need_compiler():
    if _native_build.compiler() is None:
        pytest.skip("no C++ compiler on PATH (g++ or c++)")


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """mlease_tpu.io.fast_decode bound to a private build of native/."""
    need_compiler()
    out = tmp_path_factory.mktemp("jax-native") / "libmlease_native.so"
    srcs = [os.path.join(REPO, "native", f)
            for f in ("avro_decode.cpp", "avro_encode.cpp")]
    subprocess.run([_native_build.compiler(), *_native_build.CXXFLAGS, *srcs,
                    "-o", str(out), *_native_build.LDFLAGS], check=True,
                   capture_output=True, timeout=300)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfd, "_LIB_PATH", str(out))
        mp.setattr(jfd, "_lib", None)
        mp.setattr(jfd, "_tried", False)
        assert jfd.is_available() and jfe.is_available()
        yield jfd


@pytest.fixture(scope="module")
def port_native():
    need_compiler()
    assert tfd.is_available(), "the port's native codec did not build"
    return tfd


def rows(n=1500, seed=0, n_items=7):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(0, 8))
        names = rng.choice(300, size=k, replace=False)
        out.append({
            "item": f"it{int(rng.integers(0, n_items))}",
            "response": int(rng.random() < 0.3),
            "features": [{"name": f"f{int(j)}",
                          "term": ["", "t1", "t2"][int(rng.integers(0, 3))],
                          "value": float(np.float32(rng.normal()))}
                         for j in names],
            "weight": float(np.float32(1.0 + (i % 3))),
            "offset": float(np.float32(0.125 * (i % 4)))})
    return out


def assert_same_decode(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.vocab_names == want.vocab_names
    assert got.keys == want.keys


@pytest.mark.parametrize("codec,nthreads,ignore_value", [
    ("null", 1, False), ("deflate", 1, False), ("deflate", 4, False),
    ("null", 0, True)])
def test_decode_file_equals_jax(tmp_path, jax_native, port_native, codec,
                                nthreads, ignore_value):
    recs = rows()
    path = str(tmp_path / "rows.avro")
    tavro.write_records(path, ITEM_SCHEMA, recs, codec=codec,
                        block_records=100)
    kw = dict(map_key="item", nthreads=nthreads, ignore_value=ignore_value)
    got = tfd.decode_file(path, **kw)
    want = jfd.decode_file(path, **kw)
    assert_same_decode(got, want)
    # and both agree with the record-at-a-time codec
    ref = [normalize_row(r, ignore_value=ignore_value)
           for r in javro.read_records(path)]
    assert got.num_rows == len(ref) == len(recs)
    for i in (0, 17, len(ref) - 1):
        s, e = got.row_start[i], got.row_start[i + 1]
        assert dict(ref[i]["features"]) == {
            got.vocab_names[got.feat_id[j]]: float(got.feat_val[j])
            for j in range(s, e)}
        assert got.response[i] == ref[i]["response"]


def test_multi_file_decode_and_merge_equal_jax(tmp_path, jax_native,
                                                port_native):
    recs = rows(2000, seed=1)
    paths = []
    for p, part in enumerate((recs[:700], recs[700:1500], recs[1500:])):
        paths.append(str(tmp_path / f"part-{p}.avro"))
        tavro.write_records(paths[-1], ITEM_SCHEMA, part,
                            codec=("deflate", "null")[p % 2],
                            block_records=64)
    got = tingest.merge_decoded(tingest.decode_files_parallel(
        paths, map_key="item"))
    want = jingest.merge_decoded(jingest.decode_files_parallel(
        paths, map_key="item"))
    assert_same_decode(got, want)
    single = str(tmp_path / "all.avro")
    tavro.write_records(single, ITEM_SCHEMA, recs)
    assert_same_decode(got, tfd.decode_file(single, map_key="item"))


@pytest.mark.parametrize("replicates,ignore_value", [(1, False), (3, True)])
def test_prepare_and_pack_columnar_equal_jax(tmp_path, jax_native,
                                             port_native, replicates,
                                             ignore_value):
    recs = rows(1200, seed=2)
    path = str(tmp_path / "train.avro")
    tavro.write_records(path, ITEM_SCHEMA, recs, codec="deflate")
    dec_t = tfd.decode_file(path, ignore_value=ignore_value)
    dec_j = jfd.decode_file(path, ignore_value=ignore_value)
    assert_same_decode(dec_t, dec_j)
    vt = tingest.vocab_from_names(dec_t.vocab_names)
    vj = jingest.vocab_from_names(dec_j.vocab_names)
    assert vt.names == vj.names
    pt = tingest.prepare_columnar(dec_t, 5, num_click_replicates=replicates,
                                  seed=7)
    pj = jingest.prepare_columnar(dec_j, 5, num_click_replicates=replicates,
                                  seed=7)
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a, b)
    dt = tingest.pack_blocks_columnar(dec_t, *pt, vt, nblocks=5)
    dj = jingest.pack_blocks_columnar(dec_j, *pj, vj, nblocks=5)
    for f in ("indices", "values", "y", "weight", "offset", "present",
              "nrows"):
        a, b = getattr(dt, f), getattr(dj, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (dt.nblocks, dt.dim) == (dj.nblocks, dj.dim)
    dt2, vt2 = tingest.load_blocked_data(
        [path], 5, num_click_replicates=replicates,
        ignore_value=ignore_value, seed=7)
    np.testing.assert_array_equal(dt2.indices, dt.indices)
    assert vt2.names == vt.names


def test_keyed_rows_equal_jax(tmp_path, jax_native, port_native):
    recs = rows(600, seed=3)
    path = str(tmp_path / "items.avro")
    tavro.write_records(path, ITEM_SCHEMA, recs)
    assert tingest.load_keyed_rows(path, "item") == \
        jingest.load_keyed_rows(path, "item")


def test_encoder_bytes_equal_jax(tmp_path, jax_native, port_native):
    rng = np.random.default_rng(3)
    m, k = 300, 12
    cols = rng.integers(0, 10 ** 6, size=(m, k)).astype(np.int32)
    vals = rng.normal(size=(m, k)).astype(np.float32)
    y = rng.integers(0, 2, size=m).astype(np.int32)
    w = rng.random(m).astype(np.float32)
    off = (rng.random(m) * 0.25).astype(np.float32)
    for extra in ((), (w, off)):
        got = tfe.encode_ctr_block(cols, vals, y, *extra)
        assert got == jfe.encode_ctr_block(cols, vals, y, *extra)
    # the port's writer around it: the same file bytes as the Python codec
    path = str(tmp_path / "enc.avro")
    with tavro.AvroFileWriter(path, CTR_SCHEMA, codec="null") as wtr:
        wtr.append_raw_block(tfe.encode_ctr_block(cols, vals, y, w, off), m)
    dec = tfd.decode_file(path)
    np.testing.assert_array_equal(dec.response, y)
    np.testing.assert_array_equal(dec.feat_val, vals.reshape(-1))
    np.testing.assert_array_equal(dec.weight, w)
    assert dec.vocab_names[dec.feat_id[5]] == f"f{cols[0, 5]}"
    with pytest.raises(ValueError):
        tfe.encode_ctr_block(cols, vals[:-1], y)


def test_item_cli_columnar_route_equals_jax(tmp_path, capsys, jax_native,
                                           port_native):
    recs = rows(480, seed=4, n_items=5)
    data = str(tmp_path / "items.avro")
    tavro.write_records(data, ITEM_SCHEMA, recs, codec="deflate")
    outs = {}
    for tag, main, extra in (("torch", tmain, ["--device", "cpu"]),
                             ("jax", jmain, [])):
        job = tmp_path / f"{tag}.job"
        props = {"input.paths": data, "item.key": "item",
                 "intercept.lambdas": "1", "default.lambdas": "1,4",
                 "compute.var": "true", "liblinear.epsilon": "1e-6",
                 "dtype": "float64", "native.ingest": "true",
                 "output.model.path": str(tmp_path / f"{tag}-models")}
        job.write_text("".join(f"{k}={v}\n" for k, v in props.items()))
        assert main(["item", str(job), *extra]) == 0
        outs[tag] = json.loads(
            capsys.readouterr().out.strip().splitlines()[-1])
    t_models = {r["key"]: r for r in tavro.read_records(outs["torch"][
        "output"])}
    j_models = {r["key"]: r for r in javro.read_records(outs["jax"][
        "output"])}
    assert sorted(t_models) == sorted(j_models) and len(t_models) == 10
    for key, rec in j_models.items():
        want = {(c["name"], c["term"]): c["value"] for c in rec["model"]}
        got = {(c["name"], c["term"]): c["value"]
               for c in t_models[key]["model"]}
        assert sorted(got) == sorted(want)
        np.testing.assert_allclose([got[c] for c in sorted(want)],
                                   [want[c] for c in sorted(want)],
                                   rtol=1e-6, atol=1e-9)


CHILD = """
import ctypes, sys
from pathlib import Path
import mlease_tpu_torch.io._native_build as nb
nb.BUILD_DIR = Path(sys.argv[1])
while __import__("time").time() < float(sys.argv[2]):
    pass
path = nb.build()
lib = ctypes.CDLL(str(path))
assert hasattr(lib, "mlease_decode_blocks_mt")
print(path)
"""


def test_four_processes_building_at_once_all_load(tmp_path):
    need_compiler()
    build_dir = tmp_path / "build"
    start = time.time() + 1.5
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(build_dir), str(start)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    paths = {out.strip() for out, _err in outs}
    assert len(paths) == 1
    built = sorted(f.name for f in build_dir.iterdir())
    assert built == sorted([os.path.basename(paths.pop()), "native.lock"])


def test_threads_loading_at_once_all_get_the_library(monkeypatch,
                                                     port_native):
    """The first load on one thread while others call it: every thread
    gets the library (the others wait for the first), none gets None."""
    import threading
    build = _native_build.build

    def slow_build():
        time.sleep(0.3)             # the first load's compile in progress
        return build()
    monkeypatch.setattr(_native_build, "build", slow_build)
    monkeypatch.setattr(tfd, "_lib", None)
    monkeypatch.setattr(tfd, "_tried", False)
    barrier = threading.Barrier(4)
    got = []

    def load():
        barrier.wait()
        got.append(tfe.is_available())
    threads = [threading.Thread(target=load) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert got == [True] * 4


def test_schema_without_one_response_column_falls_back(tmp_path,
                                                       port_native):
    schema = {"type": "record", "name": "r", "fields": [
        {"name": "click", "type": "int"}, {"name": "label", "type": "int"},
        {"name": "features", "type": {"type": "array", "items": {
            "type": "record", "name": "f", "fields": [
                {"name": "name", "type": "string"},
                {"name": "value", "type": "float"}]}}}]}
    path = str(tmp_path / "two.avro")
    tavro.write_records(path, schema, [{"click": 1, "label": 0,
                                        "features": []}])
    with pytest.raises(tfd.DescriptorError):
        tfd.decode_file(path)
