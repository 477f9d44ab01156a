"""The port's subpackages export what the JAX package's do (ROADMAP.md C7),
minus the names that have no counterpart in the port; every module of the
JAX package has its counterpart defining the same public names (read from
the sources with `ast`, nothing imported), but for the by-design gaps of
BY_DESIGN; its copy of core/partition_ids.py (A9) gives the same ids and
files, and its read_lambda_rho reads the JAX package's file."""

import ast
import importlib
from pathlib import Path

import pytest

from mlease_tpu.core import partition_ids as jpi
from mlease_tpu_torch.core import partition_ids as tpi

REPO = Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = REPO / "mlease_tpu", REPO / "mlease_tpu_torch"

# what of the JAX package the port does not have, each with its reason
# (ROADMAP.md "Not to port, by design"): a module path, or module::name
BY_DESIGN = {
    "ops/segsum.py": "the TPU's boundary-diff tail reduce; K1 reduces every "
                     "sorted tail on the card",
    "ops/pallas/__init__.py": "the Pallas kernels' package; the port's "
                              "kernels are in csrc/ behind ops/",
    "ops/pallas/gram.py": "K2 on the TPU; ported as csrc/gram*.cu behind "
                          "ops/gram.py",
    "ops/pallas/tile_sum.py": "K1 on the TPU; ported as csrc/segment_sum.cu "
                              "behind ops/segment_sum.py",
    "utils/cache.py": "the JAX compile cache; the port caches its built "
                      "libraries by source hash",
    "ops/tron_multi.py::BOUNDARY_DIFF_MIN_ENTRIES":
        "the TPU's size gate of the boundary-diff reduce; K1 takes every "
        "sorted tail, with no gate",
    "parallel/mesh.py::cpu_devices": "XLA's virtual host devices; a CPU "
                                     "mesh of the port is gloo ranks",
    "train/admm.py::build_loglik_fn": "a jax.jit factory; "
                                      "sample_loglik_lanes is that function",
    "utils/profiling.py::Timings": "the port's spans are one bounded store "
                                   "(profiling.span, recorded)",
}


def public_names(path: Path) -> tuple[set, dict]:
    """(public top-level def/class/assigned names, {public class: its public
    methods}) of one source file."""
    names, classes = set(), {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign):
            found = [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            found = [node.target.id]
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            found = [node.name]
            if isinstance(node, ast.ClassDef):
                classes[node.name] = {
                    b.name for b in node.body
                    if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and not b.name.startswith("_")}
        else:
            continue
        names.update(f for f in found if not f.startswith("_"))
    return names, {c: m for c, m in classes.items() if c in names}


JAX_MODULES = sorted(p.relative_to(JAX_PKG).as_posix()
                     for p in JAX_PKG.rglob("*.py"))


@pytest.mark.parametrize("module", JAX_MODULES)
def test_module_public_names_match_jax(module):
    """The counterpart of this JAX module exists and defines every public
    name and every public method of each public class, or the gap is in
    BY_DESIGN."""
    port = PORT_PKG / module
    if module in BY_DESIGN:
        assert not port.exists(), f"{module} is ported: drop it from BY_DESIGN"
        return
    assert port.exists(), f"no counterpart of mlease_tpu/{module}"
    jnames, jclasses = public_names(JAX_PKG / module)
    tnames, tclasses = public_names(port)
    missing = {f"{module}::{n}" for n in jnames - tnames}
    assert missing <= set(BY_DESIGN), sorted(missing - set(BY_DESIGN))
    for cls, methods in jclasses.items():
        if cls in tclasses:
            assert methods <= tclasses[cls], (cls, sorted(methods
                                                          - tclasses[cls]))


def test_by_design_gaps_are_gaps():
    """Every BY_DESIGN entry names a file or name of the JAX package that
    the port really lacks (a stale entry fails)."""
    for entry in BY_DESIGN:
        module, _, name = entry.partition("::")
        assert (JAX_PKG / module).exists(), entry
        if name:
            assert name in public_names(JAX_PKG / module)[0], entry
            assert name not in public_names(PORT_PKG / module)[0], entry
        else:
            assert not (PORT_PKG / module).exists(), entry
    assert len(BY_DESIGN) == 9


def test_read_lambda_rho_matches_jax(tmp_path):
    """A LambdaRhoMap file written by either package reads to the same dict
    with the other package's reader (tests/test_parity_utils.py:26)."""
    from mlease_tpu.io import avro as javro
    from mlease_tpu.io import schemas as jschemas
    from mlease_tpu.train.pipeline import read_lambda_rho as jread
    from mlease_tpu_torch.io import avro as tavro
    from mlease_tpu_torch.io import schemas as tschemas
    from mlease_tpu_torch.train.pipeline import read_lambda_rho as tread

    recs = [{"lambda": 1.0, "rho": 2.0}, {"lambda": 10.0, "rho": 1.0},
            {"lambda": 0.125, "rho": 12345678.0}]
    jpath, tpath = str(tmp_path / "j.avro"), str(tmp_path / "t.avro")
    javro.write_records(jpath, jschemas.LAMBDA_RHO_MAP, recs)
    tavro.write_records(tpath, tschemas.LAMBDA_RHO_MAP, recs)
    want = {1.0: 2.0, 10.0: 1.0, 0.125: 12345678.0}
    assert tread(jpath) == jread(tpath) == jread(jpath) == want
    assert tread(tpath) == want

# cpu_devices lists the XLA host devices of a virtual multi-device mesh; a
# CPU mesh of the port is gloo ranks, one process each (no device list)
UNPORTED = {"parallel": {"cpu_devices"}}


@pytest.mark.parametrize("sub", ["core", "eval", "io", "ops", "parallel",
                                 "train", "utils"])
def test_subpackage_all_matches_jax(sub):
    jax_mod = importlib.import_module(f"mlease_tpu.{sub}")
    port = importlib.import_module(f"mlease_tpu_torch.{sub}")
    assert port.__all__ == [n for n in jax_mod.__all__
                            if n not in UNPORTED.get(sub, set())]
    for name in port.__all__:
        obj = getattr(port, name)
        where = getattr(obj, "__module__", None) or getattr(obj, "__name__",
                                                            "")
        if where:
            assert where.startswith("mlease_tpu_torch"), (name, where)


def test_parallel_is_not_ported():
    """What of the JAX package's parallel/ is not ported: cpu_devices
    alone; its modules and every other name are (the mesh, A8)."""
    import mlease_tpu.parallel as jpar
    port = importlib.import_module("mlease_tpu_torch.parallel")
    assert not hasattr(port, "cpu_devices")
    assert set(jpar.__all__) - set(port.__all__) == {"cpu_devices"}
    from mlease_tpu.parallel import distributed as jdist
    from mlease_tpu.parallel import mesh as jmesh
    from mlease_tpu_torch.parallel import distributed as tdist
    from mlease_tpu_torch.parallel import mesh as tmesh
    for name in ("initialize", "global_mesh", "host_block_range",
                 "make_global_blocked_arrays"):
        assert callable(getattr(jdist, name)) and callable(getattr(tdist,
                                                                   name))
    for name in ("BLOCK_AXIS", "FEAT_AXIS", "make_mesh", "make_mesh_2d",
                 "block_sharding", "replicated", "pad_blocks",
                 "shard_blocked_arrays"):
        assert hasattr(jmesh, name) and hasattr(tmesh, name), name
    assert (tmesh.BLOCK_AXIS, tmesh.FEAT_AXIS) == (jmesh.BLOCK_AXIS,
                                                   jmesh.FEAT_AXIS)


@pytest.mark.parametrize("lambdas", [None, [1.0, 0.5, 1e-4, 12345678.0]])
def test_partition_ids_match_jax(tmp_path, lambdas):
    keys = ["item9", "item10", "a", "a", "b#c", ""]
    want = jpi.assign_partition_ids(keys, lambdas)
    got = tpi.assign_partition_ids(keys, lambdas)
    assert got == want and list(got) == list(want)
    tpi.write_partition_ids(str(tmp_path / "t.avro"), got)
    jpi.write_partition_ids(str(tmp_path / "j.avro"), want)
    assert (tmp_path / "t.avro").read_bytes() == \
        (tmp_path / "j.avro").read_bytes()
    assert tpi.read_partition_ids(str(tmp_path / "j.avro")) == want
    assert jpi.read_partition_ids(str(tmp_path / "t.avro")) == got
