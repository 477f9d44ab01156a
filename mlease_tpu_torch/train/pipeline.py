"""End-to-end pipeline: Prepare -> AdmmTrain -> Test -> TestLoglik.

Port of mlease_tpu/train/pipeline.py (reference:
src/main/java/com/linkedin/mlease/regression/jobs/Regression.java:37-98),
keeping the reference's on-disk layout:

  <out>/tmp-data/                      prepared rows (RegressionPrepareOutput)
  <out>/lambda-rho/part-r-00000.avro   LambdaRhoMap
  <out>/sample-test-loglik/iteration-N.avro
  <out>/best-model/best-iteration-N.avro
  <out>/final-model/part-r-00000.avro
  <out>/checkpoint/                    per-iteration (z,u,...) resume state
  <out>/test/lambda-<l>/part-r-00000.avro (+ /_loglik/), /test/best-model/...

Prepare takes the native columnar ingest (io/fast_decode.py +
core/ingest.py) when `native.ingest` is on (the default) and no map.key is
set, and falls back to the record-at-a-time path with a warning when the
decoder is absent or fails. `streaming.groups > 1` trains with the
streaming trainer (train/streaming.py), with the post-hybrid groups kept in
`pack.cache.dir` when it is set; `profile.dir` writes a torch.profiler
trace of the training loop. `initialize.boost.rate > 0` with L2 first fits
the naive models per block (train/naive.py), writes them to
`<out>/initialModel/` and starts each lambda's z from its mean model
(AdmmTrain.java:236-276); a boosted job of either regularizer reads its
rows record by record and skips the pack cache, as the JAX pipeline does.

`use.mesh` (with `mesh.devices`, 0 = every rank) runs the trainers on a
block mesh of the process group's ranks (parallel/), and
`mesh.feature.shards` > 1 the in-memory job on a (world / shards) x shards
feature-sharded mesh (resume, write.train.output and profile.dir are then
ignored with a warning, as in the JAX pipeline). Every rank runs the whole
pipeline on the whole input; rank 0 alone writes files (outputs,
checkpoints, initialModel/, the pack cache, the overwrite's rmtree) and the
others wait for it at barriers. Outside a launcher, use.mesh with at most
one device starts a one-rank process group itself.
`fused.loop = true` trains in memory with AdmmTrainer.run_fused (the
driver loop on the device: a CUDA graph that loops on the card, or the
same branches eagerly on the CPU) under the JAX pipeline's conditions:
not when resuming from a checkpoint, not with write.train.output, not for
a streaming or feature-sharded job (which ignore it); `checkpoint.every =
C` writes a checkpoint and the chunk's sample-test-loglik files every C
iterations, and `fused.device.budget.gb` (10) warns when the estimated
footprint passes it. It runs in every solve mode and under use.mesh,
where rank 0 writes the chunks' checkpoints. After a streaming run with no
mesh the pipeline logs the pass-floor decomposition (utils/floor.py).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
from typing import Any, Mapping

import numpy as np
import torch

from mlease_tpu_torch.core.dataset import pack_blocks, split_blocks, to_hybrid
from mlease_tpu_torch.core.ingest import (decode_files_parallel, merge_decoded,
                                          pack_blocks_columnar,
                                          prepare_columnar, vocab_from_names)
from mlease_tpu_torch.core.linear_model import (LinearModel, read_model_file,
                                                write_model_file)
from mlease_tpu_torch.core.prepare import prepare_rows
from mlease_tpu_torch.core.vocab import build_vocab
from mlease_tpu_torch.eval.loglik import run_test_loglik
from mlease_tpu_torch.eval.score import run_regression_test
from mlease_tpu_torch.io import avro, fast_decode, pack_cache, schemas
from mlease_tpu_torch.io.records import (feature_key, normalize_row,
                                         row_to_prepare_record,
                                         split_feature_key)
from mlease_tpu_torch.parallel import distributed
from mlease_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
from mlease_tpu_torch.train.admm import (AdmmConfig, AdmmResult, AdmmTrainer,
                                         _lambda_key)
from mlease_tpu_torch.train.feature_sharded import FeatureShardedAdmmTrainer
from mlease_tpu_torch.train.naive import NaiveConfig, train_naive
from mlease_tpu_torch.train.streaming import StreamingAdmmTrainer
from mlease_tpu_torch.utils import checkpoint as ckpt
from mlease_tpu_torch.utils.config import JobConfig
from mlease_tpu_torch.utils.floor import measure_put_bandwidth, streaming_floor
from mlease_tpu_torch.utils.profiling import trace

logger = logging.getLogger(__name__)

DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16}


def read_lambda_map(path: str) -> dict[str, float]:
    """Per-feature lambda map from Avro {name, term, value} records
    (reference: ReadLambdaMapConsumer)."""
    out = {}
    for rec in avro.read_records(path):
        out[feature_key(rec["name"], rec.get("term"))] = float(rec["value"])
    return out


def read_lambda_rho(path: str) -> dict[float, float]:
    """{lambda -> rho} from a LambdaRhoMap Avro file, the one the pipeline
    writes to <out>/lambda-rho/ (reference: ReadLambdaRhoConsumer)."""
    return {float(rec["lambda"]): float(rec["rho"])
            for rec in avro.read_records(path)}


def _parse_pcg(raw: str):
    """\"pcg\" job key: true|false|jacobi|head_block (AdmmConfig.pcg)."""
    val = {"true": True, "false": False}.get(raw.lower(), raw.lower())
    if val not in (True, False, "jacobi", "head_block"):
        raise ValueError(
            f"pcg must be true|false|jacobi|head_block; got {raw!r}")
    return val


def admm_config_from_job(config: JobConfig, dtype=None) -> AdmmConfig:
    lambdas = config.get_float_list("lambda")
    rhos = config.get_float_list("rho") if "rho" in config else None
    lm_path = config.get_string("lambda.map", "")
    return AdmmConfig(
        lambdas=lambdas,
        rhos=rhos,
        num_iters=config.get_int("num.iters", 10),
        regularizer=config.get_int("regularizer"),
        epsilon=config.get_float("epsilon", 1e-4),
        liblinear_epsilon=config.get_float("liblinear.epsilon", 0.01),
        aggressive_liblinear_epsilon_decay=config.get_boolean(
            "aggressive.liblinear.epsilon.decay", False),
        penalize_intercept=config.get_boolean("penalize.intercept", False),
        initialize_boost_rate=config.get_float("initialize.boost.rate", 0.0),
        rho_adapt_coefficient=config.get_float("rho.adapt.coefficient", 0.0),
        num_click_replicates=config.get_int("num.click.replicates", 1),
        test_loglik_per_iter=config.get_boolean("test.loglik.per.iter", False),
        lambda_map=read_lambda_map(lm_path) if lm_path else None,
        relaxation=config.get_float("relaxation", 1.0),
        reference_l1_compat=config.get_boolean("reference.l1.compat", True),
        head_size=config.get_int("head.size", 0),
        head_dtype={"": None, **DTYPES}[config.get_string("head.dtype", "")],
        dual_layout=config.get_boolean("dual.layout", False),
        multi_rhs=config.get_boolean("multi.rhs", True),
        pcg=_parse_pcg(config.get_string("pcg", "true")),
        flat_blocks=config.get_boolean("flat.blocks", True),
        dtype=(dtype if dtype is not None
               else DTYPES[config.get_string("dtype", "float32")]),
    )


def _warn_fused_footprint(config: JobConfig, cfg: AdmmConfig, data) -> None:
    """fused.device.budget.gb: the JAX pipeline's rough device-bytes
    estimate of a fused run (data arrays + the carried state, (L, B, n) u
    and the multi-RHS solver workspace), with a warning past the budget."""
    L = len(cfg.lambdas)
    est = sum(int(getattr(data, f).nbytes)
              for f in ("indices", "values", "head", "tail_rows",
                        "tail_cols", "tail_vals", "tail_c_rows",
                        "tail_c_cols", "tail_c_vals")
              if getattr(data, f, None) is not None)
    est += 12 * 4 * L * (data.nblocks + 1) * data.dim  # u/z/solver ws
    budget = config.get_float("fused.device.budget.gb", 10.0)
    if est > budget * (1 << 30):
        logger.warning(
            "fused.loop at ~%.1f GB estimated device footprint (budget "
            "%.1f GB): the whole problem, its state and the loop's graph "
            "memory stay on the card, and past its memory the run fails "
            "out of memory — prefer streaming.groups=N (resident-head mode "
            "keeps the hot columns on the card) or fused.loop=false",
            est / (1 << 30), budget)


def _log_streaming_floor(trainer, result, n_lambdas: int) -> None:
    """The probe-composed utilization of a streamed run, logged so that
    every streaming run records its distance from the measured per-pass
    floor (utils/floor.py); "source" says why when no table applies.
    Accounting never fails the job."""
    if not result.iter_times:
        return
    try:
        steady = (float(np.median(result.iter_times[1:]))
                  if len(result.iter_times) > 1 else result.iter_times[0])
        sf = streaming_floor(
            trainer.groups, trainer.trip_log, trainer.stream_wire_bytes(),
            steady, measure_put_bandwidth(device=trainer.device), n_lambdas,
            device=trainer.device, dtype=trainer.config.dtype)
        logger.info("streaming pass-floor decomposition: %s", json.dumps(sf))
    except Exception as e:  # noqa: BLE001 - accounting never fails the job
        logger.info("pass-floor decomposition unavailable: %r", e)


def _job_mesh(config: JobConfig, device):
    """The block mesh of use.mesh / mesh.devices (None without use.mesh);
    joins the launcher's process group when there is one."""
    feat_shards = config.get_int("mesh.feature.shards", 0)
    use_mesh = config.get_boolean("use.mesh", False)
    if use_mesh or feat_shards > 1:
        distributed.initialize(device)
    if not use_mesh:
        return None
    ndev = config.get_int("mesh.devices", 0)
    if ndev <= 1:
        distributed.initialize_single(device)
    mesh = make_mesh(ndev or None, device)
    logger.info("mesh over %d ranks", mesh.size())
    return mesh


def run_regression_pipeline(config: JobConfig, dtype=None,
                            device: str | torch.device = "cuda",
                            mesh=None) -> AdmmResult:
    """The whole train job on `device`; with `mesh` (or the use.mesh job
    key) on every rank of a block mesh, each rank calling it."""
    cfg = admm_config_from_job(config, dtype=dtype)
    if mesh is None:
        mesh = _job_mesh(config, device)
    main = distributed.is_main()
    out_base = config.get_string("output.base.path")
    if main:
        if config.get_boolean("force.output.overwrite", False):
            shutil.rmtree(out_base, ignore_errors=True)
        os.makedirs(out_base, exist_ok=True)
    distributed.barrier()

    nblocks = config.get_int("num.blocks")
    ignore_value = config.get_boolean("binary.feature", False)
    map_key = config.get_string("map.key", "")
    input_paths = config.get_string("input.paths")
    seed = config.get_int("prepare.seed", 0)

    input_files = avro.enumerate_avro_files(input_paths)
    streaming_groups = config.get_int("streaming.groups", 0)
    # a boosted job reads its rows record by record and packs them anew:
    # the L2 warm start fits the naive models on those rows (the JAX
    # pipeline takes the same path for L1, which does not warm-start)
    boosted = cfg.initialize_boost_rate > 0

    # ---- pack cache (pack.cache.dir, streaming jobs only) ------------
    # With pack.cache.dir set, the post-hybrid groups persist once and a
    # rerun (or a resume) reloads them instead of decoding and packing
    # again (io/pack_cache.py; keyed by the inputs and the layout knobs).
    pack_cache_dir = config.get_string("pack.cache.dir", "")
    cached_groups = None
    pc_manifest = None
    if pack_cache_dir and streaming_groups > 1 and not boosted:
        pc_manifest = pack_cache.build_manifest(
            input_files, nblocks=nblocks, n_groups=streaming_groups,
            head_size=cfg.head_size,
            head_dtype=pack_cache.dtype_name(cfg.head_dtype or cfg.dtype),
            num_click_replicates=cfg.num_click_replicates, seed=seed,
            binary_feature=ignore_value, map_key=map_key)
        hit = pack_cache.load_groups(pack_cache_dir, pc_manifest)
        if hit is not None:
            cached_groups, vocab = hit
            del hit
        # every rank has looked before rank 0 may write the cache below
        distributed.barrier()

    # ---- Prepare (RegressionPrepare) --------------------------------
    # Native C++ columnar ingest when possible; the same semantics as the
    # record-at-a-time path (tests/test_torch_ingest.py). Falls back to
    # pure Python, with a warning, when the decoder is absent or fails.
    data = None
    z0 = None
    if (config.get_boolean("native.ingest", True) and not map_key
            and input_files and cached_groups is None and not boosted):
        data, vocab = _native_prepare(config, cfg, input_files, nblocks,
                                      ignore_value, seed, out_base, main)
    if data is None and cached_groups is not None:
        logger.info("pack cache hit: ingest/pack skipped (%d groups, %d "
                    "features)", len(cached_groups), cached_groups[0].dim)
    elif data is None:
        records = avro.read_records(input_paths)
        logger.info("prepare: %d input records", len(records))
        prepared = list(prepare_rows(
            records, nblocks, map_key=map_key,
            num_click_replicates=cfg.num_click_replicates,
            ignore_value=ignore_value, seed=seed))
        if main and config.get_boolean("write.tmp.data", True):
            avro.write_records(
                os.path.join(out_base, "tmp-data", "part-m-00000.avro"),
                schemas.REGRESSION_PREPARE_OUTPUT,
                (row_to_prepare_record(k, r) for k, r in prepared))
        blocks: list[list[dict]] = [[] for _ in range(nblocks)]
        for key, row in prepared:
            blocks[int(key)].append(row)
        vocab = build_vocab((r for _k, r in prepared), has_intercept=True)
        data = pack_blocks(blocks, vocab)
        del records, prepared
        if boosted and cfg.regularizer == 2:
            z0 = _naive_warm_start(config, cfg, blocks, vocab, out_base,
                                   device, mesh)
        del blocks
    if main:
        vocab.save(os.path.join(out_base, "model-vocab.json"))
    if data is not None:
        logger.info("packed %d blocks, %d rows padded to (%d, %d), "
                    "%d features", data.nblocks, int(data.nrows.sum()),
                    data.padded_rows, data.max_nnz, data.dim)

    # lambda -> rho map file (RegressionAdmmTrain.java:200-201)
    if main:
        avro.write_records(
            os.path.join(out_base, "lambda-rho", "part-r-00000.avro"),
            schemas.LAMBDA_RHO_MAP,
            [{"lambda": float(l), "rho": float(r)}
             for l, r in zip(cfg.lambdas, cfg.resolved_rhos())])

    # ---- test rows for per-iteration sample loglik -------------------
    test_path = config.get_string("test.path", "")
    test_rows = None
    test_records = None
    if test_path and os.path.exists(test_path):
        test_records = avro.read_records(test_path)
        # the per-iteration SAMPLE loglik uses only the first part-file
        # (<=1M events); the final Test/TestLoglik jobs score the full set
        first_part = avro.enumerate_avro_files(test_path)[0]
        test_rows = [normalize_row(r, ignore_value=ignore_value)
                     for r in avro.read_records(first_part)]

    # ---- optional lambda-path extension warm start ---------------------
    init_model_path = config.get_string("init.model.path", "")
    if z0 is None and init_model_path:
        prev_models = read_model_file(init_model_path)
        z0 = np.stack([
            _nearest_lambda_model(l, prev_models).to_dense(vocab)
            for l in cfg.lambdas])
        logger.info("lambda-path warm start from %s (%d models)",
                    init_model_path, len(prev_models))

    # ---- per-iteration callback: crash checkpoints, the
    # write.train.output interop dump, per-iteration sample-loglik files
    ckpt_dir = os.path.join(out_base, "checkpoint")
    keep_all = ("remove.tmp.dir" in config
                and not config.get_boolean("remove.tmp.dir", False))
    keep_n = config.get_int("checkpoint.keep", 2)
    write_train_output = config.get_boolean("write.train.output", False)
    prev_u = {"u": None}
    nblocks_total = (data.nblocks if data is not None
                     else sum(g.nblocks for g in cached_groups))

    def _dump_train_output(iteration, z_np, u_np):
        # RegressionTrainOutput{key="lambda#part", model=x_b, uplusx=u_b+x_b}
        # (RegressionAdmmTrain.java:707-711)
        u_old = (prev_u["u"] if prev_u["u"] is not None
                 else np.zeros_like(u_np))
        records_out = []
        for li in range(u_np.shape[0]):
            lam_key = _lambda_key(cfg.lambdas[li])
            for b in range(nblocks_total):
                # u_new = u_old + x - z  =>  x = u_new - u_old + z
                x_b = u_np[li, b] - u_old[li, b] + z_np[li]
                uplusx = u_np[li, b] + z_np[li]
                records_out.append({
                    "key": f"{lam_key}#{b}",
                    "model": LinearModel.from_dense(x_b, vocab).to_avro(),
                    "uplusx": LinearModel.from_dense(uplusx,
                                                     vocab).to_avro()})
        avro.write_records(
            os.path.join(out_base, f"iter-{iteration}", "model",
                         "part-r-00000.avro"),
            schemas.REGRESSION_TRAIN_OUTPUT, records_out)
        prev_u["u"] = u_np.copy()
        if not keep_all:
            shutil.rmtree(os.path.join(out_base, f"iter-{iteration - 2}"),
                          ignore_errors=True)

    # the arrays a checkpoint holds, as the JAX package writes them: the
    # in-memory trainers' state in the compute dtype (bfloat16 as its
    # bits), the streaming trainer's widened to float64 on the host
    if streaming_groups > 1:
        def host(t):
            return t.cpu().to(torch.float64).numpy()
    else:
        host = ckpt.host_array

    def on_iteration(iteration, z, u, diffs, inner_eps, logliks=None):
        if not main:              # the trainer gathered u on every rank
            return
        ckpt.save_checkpoint(ckpt_dir, iteration, host(z), host(u),
                             inner_eps=inner_eps,
                             mindiff=float(diffs.min()),
                             best_loglik=-9999999.0)
        if not keep_all:
            ckpt.prune_checkpoints(ckpt_dir, keep=keep_n)
        if write_train_output:
            _dump_train_output(iteration,
                               z.to(torch.float64).cpu().numpy(),
                               u.to(torch.float64).cpu().numpy())
        if logliks:
            avro.write_records(
                os.path.join(out_base, "sample-test-loglik",
                             f"iteration-{iteration}.avro"),
                schemas.SAMPLE_TEST_LOGLIK, logliks)

    # ---- ADMM train ---------------------------------------------------
    run_kwargs: dict[str, Any] = {"z0": z0}
    if config.get_boolean("resume", False):
        state = ckpt.load_latest(ckpt_dir)
        if state is not None and ckpt.is_bf16_bits(state["z"]):
            raise ValueError(
                f"resume=true: {ckpt_dir} holds a bfloat16 run's checkpoint "
                f"(its bits), which the JAX package cannot resume either "
                f"(ROADMAP.md section C, known trait 8); "
                f"mlease_tpu_torch.convert.state_from_checkpoint reads it")
        if state is not None:
            logger.info("resuming from checkpoint iter %d", state["iteration"])
            run_kwargs = dict(
                z0=state["z"], u0=state["u"],
                start_iteration=state["iteration"] + 1,
                inner_eps0=state["inner_eps"], mindiff0=state["mindiff"],
                best_loglik0=state["best_loglik"])
    if streaming_groups > 1:
        # the >HBM mode: blocks stay host-resident in N groups, copied per
        # iteration under the previous group's solve (train/streaming.py);
        # checkpoint / resume / write.train.output work as in the
        # in-memory trainer (same callback contract). The hand-off: split
        # copies each group out of the packed data, which then goes, and
        # _streaming_trainer empties `groups` into the trainer
        cache = None
        if cached_groups is not None:
            groups = cached_groups
            del cached_groups
        else:
            groups = split_blocks(data, streaming_groups)
            del data
            if main and pack_cache_dir and pc_manifest is not None:
                cache = (pack_cache_dir, pc_manifest)
        trainer = _streaming_trainer(config, cfg, groups, vocab,
                                     test_rows=test_rows, device=device,
                                     mesh=mesh, cache=cache)
        logger.info("streaming residency: %s; %.3f GB on the wire per "
                    "iteration", json.dumps(dict(trainer.residency_report(),
                                                 **trainer._held_bytes())),
                    trainer.stream_wire_bytes() / 1e9)
    elif config.get_int("mesh.feature.shards", 0) > 1:
        # feature model parallelism: the coefficient axis column-sharded
        # over a (block x feat) mesh of the ranks (train/feature_sharded.py)
        shards = config.get_int("mesh.feature.shards", 0)
        ranks = (mesh.size() if mesh is not None
                 else distributed.world_size())
        block = max(ranks // shards, 1)
        mesh2d = make_mesh_2d(block, shards, device)
        logger.info("feature-sharded mesh: %d block x %d feat ranks",
                    block, shards)
        for unsupported in ("resume", "write.train.output", "profile.dir"):
            if config.get_string(unsupported, ""):
                logger.warning(
                    "%s is not supported with mesh.feature.shards and is "
                    "ignored (the feature-sharded trainer has no "
                    "checkpoint/interop dump path yet)", unsupported)
        result = FeatureShardedAdmmTrainer(
            data, vocab, cfg, test_rows=test_rows, mesh=mesh2d).run(z0=z0)
        return _write_pipeline_outputs(config, result, out_base, test_path,
                                       test_records, ignore_value, device,
                                       main)
    else:
        trainer = AdmmTrainer(data, vocab, cfg, test_rows=test_rows,
                              device=device, mesh=mesh)
    # fused.loop=true: the driver loop on the device (run_fused), the same
    # result as run(); iter-i interop dumps need per-iteration u deltas, so
    # write.train.output keeps the host loop, as does a resume
    fused = (streaming_groups <= 1 and config.get_boolean("fused.loop", False)
             and "start_iteration" not in run_kwargs
             and not write_train_output)
    with trace(config.get_string("profile.dir", "") if main else ""):
        if fused:
            _warn_fused_footprint(config, cfg, data)

            def on_chunk(iteration, z, u, diffs, inner_eps, logliks=None):
                if not main:      # run_fused gathered u on every rank
                    return
                ckpt.save_checkpoint(ckpt_dir, iteration,
                                     ckpt.host_array(z),
                                     ckpt.host_array(u), inner_eps=inner_eps,
                                     mindiff=float(np.min(diffs)),
                                     best_loglik=-9999999.0)
                if not keep_all:
                    ckpt.prune_checkpoints(ckpt_dir, keep=keep_n)
                by_iter: dict[int, list] = {}
                for entry in logliks or []:
                    by_iter.setdefault(entry["iter"], []).append(entry)
                for it, entries in by_iter.items():
                    avro.write_records(
                        os.path.join(out_base, "sample-test-loglik",
                                     f"iteration-{it}.avro"),
                        schemas.SAMPLE_TEST_LOGLIK, entries)

            result = trainer.run_fused(
                z0=run_kwargs.get("z0"),
                checkpoint_every=config.get_int("checkpoint.every", 0) or None,
                callback=on_chunk)
        else:
            result = trainer.run(callback=on_iteration, **run_kwargs)
    if streaming_groups > 1 and mesh is None:
        _log_streaming_floor(trainer, result, len(cfg.lambdas))
    return _write_pipeline_outputs(config, result, out_base, test_path,
                                   test_records, ignore_value, device, main)


def _hand_over(groups: list):
    """Yield the entries of `groups`, each taken out of the list as it
    goes: the consumer ends up with the only reference to each."""
    while groups:
        yield groups.pop(0)


def _streaming_trainer(config, cfg, groups: list, vocab, *, test_rows=None,
                       device="cuda", mesh=None,
                       cache=None) -> StreamingAdmmTrainer:
    """The job's StreamingAdmmTrainer, built from `groups`, which it
    empties: the trainer gets the only reference to each group, so a
    group's host arrays are freed once its page-locked copies exist.
    cache = (pack.cache.dir, manifest) converts every group to hybrid
    here, in place, each group's ELL freed once its hybrid form exists,
    and writes the pack cache (the trainer then skips groups that already
    carry a head); None leaves the groups as they are (a cache hit, or no
    cache: the trainer converts them itself)."""
    if cache is not None:
        t0 = time.monotonic()
        if cfg.head_size > 0:
            for i in range(len(groups)):
                if groups[i].head is None:
                    groups[i] = to_hybrid(
                        groups[i], cfg.head_size, column_sorted=True,
                        head_dtype=cfg.head_dtype or cfg.dtype)
        hybrid_s = time.monotonic() - t0
        t0 = time.monotonic()
        pack_cache.save_groups(cache[0], cache[1], groups, vocab)
        logger.info("streaming pack phases: hybrid=%.1fs cache_write=%.1fs",
                    hybrid_s, time.monotonic() - t0)
    choice = {"auto": "auto", "true": True, "false": False}
    return StreamingAdmmTrainer(
        _hand_over(groups), vocab, cfg, test_rows=test_rows, device=device,
        mesh=mesh,
        resident_head=choice[config.get_string(
            "streaming.resident.head", "auto")],
        resident_head_budget_gb=config.get_float(
            "streaming.resident.head.gb", 8.0),
        consensus_device=choice[config.get_string(
            "streaming.consensus.device", "auto")],
        # compact|dense|auto: COO-head + permutation-derived tail wire
        compact_wire={"auto": "auto", "compact": True, "dense": False}[
            config.get_string("streaming.wire", "auto")],
        pad_tails=choice[config.get_string("streaming.pad.tails", "auto")])


def _naive_warm_start(config, cfg, blocks, vocab, out_base, device,
                      mesh=None):
    """The naive mean-model initialization (AdmmTrain.java:236-276, the JAX
    pipeline's warm start): one naive model per (lambda, non-empty block)
    at liblinear.epsilon (default 0.01), written to
    <out>/initialModel/part-r-00000.avro; each lambda's z starts from its
    mean model, or from zeros where that lambda has none. Returns z0
    (L, n)."""
    logger.info("warm start: naive mean-model initialization")
    naive_cfg = NaiveConfig(
        lambdas=sorted(set(cfg.lambdas)),
        liblinear_epsilon=config.get_float("liblinear.epsilon", 0.01),
        lambda_map=cfg.lambda_map, compute_model_mean=True, dtype=cfg.dtype)
    keyed = {str(i): rows for i, rows in enumerate(blocks) if rows}
    naive_res = train_naive(keyed, naive_cfg, vocab=vocab, device=device,
                            mesh=mesh)
    if distributed.is_main():
        write_model_file(os.path.join(out_base, "initialModel",
                                      "part-r-00000.avro"), naive_res.models)
    z0 = np.stack([
        naive_res.mean_models[_lambda_key(l)].to_dense(vocab)
        if _lambda_key(l) in naive_res.mean_models else np.zeros(vocab.size)
        for l in cfg.lambdas])
    logger.info("warm start: z0 from %d naive models over %d blocks "
                "(max|z0| %.6g)", len(naive_res.models), len(keyed),
                float(np.abs(z0).max()))
    return z0


def _native_prepare(config, cfg, input_files, nblocks, ignore_value, seed,
                    out_base, main=True):
    """Native columnar ingest: decode, merge, vocabulary, prepare and pack,
    with each phase's wall seconds logged (the scale jobs' cold start is
    ingest-dominated, so every run records where the minutes went).
    Returns (data, vocab), or (None, None) when the decoder is absent or
    fails, after a warning: the caller then takes the Python path."""
    if not fast_decode.is_available():
        logger.warning("native ingest: the decoder is unavailable; "
                       "python path")
        return None, None
    try:
        ph: dict[str, float] = {}
        t0 = time.monotonic()
        parts = decode_files_parallel(input_files, ignore_value=ignore_value)
        ph["decode_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        decoded = merge_decoded(parts)
        del parts
        ph["merge_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        vocab = vocab_from_names(decoded.vocab_names)
        ph["vocab_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        row_ids, partitions, weights = prepare_columnar(
            decoded, nblocks, num_click_replicates=cfg.num_click_replicates,
            seed=seed)
        ph["prepare_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        data = pack_blocks_columnar(decoded, row_ids, partitions, weights,
                                    vocab, nblocks=nblocks)
        ph["pack_s"] = time.monotonic() - t0
        rows = decoded.num_rows
        logger.info("ingest phase breakdown: %s; %.0f rows/s",
                    json.dumps({k: round(v, 3) for k, v in ph.items()}),
                    rows / max(sum(ph.values()), 1e-9))
        if main and config.get_boolean("write.tmp.data", True):
            _write_tmp_from_columnar(
                os.path.join(out_base, "tmp-data", "part-m-00000.avro"),
                decoded, row_ids, partitions, weights, vocab)
        logger.info("native ingest: %d rows, %d features",
                    int(data.nrows.sum()), data.dim)
        return data, vocab
    except Exception as e:  # noqa: BLE001 - fall back to the Python path
        logger.warning("native ingest failed (%r); python path", e,
                       exc_info=True)
        return None, None


def _write_tmp_from_columnar(path, decoded, row_ids, partitions, weights,
                             vocab):
    """RegressionPrepareOutput records from the native columnar decode."""
    def gen():
        for i in range(len(row_ids)):
            src = int(row_ids[i])
            s, e = decoded.row_start[src], decoded.row_start[src + 1]
            feats = []
            for j in range(s, e):
                name, term = split_feature_key(
                    vocab.name(int(decoded.feat_id[j])))
                feats.append({"name": name, "term": term,
                              "value": float(decoded.feat_val[j])})
            yield {"key": str(int(partitions[i])),
                   "response": int(decoded.response[src]),
                   "features": feats,
                   "weight": float(weights[i]),
                   "offset": float(decoded.offset[src])}

    avro.write_records(path, schemas.REGRESSION_PREPARE_OUTPUT, gen())


def _write_pipeline_outputs(config, result, out_base, test_path,
                            test_records, ignore_value,
                            device, main=True) -> AdmmResult:
    """final-model / sample-test-loglik / best-model files + the Test and
    TestLoglik jobs (Regression.java:63-80), on rank 0; every rank returns
    once they are written."""
    if main:
        _write_outputs(config, result, out_base, test_path, test_records,
                       ignore_value, device)
    distributed.barrier()
    return result


def _write_outputs(config, result, out_base, test_path, test_records,
                   ignore_value, device) -> None:
    write_model_file(os.path.join(out_base, "final-model",
                                  "part-r-00000.avro"), result.models)
    if result.sample_loglik_history:
        by_iter: dict[int, list] = {}
        for entry in result.sample_loglik_history:
            by_iter.setdefault(entry["iter"], []).append(entry)
        for it, entries in by_iter.items():
            avro.write_records(
                os.path.join(out_base, "sample-test-loglik",
                             f"iteration-{it}.avro"),
                schemas.SAMPLE_TEST_LOGLIK, entries)
    if result.best_model is not None:
        write_model_file(
            os.path.join(out_base, "best-model",
                         f"best-iteration-{result.iterations}.avro"),
            {result.best_lambda: result.best_model})

    if test_records:
        with avro.AvroFileReader(avro.enumerate_avro_files(test_path)[0]) as r:
            input_schema = r.schema
        test_base = os.path.join(out_base, "test")
        run_regression_test(
            test_records, input_schema, result.models, test_base,
            list(result.models), best_model=result.best_model,
            ignore_value=ignore_value, device=device)
        if config.get_boolean("get.test.loglik", True):
            logliks = run_test_loglik(test_base, test_base,
                                      list(result.models))
            for name, rec in logliks.items():
                logger.info("test loglik %s: %.6f (n=%.0f)", name,
                            rec["testLoglik"], rec["count"])


def _nearest_lambda_model(lam: float, models: Mapping[str, Any]):
    """The init model for `lam` from a previous run's {lambda-key -> model}
    map: exact key match if present, else the nearest lambda in log space."""
    key = _lambda_key(lam)
    if key in models:
        return models[key]
    best_key, best_d = None, float("inf")
    for k in models:
        try:
            kl = float(k)
        except ValueError:
            continue  # non-lambda keys (e.g. item models) are skipped
        if kl <= 0 or lam <= 0:
            d = abs(kl - lam)
        else:
            d = abs(np.log(kl) - np.log(lam))
        if d < best_d:
            best_key, best_d = k, d
    if best_key is None:
        return LinearModel()
    return models[best_key]
