"""End-to-end pipeline: Prepare -> AdmmTrain -> Test -> TestLoglik.

Port of mlease_tpu/train/pipeline.py on its in-memory path (reference:
src/main/java/com/linkedin/mlease/regression/jobs/Regression.java:37-98),
keeping the reference's on-disk layout:

  <out>/tmp-data/                      prepared rows (RegressionPrepareOutput)
  <out>/lambda-rho/part-r-00000.avro   LambdaRhoMap
  <out>/sample-test-loglik/iteration-N.avro
  <out>/best-model/best-iteration-N.avro
  <out>/final-model/part-r-00000.avro
  <out>/checkpoint/                    per-iteration (z,u,...) resume state
  <out>/test/lambda-<l>/part-r-00000.avro (+ /_loglik/), /test/best-model/...

Prepare runs record at a time (the native C++ ingest is not ported). Job
keys of paths not ported yet raise NotImplementedError instead of running
something else: streaming.groups > 1, mesh.feature.shards > 1, use.mesh,
initialize.boost.rate > 0 (naive warm start), pack.cache.dir, fused.loop
and profile.dir.
"""

from __future__ import annotations

import logging
import os
import shutil
from typing import Any, Mapping

import numpy as np
import torch

from mlease_tpu_torch.core.dataset import pack_blocks
from mlease_tpu_torch.core.linear_model import (LinearModel, read_model_file,
                                                write_model_file)
from mlease_tpu_torch.core.prepare import prepare_rows
from mlease_tpu_torch.core.vocab import build_vocab
from mlease_tpu_torch.eval.loglik import run_test_loglik
from mlease_tpu_torch.eval.score import run_regression_test
from mlease_tpu_torch.io import avro, schemas
from mlease_tpu_torch.io.records import (feature_key, normalize_row,
                                         row_to_prepare_record)
from mlease_tpu_torch.train.admm import (AdmmConfig, AdmmResult, AdmmTrainer,
                                         _lambda_key)
from mlease_tpu_torch.utils import checkpoint as ckpt
from mlease_tpu_torch.utils.config import JobConfig

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


def _reject_unported(config: JobConfig, cfg: AdmmConfig) -> None:
    """Job keys whose paths are not ported raise here, before any work."""
    unported = [
        ("streaming.groups", config.get_int("streaming.groups", 0) > 1,
         "streaming training (train/streaming.py)"),
        ("mesh.feature.shards", config.get_int("mesh.feature.shards", 0) > 1,
         "feature-sharded training"),
        ("use.mesh", config.get_boolean("use.mesh", False),
         "the device mesh"),
        ("initialize.boost.rate", cfg.initialize_boost_rate > 0,
         "the naive warm start (train/naive.py)"),
        ("pack.cache.dir", bool(config.get_string("pack.cache.dir", "")),
         "the pack cache (io/pack_cache.py)"),
        ("fused.loop", config.get_boolean("fused.loop", False),
         "AdmmTrainer.run_fused"),
        ("profile.dir", bool(config.get_string("profile.dir", "")),
         "utils/profiling.py"),
    ]
    for key, hit, what in unported:
        if hit:
            raise NotImplementedError(
                f"job key {key!r} needs {what}, which is not ported to "
                f"mlease_tpu_torch yet (ROADMAP.md)")


def run_regression_pipeline(config: JobConfig, dtype=None,
                            device: str | torch.device = "cuda"
                            ) -> AdmmResult:
    cfg = admm_config_from_job(config, dtype=dtype)
    _reject_unported(config, cfg)
    out_base = config.get_string("output.base.path")
    if config.get_boolean("force.output.overwrite", False):
        shutil.rmtree(out_base, ignore_errors=True)
    os.makedirs(out_base, exist_ok=True)

    nblocks = config.get_int("num.blocks")
    ignore_value = config.get_boolean("binary.feature", False)
    map_key = config.get_string("map.key", "")
    input_paths = config.get_string("input.paths")
    seed = config.get_int("prepare.seed", 0)

    # ---- Prepare (RegressionPrepare), record at a time -----------------
    records = avro.read_records(input_paths)
    logger.info("prepare: %d input records", len(records))
    prepared = list(prepare_rows(
        records, nblocks, map_key=map_key,
        num_click_replicates=cfg.num_click_replicates,
        ignore_value=ignore_value, seed=seed))
    if config.get_boolean("write.tmp.data", True):
        avro.write_records(
            os.path.join(out_base, "tmp-data", "part-m-00000.avro"),
            schemas.REGRESSION_PREPARE_OUTPUT,
            (row_to_prepare_record(k, r) for k, r in prepared))
    blocks: list[list[dict]] = [[] for _ in range(nblocks)]
    for key, row in prepared:
        blocks[int(key)].append(row)
    vocab = build_vocab((r for _k, r in prepared), has_intercept=True)
    data = pack_blocks(blocks, vocab)
    vocab.save(os.path.join(out_base, "model-vocab.json"))
    logger.info("packed %d blocks, %d rows padded to (%d, %d), %d features",
                data.nblocks, int(data.nrows.sum()), data.padded_rows,
                data.max_nnz, data.dim)

    # lambda -> rho map file (RegressionAdmmTrain.java:200-201)
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
    z0 = None
    init_model_path = config.get_string("init.model.path", "")
    if init_model_path:
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

    def _dump_train_output(iteration, z_np, u_np):
        # RegressionTrainOutput{key="lambda#part", model=x_b, uplusx=u_b+x_b}
        # (RegressionAdmmTrain.java:707-711)
        u_old = (prev_u["u"] if prev_u["u"] is not None
                 else np.zeros_like(u_np))
        records_out = []
        for li in range(u_np.shape[0]):
            lam_key = _lambda_key(cfg.lambdas[li])
            for b in range(data.nblocks):
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

    def on_iteration(iteration, z, u, diffs, inner_eps, logliks=None):
        z_np, u_np = z.cpu().numpy(), u.cpu().numpy()
        ckpt.save_checkpoint(ckpt_dir, iteration, z_np, u_np,
                             inner_eps=inner_eps, mindiff=float(diffs.min()),
                             best_loglik=-9999999.0)
        if not keep_all:
            ckpt.prune_checkpoints(ckpt_dir, keep=keep_n)
        if write_train_output:
            _dump_train_output(iteration, np.asarray(z_np, np.float64),
                               np.asarray(u_np, np.float64))
        if logliks:
            avro.write_records(
                os.path.join(out_base, "sample-test-loglik",
                             f"iteration-{iteration}.avro"),
                schemas.SAMPLE_TEST_LOGLIK, logliks)

    # ---- ADMM train ---------------------------------------------------
    trainer = AdmmTrainer(data, vocab, cfg, test_rows=test_rows,
                          device=device)
    run_kwargs: dict[str, Any] = {"z0": z0}
    if config.get_boolean("resume", False):
        state = ckpt.load_latest(ckpt_dir)
        if state is not None:
            logger.info("resuming from checkpoint iter %d", state["iteration"])
            run_kwargs = dict(
                z0=state["z"], u0=state["u"],
                start_iteration=state["iteration"] + 1,
                inner_eps0=state["inner_eps"], mindiff0=state["mindiff"],
                best_loglik0=state["best_loglik"])
    result = trainer.run(callback=on_iteration, **run_kwargs)
    return _write_pipeline_outputs(config, result, out_base, test_path,
                                   test_records, ignore_value, device)


def _write_pipeline_outputs(config, result, out_base, test_path,
                            test_records, ignore_value,
                            device) -> AdmmResult:
    """final-model / sample-test-loglik / best-model files + the Test and
    TestLoglik jobs (Regression.java:63-80)."""
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
    return result


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
