"""Command-line entry points of the PyTorch port.

`python -m mlease_tpu_torch <subcommand> <config.job> [--device cuda|cpu]`
reads the same properties-file job keys as `python -m mlease_tpu`
(reference: README.md:50, Regression.java:88-98). Subcommands:

  train    full pipeline Prepare -> AdmmTrain -> Test -> TestLoglik
  test     RegressionTest: score with an existing final-model/best-model
           ("predict" is an alias)
  loglik   RegressionTestLoglik: aggregate scored outputs
  item     ItemModelTrain: per-item models (+ posterior variance)
  itemtest ItemModelTest + ItemModelTestLoglik: score with per-item models

train and item read their input through the native columnar decoder when
`native.ingest` is on (the default), and record at a time otherwise or when
the decoder is unavailable. The JAX package's naive and fit subcommands are
not ported yet (ROADMAP.md).
--device defaults to cuda and fails without a CUDA device. The JSON summary
line of train, item and itemtest carries `kernel_launches`, the count of
launches of each hand-written kernel in the run (0 on the CPU).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys


def _load_config(path: str):
    from mlease_tpu_torch.utils.config import JobConfig

    config = JobConfig.from_file(path)
    # "logging.level" job key (reference: AbstractAvroJob.java:48-49)
    level = config.get_string("logging.level", "")
    if level:
        logging.getLogger().setLevel(level.upper())
    return config


def _kernel_launches() -> dict:
    from mlease_tpu_torch.ops.gram import gram_batched
    from mlease_tpu_torch.ops.segment_sum import segment_sum_sorted

    return {"segment_sum_sorted": segment_sum_sorted.launches,
            "gram_batched": gram_batched.launches}


def cmd_train(args):
    from mlease_tpu_torch.train.pipeline import run_regression_pipeline

    config = _load_config(args.config)
    result = run_regression_pipeline(config, device=args.device)
    print(json.dumps({
        "iterations": result.iterations,
        "converged": result.converged,
        "best_lambda": result.best_lambda,
        "best_loglik": result.best_loglik,
        "wall_time_s": round(result.wall_time, 2),
        "models": sorted(result.models),
        "device": args.device,
        "kernel_launches": _kernel_launches(),
    }))
    return 0


def cmd_test(args):
    from mlease_tpu_torch.core.linear_model import read_model_file
    from mlease_tpu_torch.eval.score import run_regression_test
    from mlease_tpu_torch.io import avro

    config = _load_config(args.config)
    records = avro.read_records(config.get_string("input.paths"))
    with avro.AvroFileReader(avro.enumerate_avro_files(
            config.get_string("input.paths"))[0]) as r:
        input_schema = r.schema
    model_base = config.get_string("model.base.path")
    models = read_model_file(os.path.join(model_base, "final-model"))
    best = None
    best_dir = os.path.join(model_base, "best-model")
    if os.path.exists(best_dir):
        best_models = read_model_file(best_dir)
        if best_models:
            best = next(iter(best_models.values()))
    lambdas = config.get_string_list("lambda", list(models))
    out = run_regression_test(
        records, input_schema, models, config.get_string("output.base.path"),
        lambdas, best_model=best,
        ignore_value=config.get_boolean("binary.feature", False),
        device=args.device)
    print(json.dumps({"outputs": out}))
    return 0


def cmd_loglik(args):
    from mlease_tpu_torch.eval.loglik import run_test_loglik

    config = _load_config(args.config)
    if not config.get_boolean("get.test.loglik", True):
        print(json.dumps({"skipped": True}))
        return 0
    results = run_test_loglik(
        config.get_string("input.base.paths"),
        config.get_string("output.base.path"),
        config.get_string_list("lambda", []))
    print(json.dumps(results))
    return 0


def _decode_item_columnar(config, item_key: str, ignore_value: bool):
    """The item rows as one columnar decode keyed by the item column, or
    None when the native decoder is absent or fails, or the key column is
    not a string (the record-at-a-time path then runs)."""
    from mlease_tpu_torch.core.ingest import (decode_files_parallel,
                                              merge_decoded)
    from mlease_tpu_torch.io import avro, fast_decode

    if not fast_decode.is_available():
        logging.getLogger(__name__).warning(
            "native ingest: the decoder is unavailable; python path")
        return None
    try:
        decoded = merge_decoded(decode_files_parallel(
            avro.enumerate_avro_files(config.get_string("input.paths")),
            ignore_value=ignore_value, map_key=item_key))
    except (RuntimeError, ValueError, KeyError, OSError) as e:
        logging.getLogger(__name__).warning(
            "native ingest failed (%r); python path", e)
        return None
    if decoded.keys is None or set(decoded.keys) == {""}:
        return None                    # non-string key column
    return decoded


def cmd_item(args):
    from mlease_tpu_torch.core.prepare import prepare_to_keyed
    from mlease_tpu_torch.io import avro
    from mlease_tpu_torch.train.item import (ItemConfig, train_item_models,
                                             train_item_models_columnar,
                                             write_item_models)
    from mlease_tpu_torch.train.pipeline import DTYPES, read_lambda_map

    config = _load_config(args.config)
    item_key = config.get_string("item.key")
    ignore_value = config.get_boolean("binary.feature", False)
    # native.ingest (default on): the columnar route, straight from the
    # C++ decode to the packed buckets (mlease_tpu/cli.py:135-150)
    decoded = keyed = None
    if config.get_boolean("native.ingest", True):
        decoded = _decode_item_columnar(config, item_key, ignore_value)
    if decoded is None:
        records = avro.read_records(config.get_string("input.paths"))
        keyed = prepare_to_keyed(records, map_key=item_key,
                                 ignore_value=ignore_value)
    pm_map = None
    if config.get_string("intercept.prior.mean.map", ""):
        pm_map = {str(rec["key"]): float(rec["value"])
                  for rec in avro.read_records(
                      config.get_string("intercept.prior.mean.map"))}
    lambda_map = None
    if config.get_string("lambda.map", ""):
        lambda_map = read_lambda_map(config.get_string("lambda.map"))

    cfg = ItemConfig(
        intercept_lambdas=config.get_float_list("intercept.lambdas"),
        default_lambdas=config.get_float_list("default.lambdas"),
        intercept_default_prior_mean=config.get_float(
            "intercept.default.prior.mean", 0.0),
        intercept_prior_mean_map=pm_map,
        lambda_map=lambda_map,
        compute_var=config.get_boolean("compute.var", False),
        liblinear_epsilon=config.get_float("liblinear.epsilon", 0.01),
        dtype=DTYPES[config.get_string("dtype", "float32")])
    if decoded is not None:
        result = train_item_models_columnar(decoded, cfg, device=args.device)
    else:
        result = train_item_models(keyed, cfg, device=args.device)
    out = os.path.join(config.get_string("output.model.path"),
                       "part-r-00000.avro")
    write_item_models(out, result)
    print(json.dumps({"models": len(result.models), "output": out,
                      "device": args.device,
                      "kernel_launches": _kernel_launches()}))
    return 0


def cmd_itemtest(args):
    from mlease_tpu_torch.core.linear_model import LinearModel
    from mlease_tpu_torch.eval.item_score import (
        run_item_model_test, run_item_model_test_loglik,
        run_item_model_test_sharded)
    from mlease_tpu_torch.io import avro

    config = _load_config(args.config)
    records = avro.read_records(config.get_string("input.paths"))
    with avro.AvroFileReader(avro.enumerate_avro_files(
            config.get_string("input.paths"))[0]) as r:
        input_schema = r.schema
    out_base = config.get_string("output.base.path")
    model_path = config.get_string("model.path")
    pred_path = os.path.join(out_base, "pred", "part-r-00000.avro")
    common = dict(item_key=config.get_string("item.key"),
                  ignore_value=config.get_boolean("binary.feature", False),
                  device=args.device)
    # num.model.shards > 1: memory-bounded shard-by-shard model loading,
    # the analogue of the reference's per-reducer hash shard
    # (ItemModelTest.java:157-171); the default loads everything at once.
    nshards = config.get_int("num.model.shards", 1)
    if nshards > 1:
        scored = run_item_model_test_sharded(
            records, input_schema, model_path, pred_path,
            model_prefixes=(config.get_string_list("model.prefixes", [])
                            or None),
            nshards=nshards, **common)
    else:
        models = {rec["key"]: LinearModel.from_avro(rec["model"])
                  for rec in avro.read_records(model_path)}
        prefixes = config.get_string_list(
            "model.prefixes", sorted({k.split("#", 1)[0] for k in models}))
        scored = run_item_model_test(records, input_schema, models, pred_path,
                                     model_prefixes=prefixes, **common)
    agg = run_item_model_test_loglik(
        scored, os.path.join(out_base, "_loglik", "part-r-00000.avro"))
    print(json.dumps({"loglik": agg, "device": args.device,
                      "kernel_launches": _kernel_launches()}))
    return 0


def main(argv=None):
    logging.basicConfig(
        level=os.environ.get("MLEASE_LOG", "INFO"),
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    p = argparse.ArgumentParser(prog="mlease_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in [("train", cmd_train), ("test", cmd_test),
                     ("predict", cmd_test), ("loglik", cmd_loglik),
                     ("item", cmd_item), ("itemtest", cmd_itemtest)]:
        sp = sub.add_parser(name)
        sp.add_argument("config", help="properties-format job config file")
        sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="where the solver and scoring run (default "
                             "cuda; fails when no CUDA device is present)")
        sp.set_defaults(fn=fn)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
