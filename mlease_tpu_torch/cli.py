"""Command-line entry points of the PyTorch port.

`python -m mlease_tpu_torch <subcommand> <config.job> [--device cuda|cpu]`
reads the same properties-file job keys as `python -m mlease_tpu`
(reference: README.md:50, Regression.java:88-98). Subcommands:

  train    full pipeline Prepare -> AdmmTrain -> Test -> TestLoglik
  test     RegressionTest: score with an existing final-model/best-model
           ("predict" is an alias)
  loglik   RegressionTestLoglik: aggregate scored outputs

The JAX package's naive, item, itemtest and fit subcommands are not ported
yet (ROADMAP.md). --device defaults to cuda and fails without a CUDA device.
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


def cmd_train(args):
    from mlease_tpu_torch.ops.segment_sum import segment_sum_sorted
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
        "kernel_launches": {
            "segment_sum_sorted": segment_sum_sorted.launches},
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


def main(argv=None):
    logging.basicConfig(
        level=os.environ.get("MLEASE_LOG", "INFO"),
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    p = argparse.ArgumentParser(prog="mlease_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in [("train", cmd_train), ("test", cmd_test),
                     ("predict", cmd_test), ("loglik", cmd_loglik)]:
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
