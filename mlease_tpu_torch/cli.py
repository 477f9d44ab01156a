"""Command-line entry points of the PyTorch port.

`python -m mlease_tpu_torch <subcommand> <config.job> [--device cuda|cpu]`
reads the same properties-file job keys as `python -m mlease_tpu`
(reference: README.md:50, Regression.java:88-98). Subcommands:

  train    full pipeline Prepare -> AdmmTrain -> Test -> TestLoglik
  naive    RegressionNaiveTrain: independent per-(lambda,key) fits
  test     RegressionTest: score with an existing final-model/best-model
           ("predict" is an alias)
  loglik   RegressionTestLoglik: aggregate scored outputs
  item     ItemModelTrain: per-item models (+ posterior variance)
  itemtest ItemModelTest + ItemModelTestLoglik: score with per-item models
  fit      local single-problem fit on a libsvm file (LibLinear.main,
           LibLinear.java:519-724)

train and item read their input through the native columnar decoder when
`native.ingest` is on (the default), and record at a time otherwise or when
the decoder is unavailable. --device defaults to cuda and fails without a
CUDA device. The JSON summary line of train, naive, item and itemtest
carries `kernel_launches`, the calls of each hand-written kernel's
wrapper in the run (0 on the CPU): its eager launches, and the launches
that a device loop's capture recorded, whose executions on the card the
loop counts (ops/device_loop.py) and this count does not.

`train --mesh N` runs the job on a block mesh of N ranks (the use.mesh /
mesh.devices job keys), one process per rank, every rank running the
whole job: start them with

  python -m torch.distributed.run --nproc-per-node N \
      -m mlease_tpu_torch train --mesh N job.job [--device cpu]

(NCCL on the card, one card a rank; gloo with --device cpu). N must equal
the launcher's world size. Outside a launcher `--mesh 1` starts a one-rank
process group itself, and `--mesh N` for N > 1 raises, naming that command.
Only rank 0 writes files and prints the summary line.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import numpy as np


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
    from mlease_tpu_torch.ops.head_pass import head_xtv, head_xv
    from mlease_tpu_torch.ops.segment_sum import segment_sum_sorted

    return {"segment_sum_sorted": segment_sum_sorted.launches,
            "gram_batched": gram_batched.launches,
            "head_xv": head_xv.launches, "head_xtv": head_xtv.launches}


def cmd_train(args):
    from mlease_tpu_torch.parallel import distributed
    from mlease_tpu_torch.train.pipeline import run_regression_pipeline

    config = _load_config(args.config)
    if args.mesh:
        # --mesh N: a block mesh of N ranks (overrides the use.mesh /
        # mesh.devices job keys; the pipeline builds it)
        config.put("use.mesh", "true")
        config.put("mesh.devices", str(args.mesh))
    result = run_regression_pipeline(config, device=args.device)
    if not distributed.is_main():
        return 0
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


def cmd_naive(args):
    from mlease_tpu_torch.core.linear_model import write_model_file
    from mlease_tpu_torch.core.prepare import (prepare_to_blocks,
                                               prepare_to_keyed)
    from mlease_tpu_torch.io import avro
    from mlease_tpu_torch.train.naive import NaiveConfig, train_naive
    from mlease_tpu_torch.train.pipeline import DTYPES, read_lambda_map

    config = _load_config(args.config)
    records = avro.read_records(config.get_string("input.paths"))
    ignore_value = config.get_boolean("binary.feature", False)
    map_key = config.get_string("map.key", "")
    if map_key:
        keyed = prepare_to_keyed(records, map_key=map_key,
                                 ignore_value=ignore_value)
    else:
        nblocks = config.get_int("num.blocks")
        blocks = prepare_to_blocks(records, nblocks, ignore_value=ignore_value,
                                   seed=config.get_int("prepare.seed", 0))
        keyed = {str(i): b for i, b in enumerate(blocks)}
    del records

    lambda_map = None
    if config.get_string("lambda.map", ""):
        lambda_map = read_lambda_map(config.get_string("lambda.map"))
    cfg = NaiveConfig(
        lambdas=config.get_float_list("lambda"),
        # 0.001 default (RegressionNaiveTrain.java:149); the ADMM warm-start
        # init path uses 0.01 (train/pipeline.py)
        liblinear_epsilon=config.get_float("liblinear.epsilon", 0.001),
        has_intercept=config.get_boolean("has.intercept", True),
        intercept_key=config.get_string("intercept.key", "") or None,
        penalize_intercept=config.get_boolean("penalize.intercept", False),
        prior_mean=config.get_float("prior.mean", 0.0),
        lambda_map=lambda_map,
        data_size_threshold=config.get_int("data.size.threshold", 0),
        compute_model_mean=config.get_boolean("compute.model.mean", False),
        dtype=DTYPES[config.get_string("dtype", "float32")])
    result = train_naive(keyed, cfg, device=args.device)

    out_base = config.get_string("output.base.path")
    write_model_file(os.path.join(out_base, "models", "part-r-00000.avro"),
                     result.models)
    if result.mean_models is not None:
        write_model_file(os.path.join(out_base, "final-model",
                                      "part-r-00000.avro"),
                         result.mean_models)
    print(json.dumps({"models": len(result.models),
                      "skipped": result.skipped_keys,
                      "mean_models": (sorted(result.mean_models)
                                      if result.mean_models else None),
                      "device": args.device,
                      "kernel_launches": _kernel_launches()}))
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


# ---------------------------------------------------------------------------
def read_libsvm(path: str):
    """libsvm-ish lines: `label name:value name:value ...` (string feature
    names allowed, as in LibLinearDataset.readFromLibSVM,
    LibLinearDataset.java:216-310)."""
    rows = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            toks = line.split()
            if not toks:
                continue
            try:
                label = int(float(toks[0]))
            except ValueError as e:
                raise ValueError(f"{path}:{lineno}: bad label") from e
            feats = []
            for tok in toks[1:]:
                name, _, val = tok.rpartition(":")
                if not name:
                    raise ValueError(f"{path}:{lineno}: bad feature {tok!r}")
                feats.append((name, float(val)))
            rows.append({"response": label, "features": feats,
                         "weight": 1.0, "offset": 0.0})
    return rows


def _parse_fit_option(option: str):
    """The reference's `option:` string: comma-separated key=value with keys
    epsilon, type, max_iter, verbose, positive_weight
    (LibLinear.parseOption, LibLinear.java:113-157); unknown keys raise."""
    out = {}
    if not option:
        return out
    for tok in option.split(","):
        tok = tok.strip()
        if not tok:
            continue
        key, sep, val = tok.partition("=")
        key, val = key.strip(), val.strip()
        if not sep or not val:
            raise ValueError(f"Unknown option specification: '{tok}' "
                             f"in '{option}'")
        if key == "epsilon":
            out["epsilon"] = float(val)
        elif key == "max_iter":
            out["max_iter"] = int(val)
        elif key == "positive_weight":
            out["positive_weight"] = float(val)
        elif key == "type":
            out["type"] = val
        elif key == "verbose":
            out["verbose"] = int(val)
        else:
            raise ValueError(f"Invalid option specification: '{tok}' "
                             f"in '{option}'")
    return out


def _read_text_model(path: str, vocab, default: float = 0.0) -> np.ndarray:
    """'name = value' text map -> dense vector over the vocab
    (Util.readStringDoubleMap, the reference's init:/param: files)."""
    v = np.full(vocab.size, default)
    with open(path) as f:
        for line in f:
            name, _, value = line.partition("=")
            name = name.strip()
            idx = vocab.get(name)
            if idx is not None and value.strip():
                v[idx] = float(value)
    return v


def cmd_fit(args):
    """Local single-problem fit (LibLinear.main, LibLinear.java:519-724):
    one TRON solve, the text model, and with --posterior-var the diagonal
    Laplace variance, with --posterior-cov the full covariance (the dense
    Hessian through the weighted-Gram kernel on the card, inverted on the
    host in float64)."""
    import torch

    from mlease_tpu_torch.core import build_vocab, pack_rows
    from mlease_tpu_torch.ops import objective as obj
    from mlease_tpu_torch.ops.tron import tron

    opts = _parse_fit_option(args.option)
    if opts.get("type", "logistic_regression").startswith("0"):
        raise ValueError(f"unknown model type {opts['type']!r}")
    epsilon = opts.get("epsilon", args.epsilon)
    max_iter = opts.get("max_iter", args.max_iter)
    positive_weight = opts.get("positive_weight", args.positive_weight)
    if args.posterior_cov and not args.posterior_var:
        raise SystemExit(
            "Cannot compute posterior covariances with posteriorVar:0")

    if args.ftype == "json":
        from mlease_tpu_torch.io.records import read_json_rows

        rows = read_json_rows(args.data)
    elif args.ftype == "avro":
        from mlease_tpu_torch.io import avro
        from mlease_tpu_torch.io.records import normalize_row

        rows = [normalize_row(r) for r in avro.read_records(args.data)]
    else:
        rows = read_libsvm(args.data)
    if args.binary_feature:
        # LibLinearBinaryDataset semantics: all feature values treated as 1
        for row in rows:
            row["features"] = [(k, 1.0) for k, _v in row["features"]]
    vocab = build_vocab(rows, has_intercept=args.bias > 0)
    blk = pack_rows(rows, vocab, bias=args.bias if args.bias > 0 else 1.0)
    if positive_weight != 1.0:
        blk = blk._replace(weight=np.where(blk.y == 1,
                                           positive_weight * blk.weight,
                                           blk.weight))
    n = vocab.size
    pvi = np.full(n, 1.0 / args.prior_var)
    # per-feature prior mean file (param:) else the scalar --prior-mean
    pm = (_read_text_model(args.param, vocab, default=args.prior_mean)
          if args.param else np.full(n, args.prior_mean))
    dtype = torch.float64 if args.f64 else torch.float32
    prob = obj.make_problem(blk, pm, pvi, dtype=dtype, device=args.device)
    w0 = np.zeros(n)
    if args.init:
        # warm start from a previously written "name = value" text model
        # (LibLinear.main's init: option, LibLinear.java:557-563)
        w0 = _read_text_model(args.init, vocab)
    scale = float(obj.class_balance_eps_scale(
        blk.y[None], np.array([blk.nrows]))[0])
    res = tron(prob, torch.as_tensor(w0[None], dtype=dtype,
                                     device=prob.values.device),
               eps=epsilon * scale, max_iter=max_iter)
    w = res.w[0].to(torch.float64).cpu().numpy()

    text = "".join(f"{vocab.name(i)} = {w[i]:.17g}\n" for i in range(n))
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        if args.posterior_var:
            hd = obj.hessian_diagonal(prob, res.w)[0].to(
                torch.float64).cpu().numpy()
            with open(args.out + ".var", "w") as f:
                for i in range(n):
                    f.write(f"{vocab.name(i)} = {1.0 / hd[i]:.17g}\n")
            if args.posterior_cov:
                # full Laplace covariance = H^-1; text lines
                # "[name1, name2] = value" (Util.printStringListDoubleMap,
                # LibLinear.java:708-712)
                H = obj.dense_hessian(prob, res.w)[0].to(
                    torch.float64).cpu().numpy()
                cov = np.linalg.inv(H)
                names = [vocab.name(i) for i in range(n)]
                with open(args.out + ".cov", "w") as f:
                    for i in range(n):
                        f.write("".join(
                            f"[{names[i]}, {names[j]}] = {cov[i, j]:.17g}\n"
                            for j in range(n)))
    else:
        sys.stdout.write(text)
    print(f"# iterations={int(res.iterations[0])} "
          f"cg={int(res.cg_iterations[0])} f={float(res.f[0]):.8g} "
          f"converged={bool(res.converged[0])}", file=sys.stderr)
    return 0


def main(argv=None):
    logging.basicConfig(
        level=os.environ.get("MLEASE_LOG", "INFO"),
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    p = argparse.ArgumentParser(prog="mlease_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    device_help = ("where the solver and scoring run (default cuda; fails "
                   "when no CUDA device is present)")
    for name, fn in [("train", cmd_train), ("naive", cmd_naive),
                     ("test", cmd_test), ("predict", cmd_test),
                     ("loglik", cmd_loglik), ("item", cmd_item),
                     ("itemtest", cmd_itemtest)]:
        sp = sub.add_parser(name)
        sp.add_argument("config", help="properties-format job config file")
        sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help=device_help)
        if name == "train":
            sp.add_argument("--mesh", type=int, default=0, metavar="N",
                            help="run on a block mesh of N ranks (start "
                                 "them with python -m torch.distributed.run"
                                 " --nproc-per-node N)")
        sp.set_defaults(fn=fn)
    fit = sub.add_parser("fit")
    fit.add_argument("data", help="input file (libsvm/json/avro)")
    fit.add_argument("--ftype", choices=["libsvm", "json", "avro"],
                     default="libsvm")
    fit.add_argument("--out", default="")
    fit.add_argument("--bias", type=float, default=1.0)
    fit.add_argument("--prior-var", type=float, default=1.0)
    fit.add_argument("--prior-mean", type=float, default=0.0)
    fit.add_argument("--init", default="",
                     help="warm start from a text model written by --out")
    fit.add_argument("--param", default="",
                     help="per-feature prior-mean text file (param:)")
    fit.add_argument("--epsilon", type=float, default=0.01)
    fit.add_argument("--max-iter", type=int, default=1000)
    fit.add_argument("--positive-weight", type=float, default=1.0)
    fit.add_argument("--option", default="",
                     help="reference option string, e.g. "
                          "'max_iter=5,epsilon=0.01,positive_weight=2'")
    fit.add_argument("--binary-feature", action="store_true",
                     help="treat all feature values as 1 "
                          "(LibLinearBinaryDataset)")
    fit.add_argument("--posterior-var", action="store_true")
    fit.add_argument("--posterior-cov", action="store_true",
                     help="write the full Laplace covariance to <out>.cov")
    fit.add_argument("--f64", action="store_true")
    fit.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                     help=device_help)
    fit.set_defaults(fn=cmd_fit)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
