"""The command line: ``python -m sparkfm_tpu_torch COMMAND``. Port of
``sparkfm_tpu/cli.py``: the same subcommands, flags and JSON output, plus
``--device`` (default ``cuda``: the commands that train or score run on
the card unless given ``--device cpu``, and raise without one).

  train           libFM (or synthetic) data -> solver -> metrics
                  (the reference's train-and-evaluate flow, generalized)
  vectorize       raw delimited text + schema [+ relations] -> libFM file
                  (the reference's dormant export demos)
  eval            saved model + libFM data -> metrics
  predict         saved model + libFM data -> one score per line
  verify-data     a mounted public dataset: format + published row counts
  movielens-demo  the reference's canonical testALS flow end-to-end
                  on generated MovieLens-shaped data

``train --mesh DxM`` trains over a (data, model) mesh of ranks;
``--distributed`` joins the ``torchrun`` world first (``python -m
torch.distributed.run --nproc-per-node N -m sparkfm_tpu_torch train
--mesh ... --distributed``). Every rank trains; rank 0 prints the JSON
line and saves the model. A one-process run takes only ``--mesh 1x1``.
``predict`` and ``eval`` load a DeepFM model directory as a DeepFM by its
tag (``api.py::load_model``); the JAX CLI loads every directory as a plain
FM and fails with a ``KeyError`` on a DeepFM one.

Schema DSL (for --schema / relation specs): comma-separated column kinds —
  target | identity | list[:SEP] | number | time | hashed:N | ignored
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from sparkfm_tpu_torch.config import Task
from sparkfm_tpu_torch.utils import device as device_util


def parse_schema(spec: str):
    """'identity,identity,target' (+ 'list:|', 'hashed:4096') -> [Column]."""
    from sparkfm_tpu_torch.data import schema as S
    cols = []
    for i, tok in enumerate(spec.split(",")):
        tok = tok.strip()
        kind, _, arg = tok.partition(":")
        kind = kind.lower()
        name = f"col{i}"
        if kind == "target":
            cols.append(S.Target(name))
        elif kind == "identity":
            cols.append(S.Identity(name))
        elif kind == "list":
            cols.append(S.List(name, separator=arg or ","))
        elif kind == "number":
            cols.append(S.Number(name))
        elif kind == "time":
            cols.append(S.Time(name))
        elif kind == "hashed":
            cols.append(S.Hashed(int(arg), name))
        elif kind == "ignored":
            cols.append(S.Ignored(name))
        else:
            raise ValueError(f"unknown column kind {tok!r}")
    return cols


def _load_dataset(args):
    """Returns (SparseDataset, fitted Vectorizer | None)."""
    from sparkfm_tpu_torch.data import libfm, synth
    if args.libfm:
        return libfm.load_libfm(args.libfm,
                                num_features=args.num_features), None
    if args.raw:
        # one-command raw-text flow: vectorize inline (keeps the fitted
        # Vectorizer so --groups auto can derive per-column groups)
        from sparkfm_tpu_torch.data.schema import read_delimited
        from sparkfm_tpu_torch.data.vectorizer import Vectorizer
        if not args.schema:
            raise SystemExit("--raw needs --schema")
        vec = Vectorizer(parse_schema(args.schema))
        rows = list(read_delimited(args.raw, args.separator))
        return vec.fit_transform(rows), vec
    if args.movielens:
        from sparkfm_tpu_torch.data import datasets
        return datasets.load_movielens(args.movielens)
    if args.criteo:
        from sparkfm_tpu_torch.data import datasets
        buckets = args.num_features if args.num_features > 0 else 1 << 24
        return datasets.load_criteo_tsv(
            args.criteo, num_buckets=buckets,
            with_fields=args.fields > 0), None
    if args.avazu:
        from sparkfm_tpu_torch.data import datasets
        buckets = args.num_features if args.num_features > 0 else 1 << 24
        return datasets.load_avazu_csv(args.avazu, num_buckets=buckets), None
    if args.synth == "movielens":
        return synth.synth_movielens(num_examples=args.synth_examples,
                                     seed=args.seed), None
    if args.synth == "ctr":
        return synth.synth_ctr(num_examples=args.synth_examples,
                               seed=args.seed), None
    raise SystemExit("need --libfm/--raw/--movielens/--criteo/--avazu PATH "
                     "or --synth movielens|ctr")


def _resolve_groups(args, vec):
    """--groups auto|FILE -> FM(feature_groups=...) value."""
    spec = args.groups
    if not spec:
        return None
    if spec == "auto":
        if vec is None:
            raise SystemExit(
                "--groups auto needs a vectorized input (--raw + --schema "
                "or --movielens); for --libfm pass a groups JSON file "
                "saved by `vectorize --save-groups`")
        return vec
    with open(spec) as f:
        return tuple(json.load(f))


def cmd_train(args) -> int:
    from sparkfm_tpu_torch.api import FM
    from sparkfm_tpu_torch.data.split import split_by_random

    from sparkfm_tpu_torch.parallel import multihost

    if args.distributed and not multihost.initialize(device=args.device):
        raise SystemExit("--distributed needs the torchrun environment "
                         "(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT): "
                         "launch with python -m torch.distributed.run")
    ds, vec = _load_dataset(args)
    if args.test_libfm:
        from sparkfm_tpu_torch.data import libfm
        train, test = ds, libfm.load_libfm(args.test_libfm,
                                           num_features=ds.num_features)
    elif args.split:
        w = [float(x) for x in args.split.split(",")]
        coll = split_by_random(ds, *w, seed=args.seed)
        train, test = coll.training, coll.test
    else:
        train, test = ds, None

    task = Task(args.task)
    fm = FM(num_factors=args.factors, task=task, max_iter=args.iters,
            solver=args.solver, timeout=args.timeout,
            reg0=args.reg0, reg_w=args.reg_w,
            reg_v=args.reg_v, init_stdev=args.init_stdev, seed=args.seed,
            learning_rate=args.lr, batch_size=args.batch_size,
            optimizer=args.optimizer, num_fields=args.fields,
            eval_every=args.eval_every,
            update_path=args.update_path,
            steps_per_dispatch=args.steps_per_dispatch,
            mesh=args.mesh,
            exchange=args.exchange,
            model=args.model,
            hidden=tuple(int(x) for x in args.hidden.split(",")),
            dropout=args.dropout,
            feature_groups=_resolve_groups(args, vec),
            group_reg_w=(tuple(float(x) for x in args.group_reg_w.split(","))
                         if args.group_reg_w else None),
            group_reg_v=(tuple(float(x) for x in args.group_reg_v.split(","))
                         if args.group_reg_v else None))
    model = fm.fit(train, eval_ds=test, checkpoint_dir=args.checkpoint_dir,
                   device=args.device)

    out = {"examples_per_sec": round(model.examples_per_sec, 1),
           "train_examples": train.num_examples,
           "num_features": train.num_features}
    if test is not None:
        out.update({f"test_{k}": round(v, 6)
                    for k, v in model.evaluate(test).items()})
    if multihost.process_index():
        return 0        # every rank holds the model; rank 0 reports it
    if args.save_model:
        model.save(args.save_model)
        out["saved_to"] = args.save_model
    print(json.dumps(out))
    return 0


def cmd_vectorize(args) -> int:
    from sparkfm_tpu_torch.data import libfm
    from sparkfm_tpu_torch.data.schema import read_delimited
    from sparkfm_tpu_torch.data.vectorizer import (RelationVectorizer,
                                                   Vectorizer)

    schema = parse_schema(args.schema)
    if args.relation:
        vec = RelationVectorizer(schema)
        for spec in args.relation:
            # PATH:SCHEMA:JOINCOL[:SEP]
            parts = spec.split(";")
            if len(parts) < 3:
                raise SystemExit(
                    "--relation format: PATH;SCHEMA;JOINCOL[;SEP]")
            path, rschema, joincol = parts[0], parts[1], int(parts[2])
            sep = parts[3] if len(parts) > 3 else args.separator
            vec.add_relation(read_delimited(path, sep),
                             parse_schema(rschema), joincol)
    else:
        vec = Vectorizer(schema)
    rows = list(read_delimited(args.input, args.separator))
    ds = vec.fit(rows).transform(rows)
    libfm.save_libfm(ds, args.output)
    if args.save_vocab:
        vec.save_vocab(args.save_vocab)
    if args.save_groups:
        from sparkfm_tpu_torch.data.vectorizer import feature_groups_of
        with open(args.save_groups, "w") as f:
            json.dump(list(feature_groups_of(vec)), f)
    print(json.dumps({"examples": ds.num_examples,
                      "num_features": ds.num_features,
                      "max_nnz": ds.max_nnz,
                      "dropped": vec.rows_dropped,
                      "output": args.output}))
    return 0


def _load_model_and_data(args):
    """The saved model (FM or DeepFM, by its tag) on ``--device`` and the
    ``--libfm`` data in its feature space."""
    from sparkfm_tpu_torch.api import load_model
    from sparkfm_tpu_torch.data import libfm

    model = load_model(args.model, device=args.device)
    fm_cfg = getattr(model.cfg, "fm", model.cfg)
    return model, libfm.load_libfm(args.libfm,
                                   num_features=fm_cfg.num_features)


def cmd_predict(args) -> int:
    """Batch scoring: saved model + libFM file -> one prediction per line
    (raw score for regression, P(y=1) for classification). The serving
    analog of the reference's predict-only surface (FMModel.scala:34)."""
    model, ds = _load_model_and_data(args)
    preds = model.predict_dataset(ds, batch_size=args.batch_size)
    out = args.output or "-"
    if out == "-":
        for p_ in preds:
            print(f"{p_:.6g}")
    else:
        with open(out, "w") as f:
            for p_ in preds:
                f.write(f"{p_:.6g}\n")
        print(json.dumps({"examples": int(len(preds)), "output": out}))
    return 0


def cmd_eval(args) -> int:
    model, ds = _load_model_and_data(args)
    print(json.dumps({k: round(v, 6)
                      for k, v in model.evaluate(ds).items()}))
    return 0


def cmd_movielens_demo(args) -> int:
    """The reference's canonical testALS flow: MovieLens-shaped
    ratings with a user side-table join, 80/20 split, FM(k=2) x 3 ALS iters,
    report test RMSE."""
    import numpy as np

    from sparkfm_tpu_torch.api import FM
    from sparkfm_tpu_torch.data.schema import Identity, Target
    from sparkfm_tpu_torch.data.split import split_by_random
    from sparkfm_tpu_torch.data.vectorizer import RelationVectorizer

    rng = np.random.default_rng(args.seed)
    n_users, n_items = 500, 400
    users = [[str(u), "MF"[u % 2], str(18 + u % 5), str(u % 21)]
             for u in range(n_users)]
    bu = 0.4 * rng.standard_normal(n_users)
    bi = 0.4 * rng.standard_normal(n_items)
    rows = []
    for _ in range(args.synth_examples):
        u, m = int(rng.integers(n_users)), int(rng.integers(n_items))
        y = float(np.clip(3.6 + bu[u] + bi[m] + 0.2 * rng.standard_normal(),
                          1, 5))
        rows.append([f"{y:.3f}", str(u), f"m{m}"])

    vec = RelationVectorizer([Target("rating"), Identity("user"),
                              Identity("movie")])
    vec.add_relation(users, [Target("uid"), Identity("gender"),
                             Identity("age"), Identity("occupation")],
                     join_column=1)
    ds = vec.fit_transform(rows)
    coll = split_by_random(ds, 0.8, 0.2, seed=args.seed)

    fm = FM(num_factors=args.factors, max_iter=args.iters, solver="als",
            reg_v=args.reg_v, seed=args.seed)
    model = fm.fit(coll.training, eval_ds=coll.test, device=args.device)
    rmse = model.compute_rmse(coll.test)
    print(json.dumps({"test_rmse": round(rmse, 5),
                      "num_features": ds.num_features,
                      "train_examples": coll.training.num_examples}))
    return 0


def cmd_verify_data(args) -> int:
    from sparkfm_tpu_torch.data import verify as V
    rep = V.verify(args.path, dataset=args.dataset, quick=args.quick)
    print(json.dumps(rep, indent=2))
    return 0 if rep["ok"] else 1


def _device_flag(parser) -> None:
    parser.add_argument("--device", default=device_util.DEFAULT,
                        help="torch device to train or score on (default "
                             "'cuda'; 'cpu' to run without a card)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sparkfm_tpu_torch",
                                description=__doc__,
                                formatter_class=(
                                    argparse.RawDescriptionHelpFormatter))
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("train", help="train an FM on libFM or synthetic data")
    t.add_argument("--libfm", help="libFM-format training file")
    t.add_argument("--test-libfm", help="libFM-format test file")
    t.add_argument("--raw", help="raw delimited text (vectorized inline "
                                 "with --schema; enables --groups auto)")
    t.add_argument("--schema", help="column schema for --raw (see module "
                                    "doc DSL)")
    t.add_argument("--separator", default="::",
                   help="separator for --raw (default '::')")
    t.add_argument("--movielens",
                   help="MovieLens ratings file/dir (u.data, ratings.dat "
                        "or ratings.csv; format auto-detected)")
    t.add_argument("--criteo", help="Criteo Kaggle train.txt (hashed into "
                                    "--num-features buckets, default 2^24)")
    t.add_argument("--avazu", help="Avazu train.csv (hashed)")
    t.add_argument("--groups", default=None,
                   help="'auto' (one reg group per source column; needs "
                        "--raw or --movielens) or a JSON file of "
                        "per-feature group ids (vectorize --save-groups)")
    t.add_argument("--group-reg-w", default=None,
                   help="per-group linear-term lambdas, comma-separated")
    t.add_argument("--group-reg-v", default=None,
                   help="per-group factor-term lambdas, comma-separated")
    t.add_argument("--synth", choices=["movielens", "ctr"],
                   help="generate synthetic data instead of loading")
    t.add_argument("--synth-examples", type=int, default=100000)
    t.add_argument("--num-features", type=int, default=-1,
                   help="feature dim; -1 = infer from data")
    t.add_argument("--split", default=None,
                   help="train,test[,val] weights, e.g. 0.8,0.2")
    t.add_argument("--task", choices=[x.value for x in Task],
                   default="regression")
    t.add_argument("--solver", default="als",
                   choices=["als", "sgd", "mcmc"])
    t.add_argument("--factors", type=int, default=8)
    t.add_argument("--iters", type=int, default=10)
    t.add_argument("--reg0", type=float, default=0.0)
    t.add_argument("--reg-w", type=float, default=0.0)
    t.add_argument("--reg-v", type=float, default=0.1)
    t.add_argument("--init-stdev", type=float, default=0.01)
    t.add_argument("--lr", type=float, default=0.05)
    t.add_argument("--batch-size", type=int, default=8192)
    t.add_argument("--fields", type=int, default=0,
                   help="FFM: number of fields (>0 enables field-aware "
                        "factors; --synth ctr emits per-field ids)")
    t.add_argument("--model", default="fm", choices=["fm", "deepfm"],
                   help="deepfm = FM heads + MLP tower (needs --fields; "
                        "BASELINE config 5)")
    t.add_argument("--hidden", default="128,64",
                   help="deepfm tower widths, comma-separated")
    t.add_argument("--dropout", type=float, default=0.0,
                   help="deepfm: probability of dropping a hidden unit of "
                        "the tower in a train step (0 = none)")
    t.add_argument("--mesh", default=None,
                   help="train over a (data, model) mesh of ranks, e.g. "
                        "'4x2' = 4-way data x 2-way table row sharding "
                        "(solver sgd, als or mcmc; more than one rank "
                        "needs --distributed under torchrun)")
    t.add_argument("--distributed", action="store_true",
                   help="join the torchrun world first (every rank runs "
                        "this command; NCCL on the card, gloo with "
                        "--device cpu)")
    t.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="hybrid path: run this many staged batches per "
                        "dispatch (a CUDA graph on the card; update "
                        "sequence unchanged)")
    t.add_argument("--update-path", default="auto",
                   choices=["auto", "direct", "dedup", "fused", "sorted",
                            "hybrid"],
                   help="SGD table-access path (auto: hybrid/fused/dedup/"
                        "direct by table size and model)")
    t.add_argument("--exchange", default="auto",
                   choices=["auto", "unique", "global", "dense"],
                   help="sharded sparse gradient exchange (with --mesh)")
    t.add_argument("--optimizer", default="adagrad",
                   choices=["adagrad", "sgd", "adam"])
    t.add_argument("--timeout", type=float, default=0.0,
                   help="wall-clock training budget in seconds (0 = "
                        "unlimited); stops at the next epoch/sweep "
                        "boundary, checkpoint-safe — the reference's "
                        "FM.apply timeout knob (FM.scala:30), honored")
    t.add_argument("--eval-every", type=int, default=1)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--checkpoint-dir")
    t.add_argument("--save-model")
    _device_flag(t)
    t.set_defaults(fn=cmd_train)

    v = sub.add_parser("vectorize",
                       help="raw delimited text + schema -> libFM file")
    v.add_argument("--input", required=True)
    v.add_argument("--separator", default="::")
    v.add_argument("--schema", required=True,
                   help="e.g. 'identity,identity,target'")
    v.add_argument("--relation", action="append",
                   help="PATH;SCHEMA;JOINCOL[;SEP] (repeatable)")
    v.add_argument("--output", required=True)
    v.add_argument("--save-vocab")
    v.add_argument("--save-groups",
                   help="write per-feature group ids (one group per source "
                        "column) as JSON, for train --groups FILE")
    v.set_defaults(fn=cmd_vectorize)

    e = sub.add_parser("eval", help="evaluate a saved model on libFM data")
    e.add_argument("--model", required=True)
    e.add_argument("--libfm", required=True)
    _device_flag(e)
    e.set_defaults(fn=cmd_eval)

    pr = sub.add_parser("predict",
                        help="score libFM data with a saved model")
    pr.add_argument("--model", required=True)
    pr.add_argument("--libfm", required=True)
    pr.add_argument("--output", default=None,
                    help="write one prediction per line ('-' or omit = "
                         "stdout)")
    pr.add_argument("--batch-size", type=int, default=8192)
    _device_flag(pr)
    pr.set_defaults(fn=cmd_predict)

    vd = sub.add_parser(
        "verify-data",
        help="verify a mounted real dataset file (format + published row "
             "counts) and print the BASELINE quality-gate reproduction "
             "command — the zero-egress onboarding gate (data/verify.py)")
    vd.add_argument("path", help="dataset file (u.data, ratings.dat, "
                                 "ratings.csv, train.txt, train.csv)")
    vd.add_argument("--dataset", choices=["ml-100k", "ml-1m", "ml-25m",
                                          "criteo", "avazu"],
                    help="override filename-based detection")
    vd.add_argument("--quick", action="store_true",
                    help="format-check the first 100K rows only (skip "
                         "the full row count)")
    vd.set_defaults(fn=cmd_verify_data)

    d = sub.add_parser("movielens-demo",
                       help="the reference's canonical ALS flow")
    d.add_argument("--factors", type=int, default=2)
    d.add_argument("--iters", type=int, default=3)
    d.add_argument("--reg-v", type=float, default=0.5)
    d.add_argument("--synth-examples", type=int, default=50000)
    d.add_argument("--seed", type=int, default=0)
    _device_flag(d)
    d.set_defaults(fn=cmd_movielens_demo)

    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
