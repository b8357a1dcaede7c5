"""Command-line interface: `python -m gpz_tpu_torch train|predict|bench`
(gpz_tpu.cli, same flags, defaults, CSV layout and JSON lines).

The reference's "CLI" is its demo scripts (SURVEY §1 L4); this is the
production replacement: train a model from a CSV catalog, checkpoint it,
and batch-predict with full uncertainty decomposition.

CSV format (ref demo_photoz.m:35-43): m_1..m_f,e_1..e_f,z_spec. The error
columns and target column are optional at predict time.

`train` and `predict` take one flag gpz_tpu's do not: `--device` (default
cuda), where the model is built or loaded; gpz_tpu chooses its platform by
JAX_PLATFORMS instead. Without a CUDA device the default raises torch's
error. Checkpoints are format v1, which either package reads.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _add_common(ap):
    ap.add_argument("--method", default="VD",
                    choices=["GL", "VL", "GD", "VD", "GC", "VC"])
    ap.add_argument("--m", type=int, default=100)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--seed", type=int, default=1)


def _add_device(ap):
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (default: cuda)")


def cmd_train(argv):
    ap = argparse.ArgumentParser(prog="gpz train")
    ap.add_argument("data", help="CSV: m_1..m_f,e_1..e_f,z_spec")
    ap.add_argument("--out", required=True, help="checkpoint path (.npz)")
    _add_common(ap)
    _add_device(ap)
    ap.add_argument("--max-iter", type=int, default=200)
    ap.add_argument("--max-attempts", type=int, default=50)
    ap.add_argument("--train-frac", type=float, default=0.7)
    ap.add_argument("--valid-frac", type=float, default=0.15)
    ap.add_argument("--csl", default="normal",
                    choices=["normal", "normalized", "balanced"])
    ap.add_argument("--no-input-noise", action="store_true",
                    help="use error columns as extra features instead of Psi")
    ap.add_argument("--no-errors", action="store_true",
                    help="CSV has no error columns (features,target only)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="checkpoint every N iterations (0 = only at end)")
    args = ap.parse_args(argv)

    import gpz_tpu_torch
    from gpz_tpu_torch import datautils, native
    from gpz_tpu_torch.checkpoint import save_model, train_with_checkpoints

    raw = native.read_csv(args.data)
    Y = raw[:, -1]
    rest = raw[:, :-1]
    if args.no_errors:
        X, psi = rest, None
    else:
        f = rest.shape[1] // 2
        if args.no_input_noise:
            X = np.hstack([rest[:, :f], np.log(rest[:, f:])])
            psi = None
        else:
            X = rest[:, :f]
            psi = rest[:, f:] ** 2

    n = len(Y)
    rng = np.random.default_rng(args.seed)
    tr, va, _ = datautils.split(
        n, args.train_frac, args.valid_frac,
        1 - args.train_frac - args.valid_frac, rng,
    )
    omega = datautils.get_omega(Y, args.csl)

    t0 = time.perf_counter()
    model = gpz_tpu_torch.init(
        X, Y, args.method, args.m, omega=omega, training=tr, psi=psi,
        seed=args.seed, dtype=args.dtype, device=args.device,
    )
    kw = dict(omega=omega, training=tr, validation=va, psi=psi,
              max_attempts=args.max_attempts)
    if args.checkpoint_every > 0:
        model = train_with_checkpoints(
            model, X, Y, checkpoint_path=args.out,
            segment_iters=args.checkpoint_every, max_iter=args.max_iter, **kw,
        )
    else:
        model = gpz_tpu_torch.train(model, X, Y, max_iter=args.max_iter, **kw)
        save_model(model, args.out)
    dt = time.perf_counter() - t0
    print(json.dumps({
        "saved": args.out,
        "iterations": model.fit_info["iterations"],
        "fun_evals": model.fit_info["fun_evals"],
        "best_valid_ll": model.best.score,
        "train_seconds": round(dt, 2),
    }))


def cmd_predict(argv):
    ap = argparse.ArgumentParser(prog="gpz predict")
    ap.add_argument("data", help="CSV: m_1..m_f[,e_1..e_f][,z_spec]")
    ap.add_argument("--model", required=True)
    ap.add_argument("--out", required=True, help="output CSV path")
    ap.add_argument("--which-set", default="best", choices=["best", "last"])
    ap.add_argument("--has-target", action="store_true")
    ap.add_argument("--has-errors", action="store_true")
    _add_device(ap)
    args = ap.parse_args(argv)

    import gpz_tpu_torch
    from gpz_tpu_torch import native
    from gpz_tpu_torch.checkpoint import load_model

    model = load_model(args.model, device=args.device)
    raw = native.read_csv(args.data)
    y = None
    if args.has_target:
        y = raw[:, -1]
        raw = raw[:, :-1]
    if args.has_errors:
        f = raw.shape[1] // 2
        X, psi = raw[:, :f], raw[:, f:] ** 2
    else:
        X, psi = raw, None

    pred = gpz_tpu_torch.predict(X, model, psi=psi, which_set=args.which_set)
    cols = [pred.mu[:, 0], pred.sigma[:, 0], pred.nu[:, 0],
            pred.beta_i[:, 0], pred.gamma[:, 0]]
    header = "mu,sigma,nu,beta_i,gamma"
    if y is not None:
        cols.insert(0, y)
        header = "target," + header
        err = y - pred.mu[:, 0]
        rmse = float(np.sqrt(np.mean(err**2)))
        mll = float(np.mean(
            -0.5 * err**2 / pred.sigma[:, 0]
            - 0.5 * np.log(pred.sigma[:, 0])
        ) - 0.5 * np.log(2 * np.pi))
        print(json.dumps({"rmse": rmse, "mll": mll, "n": len(y)}))
    np.savetxt(args.out, np.column_stack(cols), delimiter=",",
               header=header, comments="")
    print(json.dumps({"wrote": args.out}))


def cmd_bench(argv):
    from gpz_tpu_torch import bench
    bench.main()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m gpz_tpu_torch {train,predict,bench} ...")
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "train":
        return cmd_train(rest)
    if cmd == "predict":
        return cmd_predict(rest)
    if cmd == "bench":
        return cmd_bench(rest)
    print(f"unknown command {cmd!r}; expected train|predict|bench")
    return 1


if __name__ == "__main__":
    sys.exit(main())
