"""The readings each comparison limit is set from, in one process a cell.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 \\
        [--first-seed N] [--seconds S]

For a dozen seeds or more it reads the program's numbers (the cell's
own set-up and a short window at the cell's load, the outputs kept as a
run keeps them), then the control's on the first three seeds (the plain
reference put in the program's place one precision lower: float32 for
float64) and each fault the cell can have, planted underneath the timed
path on the first three seeds.  Each reading is one JSON line on
standard output.  The benchmark's own runs
never run this; the tests in ``tests/`` run the same functions on the
CPU at small sizes.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path[0] = str(HERE.parent)

import torch  # noqa: E402

from portbench import common, run  # noqa: E402
from portbench.plain_cg import plain_cg  # noqa: E402


# -- faults planted underneath the timed path ------------------------------

@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def matvec_fault(kind: str, seed: int):
    """A broken ``SparseOperator.matvec``: ``unchanged`` returns its input
    (the state unchanged), ``half`` leaves the second half of y's rows
    out, ``altered`` changes one entry of y where it is produced."""
    from spmv_vector_cache_tpu_torch import SparseOperator

    good = SparseOperator.matvec
    g = torch.Generator().manual_seed(common.torch_seed(seed))

    def broken(self, x):
        if kind == "unchanged":
            return torch.as_tensor(x).clone()
        y = good(self, x)
        if kind == "half":
            y[y.shape[0] // 2:] = 0
        elif kind == "altered":
            i = int(torch.randint(0, y.shape[0], (1,), generator=g))
            y[i] += 1e-6 * float(y.abs().max())
        return y

    return patched(SparseOperator, "matvec", broken)


# -- readings ---------------------------------------------------------------

def _emit(out, workload, who, seed, compared):
    rec = {"workload": workload, "who": who, "seed": seed,
           **{k: max(v) for k, v in compared.items()}}
    if out is not None:
        print(json.dumps(rec), file=out, flush=True)
    return rec


def matrix_readings(workload, seeds, seconds, device="cuda", cfg=None,
                    traffic=None, faults=("unchanged", "half", "altered"),
                    out=sys.stdout):
    """Program, control and fault readings of a matrix cell, its operator
    planned once (the matrix does not depend on the seed)."""
    ctx, _, _, _, loop = run.make_ctx(workload, seeds[0], device, cfg,
                                      traffic)
    loop.setup(ctx)
    kind = ctx.traffic["loop"]
    recs = []

    def program(who, seed):
        ctx.seed = seed
        if kind == "apply_stream":
            ctx.state["x"] = loop.draw_x(ctx)
        loop.window(ctx, seconds)
        recs.append(_emit(out, workload, who, seed,
                          loop.compare(ctx, ctx.state.pop("outputs"))))

    for seed in seeds:
        program("program", seed)
    ref32 = lambda v: ctx.problem.reference_matvec(ctx.cfg, v)  # noqa: E731
    for seed in seeds[:3]:
        ctx.seed = seed
        if kind == "apply_stream":
            ctx.state["x"] = loop.draw_x(ctx)
            outputs = [ref32(ctx.state["x"].float()).double()]
        else:
            it = int(ctx.traffic["maxiter"])
            x, r = plain_cg(ref32, ctx.state["b"].float(), it)
            outputs = [(x.double(), r, it)]
        recs.append(_emit(out, workload, "control", seed,
                          loop.compare(ctx, outputs)))
    for f in faults:
        with matvec_fault(f, seeds[0]):
            for seed in seeds[:3]:
                program(f"fault_{f}", seed)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=2**31 + 1000)
    ap.add_argument("--seconds", type=float, default=0.5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    seeds = [args.first_seed + 7 * i for i in range(args.seeds)]
    matrix_readings(args.workload, seeds, args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
