"""The readings a float32 matrix cell's limits are set from, in one
process a cell: ``calibrate.py``'s, with the control one precision below
float32.

    python3 portbench/calibrate_f32.py --workload <cell> --seeds 12 \\
        [--first-seed N] [--seconds S]

For a dozen seeds or more it reads the program's numbers (the cell's
own set-up and a short window at the cell's load, the outputs kept as a
run keeps them); then the controls' on the first three seeds, the plain
reference put in the program's place below float32 (the configuration's
``reference_matvec(cfg, x, dtype, stored)``): ``control``, values, x,
products and sums in bfloat16; ``control_bf16_values`` and
``control_f16_values``, values and x rounded once to bfloat16 or to
float16 and summed in float32, as a kernel with a narrow slab would sum
them; then each fault of ``calibrate.py``, planted underneath the timed
path on the first three seeds.  Each reading is one JSON line on
standard output.  ``calibrate.py`` stays the float64 cells' tool.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path[0] = str(HERE.parent)

import torch  # noqa: E402

from portbench import calibrate, run  # noqa: E402

#: the controls, below the cell's float32: name -> (the type the values
#: and x are rounded to, the type of the products and sums)
CONTROLS = {
    "control": (torch.bfloat16, torch.bfloat16),
    "control_bf16_values": (torch.bfloat16, torch.float32),
    "control_f16_values": (torch.float16, torch.float32),
}


def readings(workload, seeds, seconds, device="cuda", cfg=None,
             traffic=None, faults=("unchanged", "half", "altered"),
             out=sys.stdout):
    """Program, control and fault readings of a float32 ``apply_stream``
    cell, its operator planned once (the matrix does not depend on the
    seed)."""
    ctx, _, _, _, loop = run.make_ctx(workload, seeds[0], device, cfg,
                                      traffic)
    if ctx.traffic["loop"] != "apply_stream" or \
            ctx.cfg["value_dtype"] != "float32":
        raise ValueError(f"{workload} is not a float32 apply_stream cell")
    loop.setup(ctx)
    recs = []

    def program(who, seed):
        ctx.seed = seed
        ctx.state["x"] = loop.draw_x(ctx)
        loop.window(ctx, seconds)
        recs.append(calibrate._emit(
            out, workload, who, seed,
            loop.compare(ctx, ctx.state.pop("outputs"))))

    for seed in seeds:
        program("program", seed)
    for who, (stored, dtype) in CONTROLS.items():
        for seed in seeds[:3]:
            ctx.seed = seed
            ctx.state["x"] = x = loop.draw_x(ctx)
            low = ctx.problem.reference_matvec(ctx.cfg, x, dtype, stored)
            recs.append(calibrate._emit(out, workload, who, seed,
                                        loop.compare(ctx, [low.double()])))
    for f in faults:
        with calibrate.matvec_fault(f, seeds[0]):
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
        print("calibrate_f32: no CUDA device", file=sys.stderr)
        return 3
    seeds = [args.first_seed + 7 * i for i in range(args.seeds)]
    readings(args.workload, seeds, args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
