"""The benchmark's one command.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card this process sees and
prints one JSON line as the last line of standard output.  Everything a
cell needs is found by name: the configuration in
``configs/<config>.json`` with its inputs and plain reference in
``configs/<config>.py``, the traffic mix in ``traffic/<traffic>.json``
(whose ``loop`` names ``loops/<loop>.py``), each per-layer metric's
reader in ``metrics/<metric>.py`` (or its family's, ``metrics/<name
before the first dot>.py``) and the comparison's limits in
``limits/<cell>.json``.

Set-up (from the start of this process: imports, inputs, the port's
planning and placement, the kernels' build on a checkout's first run,
warm-up) is timed as ``setup_s``; then the window runs for ``--seconds``
seconds.  With ``--trace 1`` a traced tail of fixed work follows the
window, and the line carries the per-layer metrics instead of the
end-to-end ones.  Once the window has closed, the program's state is
freed and the kept outputs are compared with the plain reference.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path[0] = str(ROOT)          # import the harness as a package
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import common, peaks  # noqa: E402

#: top-level module names the run must not hold once its window closes
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "spmv_vector_cache_tpu"})


def forbidden_modules(modules=None) -> list:
    """Top-level names in ``sys.modules`` that are JAX or the JAX
    package, compared whole (the port's name begins with the JAX
    package's)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)


def load_module(path: Path, name: str):
    """A harness file found by name, imported once a process (kept in
    ``sys.modules`` under ``name``)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path):
    with open(path) as f:
        return json.load(f)


def resolve(workload: str, manifest=None):
    """The cell, its configuration and traffic, and the metrics it
    reports: its end-to-end metrics and its per-layer metrics."""
    m = manifest if manifest is not None else _json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in m["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]

    def listed(metric):
        return workload in metric.get("workloads", [workload])

    e2e = [x for x in m["end_to_end"] if listed(x)]
    e2e_names = {x["name"] for x in e2e}
    layer = [x for x in m["per_layer"]
             if listed(x) and x["moves"] in e2e_names]
    return cell, e2e, layer


def reader_path(metric: str) -> Path:
    """A per-layer metric's reader: ``metrics/<metric>.py``, or else the
    reader of its family, the name's part before the first dot
    (``idle_share.cg`` -> ``metrics/idle_share.py``)."""
    own = HERE / "metrics" / f"{metric}.py"
    return own if own.exists() else HERE / "metrics" / \
        f"{metric.split('.')[0]}.py"


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e.__class__.__name__})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "not read"


def make_ctx(workload, seed, device, cfg_overrides=None,
             traffic_overrides=None):
    cell, e2e, layer = resolve(workload)
    cfg = _json(HERE / "configs" / f"{cell['config']}.json")
    cfg.update(cfg_overrides or {})
    traffic = _json(HERE / "traffic" / f"{cell['traffic']}.json")
    traffic.update(traffic_overrides or {})
    problem = load_module(HERE / "configs" / f"{cell['config']}.py",
                          f"portbench_config_{cell['config']}")
    ctx = common.Ctx(workload=workload, cfg=cfg, traffic=traffic,
                     seed=seed, device=device, problem=problem)
    loop = load_module(HERE / "loops" / f"{traffic['loop']}.py",
                       f"portbench_loop_{traffic['loop']}")
    return ctx, cell, e2e, layer, loop


def judge(compared: dict, limits: dict):
    """(correct, failed samples, the numbers beside their limits)."""
    if set(compared) != set(limits):
        raise KeyError(f"compared {sorted(compared)} but the limits name "
                       f"{sorted(limits)}")
    table, failed = {}, 0
    samples = max(len(v) for v in compared.values())
    for i in range(samples):
        if any(not (vals[i] <= limits[k]) for k, vals in compared.items()
               if i < len(vals)):
            failed += 1
    for k, vals in compared.items():
        worst = max(vals, key=lambda v: float("inf") if v != v else v)
        # JSON has no NaN or infinity: such a number is written as text
        table[k] = {"value": worst if math.isfinite(worst) else str(worst),
                    "limit": limits[k]}
    return failed == 0, failed, table


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", cfg_overrides=None,
             traffic_overrides=None):
    """One run of one cell; returns the result line as a dict.  The
    tests call it on the CPU at small sizes; the command only on a
    card."""
    ctx, cell, e2e, layer, loop = make_ctx(
        workload, seed, device, cfg_overrides, traffic_overrides)
    on_card = torch.device(device).type == "cuda"
    name = torch.cuda.get_device_name(0) if on_card else "cpu"
    ctx.peaks = peaks.peaks_for(name)

    ctx.mark("imports")
    loop.setup(ctx)
    common.sync(device)
    ctx.mark("warm")
    setup_s = time.perf_counter() - T_START
    steps, last = [], T_START
    for k, t in ctx.marks:
        steps.append(f"{k} {t - last:.3f}")
        last = t
    print(f"portbench: set-up {setup_s:.3f} s: " + ", ".join(steps),
          file=sys.stderr)
    loop.window(ctx, seconds)
    if traced:
        loop.traced(ctx)
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    if traced:
        metrics = {}
        for m in layer:
            v = load_module(reader_path(m["name"]),
                            f"portbench_metric_{m['name']}").read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(loop.end_to_end(ctx), setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in e2e}

    outputs = ctx.state.pop("outputs")
    loop.release(ctx)
    if on_card:
        torch.cuda.empty_cache()
    lim = _json(HERE / "limits" / f"{workload}.json")
    try:
        correct, failed, table = judge(loop.compare(ctx, outputs), lim)
    except Exception:            # the comparison is the run's verdict
        traceback.print_exc()
        correct, failed, table = False, len(outputs), {
            k: {"value": "none", "limit": v} for k, v in lim.items()}

    dev = {"platform": "gpu" if on_card else "cpu", "kind": name,
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak),
           "power_limit": power_limit() if on_card else "none"}
    line = {"correct": correct, "attempted": int(ctx.stats["units"]),
            "failed": failed, "metrics": metrics, "device": dev}
    if traced:
        tr = ctx.trace
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        line["breakdown"] = {"device_ops": [list(x) for x in tr.device_ops],
                             "idle_gaps": [list(x) for x in tr.idle_gaps]}
    line["check"] = table
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell, _, _ = resolve(args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs on the card "
              "only", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} cards, "
              f"this machine has {torch.cuda.device_count()}",
              file=sys.stderr)
        return 3
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}: the port must run without "
              f"JAX or the JAX package", file=sys.stderr)
        return 4
    print(f"portbench: {args.workload} seed {args.seed} on "
          f"{line['device']['power_limit']}", file=sys.stderr)
    for k, v in line["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
