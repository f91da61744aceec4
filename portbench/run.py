"""Run one cell of `BENCHMARK.json` once, on the card, and print its line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell names a configuration and a mix
(`portbench/spec.py`); the mix's driver (`portbench/drivers/`) makes the
inputs from the seed, warms every shape the mix uses (set-up, `setup_s`),
and then drives the program for `--seconds` (its `window`).

Every metric is read by its own reader, `portbench/metrics/<name>.py`,
from one context: the cell, the driver, the window's record, `setup_s`,
the allocator's peak over the window and, with `--trace 1`, what the
driver's `traced` pass gathered after the window (the program's spans,
the profiler's trace).  `--trace 0` reports the cell's end-to-end
metrics; `--trace 1` its per-layer metrics, with `busy_s`, `window_s`
and the `breakdown`.

After the window closes, the peak is read and the program's state is
freed, the driver's `checks` hold its kept answers to the plain
reference (`portbench/judge.py`), each number beside its limit.  The run
is `correct` when every unit returned and every number holds.  The
numbers are printed beside their limits as the last lines on standard
error and under `checks`, the result's last key.  The result is the
last line on standard output.

The run exits non-zero and prints no result when there is no card (or
fewer than the cell asks for), or when the process holds `jax`, `jaxlib`,
`flax` or the JAX package `image_analogies_tpu` once the window closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from typing import Any, Dict, List, Optional  # noqa: E402

from . import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "image_analogies_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names in `modules` (default `sys.modules`) that are JAX
    or the JAX package, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def written_bytes() -> Optional[int]:
    """This process's `write_bytes` from /proc/self/io."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("write_bytes:"):
                    return int(line.split()[1])
    except OSError:
        return None
    return None


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float = T0,
             log=sys.stderr) -> Dict[str, Any]:
    """One run of `cell`; returns the result line's object.  On a CPU
    device (tests) it drives the same path and reports no metric."""
    import torch

    from . import judge, trace_attr

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t_make = time.perf_counter()
    drv = spec.driver_module(cell.mix["driver"], cell.pkg).make(
        cell.config, cell.mix, seed, device)
    t_warm = time.perf_counter()
    drv.warm()
    sync()
    t_warm = time.perf_counter() - t_warm
    t_make = time.perf_counter() - t_make - t_warm
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0

    rec = drv.window(seconds, seed, sync)
    # What a metric reader reads: the cell (its entry, configuration and
    # mix), the driver, the window's record, `setup_s`, the peak and,
    # in a traced run, `traced` (the driver's `traced` pass).
    ctx: Dict[str, Any] = {
        "cell": cell, "driver": drv, "window": rec, "setup_s": setup_s,
        "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None,
    }
    dev_info: Dict[str, Any] = {"platform": "gpu" if cuda else "cpu",
                                "count": cell.chips}
    if cuda:
        dev_info["kind"] = torch.cuda.get_device_name(0)
        dev_info["memory_peak_bytes"] = int(ctx["peak_bytes"])
    breakdown = None
    if trace and rec["frames"]:
        ctx["traced"] = drv.traced(rec["units"], sync)
        summ = ctx["traced"]["trace"]
        if cuda and summ["busy_ms"] is not None:
            dev_info["busy_s"] = summ["busy_ms"] / 1e3
            dev_info["window_s"] = ctx["traced"]["profile_wall_s"]
            breakdown = {"device_ops": trace_attr.top(summ["scoped_ops"]),
                         "idle_gaps": trace_attr.top(summ["idle_ms"])}
    metrics: Dict[str, Dict[str, Any]] = {}
    # A CPU run's (tests') readings never go under a metric's name.
    readings = metrics if cuda else {}
    if rec["frames"]:
        for m in cell.per_layer() if trace else cell.end_to_end():
            value = spec.metric_reader(m["name"], cell.pkg)(ctx)
            if value is not None:
                readings[m["name"]] = {"value": value, "unit": m["unit"]}
    drv.release()
    ctx.clear()
    if cuda:
        torch.cuda.empty_cache()

    found = forbidden_modules()
    if found:
        raise SystemExit(f"the run loaded {', '.join(found)}: the harness "
                         "and the port must not import JAX or the JAX "
                         "package")

    checks = drv.checks(cell.config, device)
    correct = bool(checks) and rec["failed"] == 0 and all(
        judge.holds(c) for c in checks.values())
    result: Dict[str, Any] = {
        "correct": correct, "attempted": rec["attempted"],
        "failed": rec["failed"], "metrics": metrics, "device": dev_info,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    if readings is not metrics:
        result["cpu_readings"] = readings
    result["checks"] = checks
    print(f"setup_s {setup_s:.3f}: inputs {t_make:.3f}, warm unit "
          f"{t_warm:.3f}, before them {setup_s - t_make - t_warm:.3f}",
          file=log)
    print(f"units {rec['units']} frames {rec['frames']} window_s "
          f"{rec['window_s']:.3f} k1_launches {rec.get('k1_launches')}",
          file=log)
    unit_s = rec.get("unit_s", [])
    if len(unit_s) >= 10:
        dec = statistics.quantiles(unit_s, n=10)
        thirds = [statistics.median(unit_s[i * len(unit_s) // 3:
                                          (i + 1) * len(unit_s) // 3])
                  for i in range(3)]
        print("unit_ms p10 %.2f p50 %.2f p90 %.2f max %.2f; median by "
              "third of the window %s" % (
                  1e3 * dec[0], 1e3 * dec[4], 1e3 * dec[8],
                  1e3 * max(unit_s), " ".join(f"{1e3 * t:.2f}"
                                              for t in thirds)), file=log)
    print(f"wrote_bytes {written_bytes()}", file=log)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['holds']} "
              f"{c['limit']!r}", file=log)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = spec.load_benchmark()
    cell = spec.Cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
