"""Run one cell of the benchmark once and print its result as the last line.

    python3 -m splatbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic mix, its metrics and its limits are
found by name: ``BENCHMARK.json`` at the root of the checkout names the cell's
configuration file and metrics; ``splatbench/traffic/<traffic>.json`` holds the
mix, whose ``kind`` names the driver ``splatbench/drivers/<kind>.py``; each
metric is read by ``splatbench/metrics/<metric>.py``; the limits of the
outputs' comparison with the reference are ``splatbench/limits/<cell>.json``.
A new cell, configuration, mix or metric is new files and new entries.

Exit codes: 0 with a result line; 2 without the card the cell asks for; 3
when a module of JAX or of the JAX package was loaded; 1 on any other error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

from splatbench.device import name_and_power_limit  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "splatapult_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell_of(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(bench: dict, cell: dict, root: str = ROOT) -> dict:
    for entry in bench["configs"]:
        if entry["name"] == cell["config"]:
            return load_json(os.path.join(root, entry["file"]))
    raise KeyError(f"no config {cell['config']!r} in BENCHMARK.json")


def traffic_of(cell: dict, here: str = HERE) -> dict:
    return load_json(os.path.join(here, "traffic", cell["traffic"] + ".json"))


def limits_of(cell: dict, here: str = HERE) -> dict:
    path = os.path.join(here, "limits", cell["name"] + ".json")
    return load_json(path) if os.path.exists(path) else {}


def driver_of(kind: str):
    return importlib.import_module(f"splatbench.drivers.{kind}")


def metric_entries(bench: dict, cell_name: str, trace: bool) -> list:
    """The cell's end-to-end metrics (trace off) or per-layer metrics (on)."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if cell_name in m.get("workloads", [cell_name])]


def reader(name: str, here: str = HERE):
    """The ``read(out, ctx)`` function of ``metrics/<name>.py``."""
    path = os.path.join(here, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "splatbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def judge(values: dict, limits: dict):
    """Each compared number beside its limit -> (correct, {name: {value, limit}});
    a number without a limit, or not finite, is not correct."""
    checks, ok = {}, True
    for name, value in values.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not math.isfinite(value) or value > limit:
            ok = False
    return ok and bool(values), checks


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START, root: str = ROOT, here: str = HERE,
             overrides: dict | None = None) -> dict:
    """Everything of a run after the look for a card -> the result's dict."""
    bench = benchmark(root)
    cell = cell_of(bench, workload)
    traffic = traffic_of(cell, here)
    ctx = types.SimpleNamespace(
        cell=cell, config=config_of(bench, cell, root), traffic=traffic, seed=int(seed),
        seconds=float(seconds), trace=bool(trace), device=device, t_start=t_start,
        overrides=dict(overrides or {}))
    out = driver_of(traffic["kind"]).run(ctx)
    correct, checks = judge(out["checks"], limits_of(cell, here))
    metrics = {}
    for entry in metric_entries(bench, workload, trace):
        value = reader(entry["name"], here)(out, ctx)
        if value is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {entry['name']} read nothing")
            continue
        metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
            "device": out["device"]}
    if trace:
        line["breakdown"] = out["breakdown"]
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    # one process with one host thread: the host paces the smaller cells, and
    # idle intra-op threads only add to the noise of the host's clock
    torch.set_num_threads(1)
    chips = cell_of(benchmark(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"splatbench: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"splatbench: {torch.cuda.get_device_name(0)}; nvidia-smi name, power limit: "
          f"{name_and_power_limit()}", file=sys.stderr)
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"splatbench: modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
