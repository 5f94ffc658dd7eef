"""The port's benchmark: one run of one cell, in this process.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1> [--out DIR]

Run from the root of a checkout. The cell is `benchmark/workloads/<cell>.json`;
it names its configuration (`benchmark/configs/<config>.json`), its traffic
(`benchmark/traffic/<traffic>.json`, which names the generator module
under `benchmark/traffic/` that makes its requests) and its entry
(`benchmark/entries/<entry>.py`, which sets the program up, drives the
window and checks what it produced against the reference). With --trace 0
the result carries the cell's end-to-end metrics, with --trace 1 its
per-layer metrics, each read by `benchmark/metrics/<metric>.py`; which
metrics a cell reports is BENCHMARK.json's.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device, with --trace 1 breakdown, and last the numbers
compared with their limits (`checks`), which also end standard error. The
card's state (clocks, power, temperature, throttle reasons, other
processes) before and after the window goes to standard error and, with
the run's details, to `<out>/<cell>.<seed>.<trace>.json` (default
`bench_out/`).

No result is printed, and the exit code is not 0, when no CUDA device is
there or fewer than the cell's chips, and when a JAX module or the JAX
package is loaded at the end of the run. Every build and kernel cache goes
under `build/` in the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "open_pandora_tpu")
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda_cache"}


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names}
                  & set(FORBIDDEN))


def host_speed() -> float:
    """Seconds a fixed piece of pure-Python work takes: the host's pace,
    which sets the launch rate."""
    t0 = time.perf_counter()
    sum(i * i for i in range(1_000_000))
    return time.perf_counter() - t0


def card_state() -> dict:
    """What nvidia-smi reads of the card and its other processes."""
    q = ("name,clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu,"
         "clocks_throttle_reasons.active")
    out = {}
    for key, args in (("gpus", ["--query-gpu=" + q]),
                      ("processes", ["--query-compute-apps=pid,used_memory"])):
        try:
            out[key] = subprocess.run(
                ["nvidia-smi", *args, "--format=csv,noheader"],
                capture_output=True, text=True, timeout=30
            ).stdout.strip().splitlines()
        except (OSError, subprocess.TimeoutExpired) as e:
            out[key] = [f"unread: {e}"]
    return out


def metric_applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported or not reported


def read_metric(name: str, record: dict):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(record)


class Cell:
    """One run's settings and the helpers an entry uses."""

    def __init__(self, name: str, seed: int, seconds: float, trace: bool,
                 device, workload: dict = None, config: dict = None):
        from traffic.generator import make

        self.name, self.seed, self.seconds = name, seed, seconds
        self.trace, self.device, self.t_start = trace, device, T_START
        self.workload = workload or load_json(HERE, "workloads",
                                              f"{name}.json")
        self.config = config or load_json(HERE, "configs",
                                          f"{self.workload['config']}.json")
        self.traffic = make(self.workload["traffic"], self.config, seed,
                            device)
        self.trace_item = self.workload.get("trace_item")
        self.marks = {}

    def mark(self, what: str) -> None:
        """Note the seconds since the process started at a set-up step."""
        self.marks[what] = time.perf_counter() - self.t_start

    def sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def profiler(self):
        """The device's activity (kernels, copies, memsets) and the CUDA
        runtime calls that launch them; no host op of its own, so that the
        host's pace, which sets the device's idle share here, stays
        nearly as it is without it."""
        from torch.profiler import ProfilerActivity, profile
        cuda = self.device.type == "cuda"
        return profile(activities=[ProfilerActivity.CUDA if cuda
                                   else ProfilerActivity.CPU])

    log = staticmethod(log)


def execute(cell: Cell, bench: dict) -> dict:
    """Run the cell's entry and build the result object (no printing)."""
    import torch

    entry = importlib.import_module(f"entries.{cell.workload['entry']}")
    record = entry.run(cell)
    e2e = [m for m in bench["end_to_end"]
           if metric_applies(m, cell.name, set())]
    reported = {m["name"] for m in e2e}
    if cell.trace:
        metrics = {}
        for m in bench["per_layer"]:
            if metric_applies(m, cell.name, reported):
                v = read_metric(m["name"], record)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": record["metrics"][m["name"]],
                               "unit": m["unit"]} for m in e2e}
    cuda = cell.device.type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": (torch.cuda.get_device_name(cell.device) if cuda
                       else "cpu"),
              "count": cell.workload["chips"],
              "memory_peak_bytes": record["memory_peak_bytes"]}
    result = {"correct": all(n["value"] <= n["limit"]
                             for n in record["numbers"].values()),
              "attempted": len(record["items"]), "failed": 0,
              "metrics": metrics, "device": device}
    tr = record.get("trace")
    if cell.trace and tr and tr.get("launches"):
        device["busy_s"], device["window_s"] = tr["busy_s"], tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = record["numbers"]
    return result, record


def main(argv=None) -> int:
    p = argparse.ArgumentParser("benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--out", default=os.path.join(ROOT, "bench_out"))
    args = p.parse_args(argv)
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = os.path.join(ROOT, "build", sub)
    os.environ["USE_FLAX"] = os.environ["USE_JAX"] = "0"
    sys.path[:0] = [HERE, ROOT]
    bench = load_json(ROOT, "BENCHMARK.json")
    workload = load_json(HERE, "workloads", f"{args.workload}.json")

    import torch

    marks = {"imports": time.perf_counter() - T_START}
    chips = workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            ": no result")
        return 3
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)
    marks["cuda_context"] = time.perf_counter() - T_START
    before = dict(card_state(), host_s=host_speed())
    log(f"card before: {json.dumps(before)}")
    cell = Cell(args.workload, args.seed, args.seconds, bool(args.trace),
                device, workload=workload)
    cell.marks.update(marks, card_state=time.perf_counter() - T_START)
    result, record = execute(cell, bench)
    after = dict(card_state(), host_s=host_speed())
    log(f"card after: {json.dumps(after)}")
    bad = forbidden_modules()
    if bad:
        log(f"loaded in this process: {bad}: no result")
        return 4
    os.makedirs(args.out, exist_ok=True)
    log("setup parts (s since start): "
        f"{json.dumps(record.get('setup_parts'))}")
    detail = dict(record, card_before=before, card_after=after,
                  torch=torch.__version__, cuda=torch.version.cuda,
                  result=result)
    with open(os.path.join(args.out, f"{args.workload}.{args.seed}."
                           f"{args.trace}.json"), "w") as f:
        json.dump(detail, f, indent=1, default=str)
    for k, n in result["checks"].items():
        log(f"check {k} {n['value']!r} limit {n['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
