"""The port's benchmark: one cell of ``BENCHMARK.json`` per call.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (``benchmark/configs/<config>.json``: the
path that serves it and the program's settings) and a traffic mix
(``benchmark/traffic/<mix>.json``: parameters of the one generator,
:mod:`benchmark.generate`).  The configuration's ``path`` names the
driver (``benchmark/drivers/<path>.py``) that builds the system from the
seed, warms the cell's shapes, measures for ``--seconds`` and hands back
its records; each metric is read from those records by a reader of its
own (``benchmark/metrics/<metric>.py``), and the numbers that decide
``correct`` are held to the limits in ``benchmark/limits/<cell>.json``.
With ``--trace 0`` the cell's end-to-end metrics are reported, with
``--trace 1`` its per-layer ones, read in a profiled stretch of the
window.  The last line of standard output is the result; the numbers
compared, each beside its limit, are the last lines of standard error.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# The program's kernel library builds into its own ``_build/``; any other
# compiler cache a library might keep goes to fixed directories here.
CACHE = HERE / "_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "kubernetesnetawarescheduler_tpu")


def _environment() -> None:
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # One process drives the card; the host's cores are shared, so the
    # program's CPU operators run on the calling thread alone.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"


def loaded_forbidden() -> list[str]:
    """Top-level names of loaded modules that the benchmark may not load,
    each compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def reader(name: str, here: Path = HERE):
    """The reader module of metric ``name``, found by its file name."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Context:
    """What a driver gets: the cell's data, the seed, the device, the
    recorder, and the hooks by which it tells the harness when the window
    opened and closed."""

    def __init__(self, cell: dict, config: dict, traffic: dict, seed: int,
                 seconds: float, trace: bool, device: str,
                 t0: float) -> None:
        from benchmark.spans import Recorder

        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.t0 = t0
        self.recorder = Recorder()
        self.setup_s = None
        self.memory_peak_bytes = 0
        self.marks: dict[str, float] = {}

    def mark(self, stage: str) -> None:
        """Note how far into the run set-up's ``stage`` ended."""
        self.marks[stage] = round(time.perf_counter() - self.t0, 3)

    def sync(self) -> None:
        import torch

        if self.device.startswith("cuda"):
            torch.cuda.synchronize()

    def opened(self, t: float) -> None:
        self.setup_s = t - self.t0

    def window_closed(self) -> None:
        import torch

        self.sync()
        if self.device.startswith("cuda"):
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated())

    def free(self) -> None:
        import gc

        import torch

        gc.collect()
        if self.device.startswith("cuda"):
            torch.cuda.empty_cache()

    def stretch(self):
        from benchmark.trace import Stretch

        return Stretch("cuda" if self.device.startswith("cuda") else "cpu")


def applies(metric: dict, cell: dict) -> bool:
    return "workloads" not in metric or cell["name"] in metric["workloads"]


def measure(bench: dict, cell: dict, seed: int, seconds: float, trace: bool,
            device: str, t0: float, root: Path = ROOT) -> dict:
    """Run one cell on ``device`` and build its result (without the
    device check and the module guard of :func:`main`).  Data files are
    found under ``root``."""
    here = root / "benchmark"
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(root / conf["file"])
    traffic = load_json(here / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(here / "limits" / f"{cell['name']}.json")
    ctx = Context(cell, config, traffic, seed, seconds, trace, device, t0)
    driver = importlib.import_module(f"benchmark.drivers.{config['path']}")
    rec = driver.run(ctx)
    wanted = bench["per_layer"] if trace else bench["end_to_end"]
    metrics = {}
    for m in wanted:
        if not applies(m, cell):
            continue
        value = reader(m["name"], here).read(rec, ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = {k: {"value": float(v), "limit": float(limits[k])}
              for k, v in rec["checks"].items()}
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": int(rec["attempted"]),
        "failed": int(rec["failed"]),
        "metrics": metrics,
        "device": device_info(device, cell["chips"],
                              ctx.memory_peak_bytes),
    }
    if trace and "trace" in rec:
        from benchmark.trace import top

        tr = rec["trace"]
        print("trace " + json.dumps({
            "kernels": top(tr["kernels"], 40), "idle": top(tr["idle"], 40),
            "host_syncs": tr["host_syncs"],
            "launches": {k: len(v) for k, v in
                         (rec.get("launches") or {}).items()}}),
            file=sys.stderr)
        result["device"]["busy_s"] = tr["busy_s"]
        result["device"]["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": top(tr["kernels"]),
                               "idle_gaps": top(tr["idle"])}
    result["checks"] = checks
    result["reference_s"] = rec.get("reference_s", 0.0)
    result["diag"] = rec.get("diag", {})
    return result


def device_info(device: str, chips: int, peak: int) -> dict:
    import torch

    if device.startswith("cuda"):
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": peak}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark.run",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    cell = cells[args.workload]
    import torch

    torch.set_num_threads(1)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell["chips"])):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = measure(bench, cell, args.seed, args.seconds,
                     bool(args.trace), "cuda", T0)
    bad = loaded_forbidden()
    if bad:
        print(f"modules that may not be loaded were loaded: {bad}",
              file=sys.stderr)
        return 3
    print("window " + json.dumps(result.pop("diag")), file=sys.stderr)
    print(f"window closed; the reference took {result.pop('reference_s'):.3f}"
          " s", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
