"""The control of the comparison that decides ``correct``.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 [--pods N]

The plain reference put in the program's place, one precision below
what the configuration states: the network term's operands rounded to
float8 (e4m3) where the configuration rounds them to bfloat16, and the
rest, the usage ledger included, in bfloat16 where it states float32.
The driver of the configuration's path (``benchmark/drivers/<path>.py``)
says how: its ``control`` serves the cell's first ``--pods`` arrivals
in the cycles the program would serve them in, and the same comparison
as a run judges its answers and its ledger.  One JSON
line per seed; a control that comes out correct under the cell's limits
means the comparison cannot see that step.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

import torch

from benchmark.run import HERE, ROOT, load_json


def control(config: dict, traffic: dict, limits: dict, seed: int,
            pods_n: int, device: str, **precision) -> dict:
    """The control of the driver that serves ``config``'s path
    (``benchmark/drivers/<path>.py``, its ``control``), found by name."""
    driver = importlib.import_module(f"benchmark.drivers.{config['path']}")
    return driver.control(config, traffic, limits, seed, pods_n, device,
                          **precision)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--pods", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(ROOT / conf["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{cell['name']}.json")
    pods_n = args.pods or int(traffic.get("control_pods", 0)) or 1024
    for seed in (int(s) for s in args.seeds.split(",")):
        out = control(config, traffic, limits, seed, pods_n, args.device)
        print(json.dumps({"workload": cell["name"], **out}), flush=True)
        if args.device.startswith("cuda"):
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
