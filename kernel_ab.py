"""Hand-written kernels, the parent commit's design against this tree's,
timed on one card in one call.

    python3 kernel_ab.py PARENT_TREE --symbols SYM[,SYM...] \\
        --rows SOURCE:ROW[,SOURCE:ROW...] [--turns 3]

PARENT_TREE is a ``git archive`` of the parent commit, unpacked into a
directory that ``.gitignore`` lists (``_chipcheck/parent``).  Each turn
runs one tree in a process of its own, which puts that tree first on
``sys.path``, builds its kernels and times them with its own
``chip_smoke.py``, so each tree calls its kernels as its own path does:

- the first 3 rounds of storm-100k, solo and on 8 lanes (the tree's
  `profile_storm` and `profile_ensemble`, right after the build): the
  device ms a round of every kernel symbol in ``--symbols``, the round's
  device ms and launches, its host wall and the device's idle share;
- the phase-3 rows named by ``--rows``, each held to its plain version,
  from the tree's functions at the paths' shapes:

      kernels:NAME      compare_kernels (the 100k storm's shapes)
      lane_tables:NAME  compare_lane_tables (8 lanes at the storm's)
      lane_scatter:NAME compare_lane_scatter (8 lanes at the storm's)
      lane_sync:NAME    compare_lane_sync (8 lanes at the storm's)
      lane_record:NAME  compare_lane_record (8 lanes at the storm's)
      gaps_wide:NAME    compare_gaps_wide (gapstress-25.6k's V = 128)
      scatter_topo:NAME compare_scatter_topo (K10's topology stream,
                        gapstress-25.6k's)
      scatter_jitter:NAME   compare_scatter_jitter (K10j, the storm's)
      scatter_tiered:NAME   compare_scatter_tiered (K10t, the storm's)
      pull_scatter:NAME compare_pull_scatter (K10p, the storm's)

  A row that only this tree has (a kernel the change adds) is timed in
  this tree's turns and listed as missing in the parent's; a row this
  tree lacks fails the run.

The turns alternate parent, change, change, parent, ... (``--turns`` of
each); the last two lines print the card's name and power limit and
every number side by side.  Without a card it exits at once.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
TAG = "kernel_ab: "

SOURCES = {
    "kernels": lambda cs, dev, g: cs.compare_kernels(dev),
    "lane_tables": lambda cs, dev, g: cs.compare_lane_tables(
        dev, g, cs.ENSEMBLE_LANES, cs.STORM_N, 64, 3),
    "lane_scatter": lambda cs, dev, g: cs.compare_lane_scatter(
        dev, g, cs.ENSEMBLE_LANES, cs.STORM_N, 16, 3),
    "lane_sync": lambda cs, dev, g: cs.compare_lane_sync(
        dev, g, cs.ENSEMBLE_LANES, cs.STORM_N, 16, 3),
    "lane_record": lambda cs, dev, g: cs.compare_lane_record(
        dev, g, cs.ENSEMBLE_LANES, cs.STORM_N, 16),
    "gaps_wide": lambda cs, dev, g: [cs.compare_gaps_wide(dev, g)],
    "scatter_topo": lambda cs, dev, g: [cs.compare_scatter_topo(dev, g)],
    "scatter_jitter": lambda cs, dev, g: [cs.compare_scatter_jitter(dev, g)],
    "scatter_tiered": lambda cs, dev, g: [cs.compare_scatter_tiered(dev, g)],
    "pull_scatter": lambda cs, dev, g: cs.compare_pull_scatter(dev, g),
}


def tree_times(tree: Path, symbols: list[str], rows: list[str]) -> dict:
    """One tree's numbers, in this process: its package and its
    ``chip_smoke.py``."""
    import numpy as np
    import torch

    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  tree / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    from corrosion_tpu_torch import kernels

    package = Path(kernels.__file__).resolve().parents[2]
    if package != tree:
        raise RuntimeError(f"imported the package of {package}, not {tree}")
    kernels.build_all()
    dev = torch.device("cuda")
    in_path = {}
    for prof in (cs.profile_storm(dev), cs.profile_ensemble(dev)):
        ms = prof["port_kernel_ms_per_round"]
        in_path[prof["run"]] = {
            **{sym: ms.get(sym, 0.0) for sym in symbols},
            "device ms": prof["device_ms_per_round"],
            "launches": prof["device_launches_per_round"],
            "wall ms": prof["wall_ms_per_round"],
            "idle share": prof["idle_share"],
        }
    g = np.random.default_rng(22)
    found = {}
    for source in dict.fromkeys(row.split(":", 1)[0] for row in rows):
        for row in SOURCES[source](cs, dev, g):
            found[f"{source}:{row['name']}"] = row
    timed, missing = {}, []
    for name in rows:
        row = found.get(name)
        if row is None:
            missing.append(name)
            continue
        if not row["equal"]:
            raise AssertionError(f"{name}: kernel != plain version")
        timed[name] = {key: row[key] for key in ("ms", "plain_ms",
                                                 "bound_ms")}
    return {"tree": str(tree), "rows": timed, "missing": missing,
            "in_path": in_path}


def side_by_side(runs: list[tuple[str, dict]]) -> dict:
    """Every number of every run, by name, then tree, in turn order."""
    side: dict = {}
    for which, got in runs:
        numbers = {f"{name} {key}": value
                   for name, row in got["rows"].items()
                   for key, value in row.items()}
        numbers.update({f"{run} {name}": value
                        for run, prof in got["in_path"].items()
                        for name, value in prof.items()})
        for name, value in numbers.items():
            side.setdefault(name, {}).setdefault(which, []).append(value)
    return side


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("parent", help="the parent commit's unpacked tree")
    parser.add_argument("--symbols", required=True,
                        help="kernel symbols whose in-path ms to keep")
    parser.add_argument("--rows", required=True,
                        help="phase-3 rows to time, SOURCE:NAME")
    parser.add_argument("--turns", type=int, default=3)
    parser.add_argument("--times", metavar="TREE",
                        help="(internal) time one tree in this process")
    args = parser.parse_args()
    symbols = args.symbols.split(",")
    rows = args.rows.split(",")
    for row in rows:
        if row.split(":", 1)[0] not in SOURCES or ":" not in row:
            parser.error(f"row {row}: not SOURCE:NAME with a SOURCE of "
                         f"{sorted(SOURCES)}")
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.times:
        got = tree_times(Path(args.times).resolve(), symbols, rows)
        print(TAG + json.dumps(got), flush=True)
        return 0
    trees = {"parent": Path(args.parent).resolve(), "change": HERE}
    order = [("parent", "change")[(i + i // 2) % 2]
             for i in range(2 * args.turns)]
    runs = []
    for which in order:
        proc = subprocess.run(
            [sys.executable, __file__, args.parent, "--symbols",
             args.symbols, "--rows", args.rows, "--times",
             str(trees[which])],
            capture_output=True, text=True, timeout=900, check=False)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            raise RuntimeError(f"the {which} tree's run failed")
        line = [x for x in proc.stdout.splitlines() if x.startswith(TAG)][-1]
        got = json.loads(line[len(TAG):])
        print(f"{which}: " + json.dumps(got), flush=True)
        if which == "change" and got["missing"]:
            raise RuntimeError(f"this tree has no rows {got['missing']}")
        runs.append((which, got))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    print(card.strip().splitlines()[0], flush=True)
    print(TAG + json.dumps(side_by_side(runs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
