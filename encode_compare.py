#!/usr/bin/env python3
"""The host string encode of one 1,048,576-row batch, for this tree and
others, in turns.

    python3 encode_compare.py [NAME=DIR ...]

Times the string encode of ``ColumnarBatch.from_host`` (its ``encode_s``:
the host work that turns a string column into dictionary codes or a byte
rectangle, before any copy) over chip_smoke.py's phase-4 columns,
1,048,576 rows each:

  l_returnflag       -- a ``U1`` array of 3 values: the dictionary route;
  l_comment          -- an ``S64`` array of near-unique 10-43 byte texts:
                        the 64-byte rectangle route;
  l_comment_objects  -- the same texts as Python ``str`` objects (an Arrow
                        or pandas column arrives so).

This tree runs as "this"; each DIR is another checkout of the repository
(the parent commit's ``git archive``, say). Each tree runs in a process
of its own with that tree first on ``sys.path``, over the same data (made
by this tree's chip_smoke.py from its seed), in turns (this, others,
others reversed, this, ...), TURNS turns a tree, CALLS calls a column a
turn after one untimed call; each tree's median and quartiles over all
its calls. Host times vary between processes on a shared host, so only
trees timed in one run are compared. Prints the host's CPU and, where
``nvidia-smi`` answers, the card beside it, then one JSON line. Runs on
any machine with the port's dependencies; the numbers of record come from
the card's machine.
"""
from __future__ import annotations

import json
import os
import platform
import subprocess
import sys

import numpy as np

#: turns a tree and timed calls a column a turn
TURNS = 5
CALLS = 7

_CHILD = r"""
import importlib.util, json, sys
import numpy as np
tree, here = sys.argv[1], sys.argv[2]
sys.path.insert(0, tree)
spec = importlib.util.spec_from_file_location("cs_data",
                                              here + "/chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from spark_rapids_tpu_torch.columnar import ColumnarBatch, HostTable
n = 1 << 20
comment = cs.gen_comment(n)
cols = {"l_returnflag": cs.gen_lineitem(n)["l_returnflag"],
        "l_comment": comment,
        "l_comment_objects": np.array([c.decode() for c in comment],
                                      dtype=object)}
out = {}
for name, v in cols.items():
    host = HostTable.from_dict({name: v})
    ColumnarBatch.from_host(host, "cpu", 64)
    runs = []
    for _ in range(int(sys.argv[3])):
        tm = {}
        ColumnarBatch.from_host(host, "cpu", 64, timings=tm)
        runs.append(tm["encode_s"] * 1e3)
    out[name] = runs
print(json.dumps(out))
"""


def _run(tree: str, here: str) -> dict:
    env = dict(os.environ, PYTHONPATH=tree)
    p = subprocess.run([sys.executable, "-c", _CHILD, tree, here,
                        str(CALLS)],
                       capture_output=True, text=True, env=env, timeout=900)
    if p.returncode != 0:
        raise SystemExit(f"{tree}: the encode run failed:\n{p.stderr}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    here = os.path.dirname(os.path.abspath(__file__))
    trees = [("this", here)]
    for a in args:
        name, _, d = a.partition("=")
        if not d or not os.path.isdir(d):
            print(f"expected NAME=DIR, got {a!r}", file=sys.stderr)
            return 2
        trees.append((name, os.path.abspath(d)))
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = "no card"
    print(f"host {platform.processor() or platform.machine()}, "
          f"{os.cpu_count()} CPUs; card {smi or 'no card'}", flush=True)
    turns = {name: [] for name, _ in trees}
    order = []
    for t in range(TURNS):
        order += trees if t % 2 == 0 else trees[::-1]
    for name, d in order:
        r = _run(d, here)
        turns[name].append(r)
        print(f"{name}: " + ", ".join(f"{k} {np.median(v):.1f} ms" for k, v
                                      in r.items()), flush=True)
    cols = list(turns["this"][0])
    summary = {}
    for name, runs in turns.items():
        summary[name] = {}
        for c in cols:
            ms = np.concatenate([r[c] for r in runs])
            q1, med, q3 = np.percentile(ms, [25, 50, 75])
            summary[name][c] = {"median": float(med), "q1": float(q1),
                                "q3": float(q3), "calls": int(len(ms))}
    for name in summary:
        if name != "this":
            ratio = {c: summary["this"][c]["median"]
                     / summary[name][c]["median"] - 1 for c in cols}
            print(f"this against {name}: " + ", ".join(
                f"{c} {r:+.1%}" for c, r in ratio.items()), flush=True)
    print(json.dumps({"encode_ms": summary, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
