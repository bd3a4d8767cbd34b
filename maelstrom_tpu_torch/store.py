"""The store directory: persistent test artifacts.

A copy of `maelstrom_tpu/store.py`. The port writes history.jsonl,
history.txt, results.json, test.json, run.log and net-journal/; the
plots and the Lamport diagram are not ported.

Mirrors the reference's jepsen store layout (`doc/results.md:14-52`):

    store/<test-name>/<timestamp>/
        history.jsonl       the operation history
        results.json        checker output (validity)
        test.json           test parameters
        net-journal/        journal events + batched chunks
        node-logs/          per-node stderr
        messages.svg        Lamport diagram
        timeline.html       per-process op timeline
        latency-raw.svg, latency-quantiles.svg, rate.svg

`store/latest` and `store/<name>/latest` symlinks point at the newest run;
"""

from __future__ import annotations

import json
import os
from datetime import datetime


def make_test_dir(root: str, test_name: str) -> str:
    ts = datetime.now().strftime("%Y%m%dT%H%M%S.%f")[:-3]
    d = os.path.join(root, test_name, ts)
    os.makedirs(d, exist_ok=True)
    # store/current points at the run in progress; the `latest` links only
    # move when a run completes (mark_complete), mirroring the reference's
    # current/latest distinction (doc/results.md:4-5)
    _relink(os.path.join(root, "current"), os.path.join(test_name, ts))
    return d


def mark_complete(d: str):
    """Repoints the `latest` symlinks at a finished run. `d` is the dir
    make_test_dir returned (root/<test-name>/<timestamp>)."""
    d = os.path.normpath(d)
    test_dir, ts = os.path.split(d)
    root, test_name = os.path.split(test_dir)
    _relink(os.path.join(test_dir, "latest"), ts)
    _relink(os.path.join(root, "latest"), os.path.join(test_name, ts))


def _relink(link: str, target: str):
    try:
        if os.path.islink(link):
            os.unlink(link)
        os.symlink(target, link)
    except OSError:
        pass


def write_history(d: str, history):
    with open(os.path.join(d, "history.jsonl"), "w") as f:
        f.write(history.to_jsonl() + "\n")
    # condensed human-readable view (reference history.txt,
    # doc/results.md:23-25): process, type, f, value, error
    with open(os.path.join(d, "history.txt"), "w") as f:
        for o in history:
            err = "" if o.error is None else f"\t{o.error}"
            f.write(f"{o.process}\t{o.type}\t{o.f}\t{o.value}{err}\n")


def write_results(d: str, results: dict):
    with open(os.path.join(d, "results.json"), "w") as f:
        json.dump(results, f, indent=2, default=str)


def write_test(d: str, test: dict):
    clean = {k: v for k, v in test.items()
             if isinstance(v, (str, int, float, bool, list, dict,
                               type(None)))}
    with open(os.path.join(d, "test.json"), "w") as f:
        json.dump(clean, f, indent=2, default=str)
