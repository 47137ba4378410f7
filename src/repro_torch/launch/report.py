"""The dry run's tables: the port's counterpart of the reference's
``scripts/make_report.py``, over the port's records (``launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.report \\
        [--dir experiments/dryrun_torch] [--md FILE] [--goldens DIR]

Prints the §Dry-run table (one row per record: status, trace seconds,
dot TFLOPs of the whole step, argument and temporary bytes per device,
and each collective kind's bytes per device as the record holds them)
and the §Roofline table (the 16x16 records through ``roofline.analyze``:
compute, memory and collective seconds on H100 datasheet rates). With
``--md`` it also writes them between the file's ``<!-- DRYRUN_TABLE -->``
and ``<!-- ROOFLINE_TABLE -->`` markers, as the reference does. With
``--goldens`` (the reference's records, ``experiments/dryrun_ci``) it
also prints, for each golden with a port record of the same file name in
``--dir``, each collective kind's count and bytes per device beside the
golden's ``cost_corrected`` ones: a report, not a bound, since the two
partitioners need not agree.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.config import INPUT_SHAPES
from repro_torch.configs import get_config
from repro_torch.launch import roofline
from repro_torch.launch.spmd import COLLECTIVES

NOTES = {"compute": "scale batch/seq or quantize to move",
         "memory": "weight/KV streaming bound; fuse or shrink dtype",
         "collective": "resharding traffic; revisit partition specs"}


def fmt_bytes(b):
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def collective_cell(coll) -> str:
    """A record's ``collectives`` as the table shows them: each kind with
    a count, its bytes per device; "not placed" for None."""
    if coll is None:
        return "not placed"
    return ", ".join(
        f"{k.replace('collective-', 'c-')}:{fmt_bytes(v['bytes'])}"
        for k, v in coll.items() if v["count"]) or "none"


def _key(r):
    return (r["arch"], r["shape"], r.get("mesh", ""))


def dryrun_table(recs) -> str:
    lines = ["| arch | shape | mesh | status | trace | dot TFLOPs | "
             "args/dev | temps/dev | collective traffic (/dev) |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=_key):
        head = f"| {r['arch']} | {r['shape']} | {r.get('mesh', '-')}"
        if r["status"] == "ok":
            n = r["n_devices"]
            coll = collective_cell(r["collectives"])
            lines.append(
                f"{head} | ok | {r['t_trace_s']}s | "
                f"{(r['cost']['flops'] or 0) / 1e12:.1f} | "
                f"{fmt_bytes(r['argument_bytes_per_device'])} | "
                f"{fmt_bytes((r['memory']['temp_bytes'] or 0) / n)} | "
                f"{coll} |")
        elif r["status"] == "skipped":
            lines.append(f"{head} | skipped | — | — | — | — | "
                         f"{r['reason'][:60]} |")
        else:
            lines.append(f"{head} | ERROR | — | — | — | — | "
                         f"{r.get('error', '')[:80]} |")
    return "\n".join(lines)


def roofline_table(recs) -> str:
    lines = ["| arch | shape | compute s | memory s | collective s | "
             "dominant | MODEL_FLOPS/traced | note |",
             "|---|---|---|---|---|---|---|---|"]
    single = [r for r in recs if r["status"] == "ok"
              and r["mesh"] == "16x16"]
    for r in sorted(single, key=_key):
        shape = INPUT_SHAPES[r["shape"]]
        rf = roofline.analyze(r, roofline.model_flops_for(
            get_config(r["arch"]), shape, r["kind"]))
        coll = "-" if rf.collective_s is None else f"{rf.collective_s:.2e}"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {rf.compute_s:.2e} | "
            f"{rf.memory_s:.2e} | {coll} | **{rf.dominant}** | "
            f"{rf.useful_ratio:.2f} | {NOTES[rf.dominant]} |")
    return "\n".join(lines)


def goldens_table(golden_dir, port_dir) -> str:
    """The port's collectives beside the reference's goldens: a row per
    collective kind that either counts, for each record of ``golden_dir``
    with a port record of the same file name in ``port_dir`` (one
    device's count and bytes; the golden's from ``cost_corrected``)."""
    lines = ["| record | kind | port count | port bytes | golden count | "
             "golden bytes |", "|---|---|---|---|---|---|"]
    for path in sorted(Path(golden_dir).glob("*.json")):
        mine = Path(port_dir) / path.name
        if not mine.exists():
            continue
        gold, port = (json.loads(f.read_text()) for f in (path, mine))
        if gold["status"] != "ok" or port["status"] != "ok" \
                or port["collectives"] is None:
            lines.append(f"| {path.stem} | - | {port['status']} | - | "
                         f"{gold['status']} | - |")
            continue
        cc = gold["cost_corrected"]
        counts = cc.get("collective_counts", {})
        nbytes = cc.get("collective_bytes", {})
        for kind in COLLECTIVES:
            p = port["collectives"][kind]
            if p["count"] or counts.get(kind):
                lines.append(
                    f"| {path.stem} | {kind} | {p['count']} | "
                    f"{p['bytes']:.4e} | {int(counts.get(kind, 0))} | "
                    f"{nbytes.get(kind, 0):.4e} |")
    return "\n".join(lines)


def _replace(text, marker, content):
    begin, end = f"<!-- {marker} -->", f"<!-- /{marker} -->"
    block = f"{begin}\n{content}\n{end}"
    if begin in text and end in text:
        return text.split(begin)[0] + block + text.split(end)[1]
    return text.replace(begin, block)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--md", default=None,
                    help="also write the tables between this file's "
                         "DRYRUN_TABLE / ROOFLINE_TABLE markers")
    ap.add_argument("--goldens", default=None,
                    help="also print the collectives of each record beside "
                         "this directory's reference record of its name")
    args = ap.parse_args(argv)
    recs = roofline.load_records(args.dir)
    dt, rt = dryrun_table(recs), roofline_table(recs)
    print("## Dry-run\n\n" + dt + "\n\n## Roofline\n\n" + rt)
    if args.goldens:
        print("\n## Collectives beside the reference's goldens\n\n"
              + goldens_table(args.goldens, args.dir))
    if args.md:
        with open(args.md) as f:
            text = f.read()
        text = _replace(_replace(text, "DRYRUN_TABLE", dt),
                        "ROOFLINE_TABLE", rt)
        with open(args.md, "w") as f:
            f.write(text)
    count = {s: sum(r["status"] == s for r in recs)
             for s in ("ok", "skipped", "error")}
    print(f"report: {count['ok']} ok, {count['skipped']} skipped, "
          f"{count['error']} error")


if __name__ == "__main__":
    main()
