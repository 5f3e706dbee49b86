"""Dry-run and roofline tables from artifacts, and the observability
section from a session report: the port of `repro.analysis.report`.

    PYTHONPATH=src python -m repro_torch.analysis.report \
        [--artifacts artifacts] [--obs report.json] [--section all|obs]

The tables are the reference's, row for row, over the port's artifacts
(`launch.dryrun`): every figure is one rank's.  The roofline takes the
H100 SXM's constants (`analysis.roofline`), and its last column names the
card's levers (shared memory, the tensor cores, K4) where the reference's
names the TPU's.  `placement_table`, the port's own, sets one rank's
bytes under the reference's shardings beside those under the port's
placement (the model ranks' blocks cut over 'data', caches and
activations), its peak and whether it fits one 80 GB card, in both
layouts, with the roofline's terms; `fsdp_pod_table` the train cells of
the multi-pod layout with the weights cut over 'data' (hierarchical) and
over ('pod', 'data') (`--fsdp-pod`), and the bytes each puts across pods.
`observability_section` renders the port's `FMMSession.report()`.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.analysis.roofline import H100_SXM, roofline_from_artifact

__all__ = ["load", "fmt_bytes", "dryrun_table", "roofline_table",
           "placement_table", "fsdp_pod_table", "observability_section",
           "ADVICE", "main"]

# what would move each family's dominant term on the card
ADVICE = {
    ("moe", "collective"): "hierarchical/two-stage a2a; larger grain",
    ("moe", "memory"): "sequence-parallel activations; lower capacity factor",
    ("moe", "compute"): "fuse the expert FFN into one tensor-core kernel",
    ("dense", "memory"): "K4 keeps tiles in shared memory; shard dense "
                         "weights and activations over the model axis",
    ("dense", "collective"): "chunked ring all-gather overlapped with matmul",
    ("dense", "compute"): "already compute-bound — tune tensor-core (wgmma) "
                          "tiling",
}


def load(art_dir):
    recs = []
    for f in sorted(os.listdir(art_dir)):
        if f.endswith(".json"):
            with open(os.path.join(art_dir, f)) as fh:
                d = json.load(fh)
            d["_file"] = f
            recs.append(d)
    return recs


def fmt_bytes(b):
    return f"{b/1e9:.2f}"


def dryrun_table(recs, pod):
    lines = [
        "| arch | shape | status | compile s | args GB/dev | temp GB/dev | "
        "coll GB/dev | n_micro |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if f"__{pod}.json" != r["_file"].split("__", 2)[-1][len(r['shape']) + 2:] \
                and not r["_file"].endswith(f"__{pod}.json"):
            continue
        if "skipped" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | SKIP ({r['skipped'][:40]}…) "
                         "| – | – | – | – | – |")
            continue
        if "error" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | ERROR | – | – | – | – | – |")
            continue
        m = r["memory"]
        w = r.get("walked", {})
        coll = w.get("total_collective_bytes", r["collectives"]["total_bytes"])
        lines.append(
            f"| {r['arch']} | {r['shape']} | ok | {r['compile_s']} | "
            f"{fmt_bytes(m.get('argument_size_in_bytes', 0))} | "
            f"{fmt_bytes(m.get('temp_size_in_bytes', 0))} | "
            f"{fmt_bytes(coll)} | {r.get('n_micro', '–')} |")
    return "\n".join(lines)


def roofline_table(recs, chip=H100_SXM):
    lines = [
        "| arch | shape | compute ms | memory ms | collective ms | dominant | "
        "roofline frac | useful ratio | what would move the dominant term |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    rows = []
    for r in recs:
        if not r["_file"].endswith("__1pod.json"):
            continue
        if "skipped" in r or "error" in r:
            continue
        w = r.get("walked", {})
        rr = roofline_from_artifact(r, w if "dot_flops" in w else None,
                                    chip=chip)
        rows.append((r, rr))
    rows.sort(key=lambda t: (t[0]["arch"], t[0]["shape"]))
    from repro_torch.configs import get_config
    for r, rr in rows:
        fam = get_config(r["arch"]).family
        fam_key = "moe" if fam == "moe" else "dense"
        hint = ADVICE.get((fam_key, rr["dominant"]),
                          "overlap/shard the dominant mover")
        lines.append(
            f"| {rr['arch']} | {rr['shape']} | {rr['compute_s']*1e3:.2f} | "
            f"{rr['memory_s']*1e3:.2f} | {rr['collective_s']*1e3:.2f} | "
            f"{rr['dominant']} | {rr['roofline_fraction']:.3f} | "
            f"{min(rr['useful_ratio'], 99.0):.2f} | {hint} |")
    return "\n".join(lines)


def placement_table(recs):
    """Per (arch, shape), one rank in the (16, 16) / (2, 16, 16) layouts:
    argument GB under the reference's shardings, GB the port holds, the
    port's peak GB, whether the peak fits 80 GB, and the (16, 16) rank's
    roofline terms in ms."""
    lines = [
        "| arch | shape | args GB, ref. shardings | held GB, port | "
        "peak GB, port | fits 80 GB | compute / memory / collective ms |",
        "|---|---|---|---|---|---|---|",
    ]
    cells = {}
    for r in recs:
        if "skipped" in r or "error" in r or "port" not in r \
                or r["port"].get("fsdp_pod"):
            continue
        cells.setdefault((r["arch"], r["shape"]), {})[
            "2pod" if r["multi_pod"] else "1pod"] = r
    for (arch, shape), by in sorted(cells.items()):
        def both(f):
            return " · ".join(f(by[p]) if p in by else "–"
                              for p in ("1pod", "2pod"))
        one = by.get("1pod")
        terms = "–"
        if one is not None:
            rr = roofline_from_artifact(one, one["walked"])
            terms = (f"{rr['compute_s']*1e3:.1f} / {rr['memory_s']*1e3:.1f}"
                     f" / {rr['collective_s']*1e3:.1f}")
        lines.append(
            f"| {arch} | {shape} | "
            f"{both(lambda r: fmt_bytes(r['memory']['argument_size_in_bytes']))}"
            f" | {both(lambda r: fmt_bytes(r['port']['held_bytes']))} | "
            f"{both(lambda r: fmt_bytes(r['port']['peak_bytes']))} | "
            f"{both(lambda r: 'yes' if r['port']['fits_80gb'] else 'no')} | "
            f"{terms} |")
    return "\n".join(lines)


def fsdp_pod_table(recs):
    """Per train cell of the (2, 16, 16) layout: the GB one rank holds,
    its peak, and its collective bytes inter- / intra-pod, with the
    weights cut over 'data' (hierarchical reduction) and over ('pod',
    'data') (`--fsdp-pod`)."""
    lines = [
        "| arch | held GB (data · pod x data) | peak GB | inter-pod GB | "
        "intra-pod GB |",
        "|---|---|---|---|---|",
    ]
    cells = {}
    for r in recs:
        if "port" not in r or not r.get("multi_pod") or \
                r["shape"] != "train_4k":
            continue
        cells.setdefault(r["arch"], {})[
            "pod" if r["port"].get("fsdp_pod") else "data"] = r
    for arch, by in sorted(cells.items()):
        def both(f):
            return " · ".join(f(by[k]) if k in by else "–"
                              for k in ("data", "pod"))
        lines.append(
            f"| {arch} | {both(lambda r: fmt_bytes(r['port']['held_bytes']))}"
            f" | {both(lambda r: fmt_bytes(r['port']['peak_bytes']))} | "
            f"{both(lambda r: fmt_bytes(r['walked']['inter_pod_bytes']))} | "
            f"{both(lambda r: fmt_bytes(r['walked']['intra_pod_bytes']))} |")
    return "\n".join(lines)


def observability_section(rep: dict) -> str:
    """§Observability markdown from a `FMMSession.report()` dict (or a JSON
    file of one, e.g. the one `analysis/check_counters.py --out` writes)."""
    lines = ["## §Observability — session flight recorder\n"]
    o = rep.get("obs", {})
    lines.append(f"tracing: {'on' if o.get('enabled') else 'off'}"
                 f" · fences: {'on' if o.get('fences') else 'off'}"
                 f" · events: {o.get('events', 0)}"
                 f" · dropped: {o.get('dropped', 0)}\n")
    timings = rep.get("timings", {})
    if timings:
        lines.append("| span | count | total ms | mean ms | max ms |")
        lines.append("|---|---|---|---|---|")
        for name in sorted(timings, key=lambda k: -timings[k]["total_s"]):
            t = timings[name]
            lines.append(f"| {name} | {t['count']} | {t['total_s']*1e3:.3f} "
                         f"| {t['mean_s']*1e3:.3f} | {t['max_s']*1e3:.3f} |")
        lines.append("")
    ex = rep.get("exchange", {})
    if ex.get("enabled") and ex.get("protocols"):
        lines.append("| protocol | rounds | moved bytes | loggp ms "
                     "| measured ms | model drift |")
        lines.append("|---|---|---|---|---|---|")
        for name, st in ex["protocols"].items():
            meas = st.get("measured_s")
            drift = st.get("model_drift")
            loggp = st.get("loggp_s", st.get("loggp_time", 0.0))
            meas_c = f"{meas*1e3:.3f}" if meas is not None else "–"
            drift_c = f"{drift:.2f}" if drift is not None else "–"
            lines.append(f"| {name} | {st.get('n_rounds', '–')} "
                         f"| {st.get('moved_bytes', '–')} | {loggp*1e3:.3f} "
                         f"| {meas_c} | {drift_c} |")
        lines.append("")
    counters = rep.get("metrics", {}).get("counters", {})
    if counters:
        lines.append("counters: "
                     + " · ".join(f"{k}={int(v)}"
                                  for k, v in sorted(counters.items())))
        lines.append("")
    ec = rep.get("exe_cache", {})
    if ec:
        lines.append(f"exe_cache: hits={ec.get('hits')} "
                     f"misses={ec.get('misses')} "
                     f"evictions={ec.get('evictions')} "
                     f"size={ec.get('size')}")
    la = rep.get("launches", {})
    if la and la.get("enabled", True):
        for kind, d in la.items():
            if not isinstance(d, dict):
                continue
            lines.append(f"launches[{kind}]: calls={d['calls']} "
                         f"entry_computations={d['entry_computations']}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifacts", default="artifacts")
    ap.add_argument("--section", default="all")
    ap.add_argument("--obs", default=None,
                    help="path to a FMMSession.report() JSON; renders the "
                         "§Observability section from it")
    args = ap.parse_args(argv)
    if args.obs:
        with open(args.obs) as fh:
            print(observability_section(json.load(fh)))
        if args.section == "obs":
            return
    recs = load(args.artifacts)
    print("## §Dry-run — single pod (16x16 = 256 ranks)\n")
    print(dryrun_table(recs, "1pod"))
    print("\n## §Dry-run — multi-pod (2x16x16 = 512 ranks)\n")
    print(dryrun_table(recs, "2pod"))
    print(f"\n## §Roofline — single pod, per (arch x shape), per rank on "
          f"{H100_SXM.name}\n")
    print(roofline_table(recs))
    print("\n## §Dry-run — one rank under the port's placement (1pod · "
          "2pod)\n")
    print(placement_table(recs))
    print("\n## §Dry-run — the train cells' FSDP cut over 'data' · over "
          "('pod', 'data'), one rank of (2, 16, 16)\n")
    print(fsdp_pod_table(recs))


if __name__ == "__main__":
    main()
