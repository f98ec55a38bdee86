"""Roofline terms of the dry run's cell records, with the card's constants.

Port of ``repro.launch.roofline`` for one NVIDIA card.  Per (arch x shape
x mesh) cell, from its record (:mod:`repro_torch.launch.dryrun`):

    compute term    = flops_weighted / PEAK_FLOPS                [s]
    memory term     = bytes_weighted / HBM_BW                    [s]
    collective term = 2 x collective_bytes / HBM_BW              [s]
    latency term    = collective_rounds x ALPHA                  [s]

flops_weighted, bytes_weighted and collective_bytes are per device.  The
constants are the card's (:data:`CARDS`, keyed by the name ``nvidia-smi``
gives): the datasheet's dense bf16 peak and HBM bandwidth, the device
memory from ``torch.cuda.get_device_properties(0).total_memory`` (the
table's when no card is there), and ``ALPHA``, the wall time of one round
of a warm p = 2 broadcast plan that ``chip_smoke.py``'s ``dryrun`` phase
measures.  The collective term is the bytes the port's exchange moves on
that card: a round rolls each message through HBM, one read and one
write.  Links between cards are not modelled: one card has none, and
:class:`~repro_torch.core.comm.DistGroup` refuses nccl.  A cell that runs
no exchange (the ``grad_sync="auto"`` step, where the reference counts
GSPMD's collectives) has no collective or latency term: "--" in the
table.  The bottleneck is the largest term; the roofline fraction is
compute term / that term.  MODEL_FLOPS = passes x N_active x tokens /
devices; its ratio to flops_weighted shows how much counted compute is
useful (remat, capacity padding, chunk padding).

    python -m repro_torch.launch.roofline [--mesh single] [--md]
    python -m repro_torch.launch.roofline --md --gpu "NVIDIA H100 80GB HBM3"

With no card it raises unless ``--gpu`` names a card of :data:`CARDS`.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional

from .dryrun import RESULTS_DIR

#: Per card: dense bf16 peak FLOP/s and HBM bytes/s (datasheet), device
#: memory in bytes (``total_memory`` as torch reports it on that card) and
#: ALPHA in seconds.  ALPHA is no constant of the card: it is one run's
#: reading of a host-bound loop, the median wall time of one round of a
#: warm p = 2 broadcast plan of 256 rounds, 28.85 us in one run of
#: ``chip_smoke.py``'s ``dryrun`` phase on an NVIDIA H100 80GB HBM3 at a
#: 700.00 W power limit; it moves with the host (51.70 us in another).
#: The smoke passes its own run's reading to :func:`terms`.
CARDS = {
    "NVIDIA H100 80GB HBM3": {"peak_flops": 989e12, "hbm_bw": 3.35e12,
                              "hbm_bytes": 85_017_493_504, "alpha": 28.85e-6},
}


def card_constants(gpu: Optional[str] = None) -> Dict:
    """The constants of ``gpu`` (a :data:`CARDS` name), else of the card
    this process sees, with its own device memory; raises with neither."""
    if gpu is None:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card: name one with --gpu "
                               f"(one of {sorted(CARDS)})")
        gpu = torch.cuda.get_device_name(0)
        if gpu not in CARDS:
            raise RuntimeError(f"no constants for {gpu!r} (known: {sorted(CARDS)})")
        return {"name": gpu, **CARDS[gpu],
                "hbm_bytes": torch.cuda.get_device_properties(0).total_memory}
    if gpu not in CARDS:
        raise ValueError(f"unknown card {gpu!r} (known: {sorted(CARDS)})")
    return {"name": gpu, **CARDS[gpu]}


def load_cells(mesh: str = "single", tag: str = "",
               results_dir: Optional[str] = None) -> List[Dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(results_dir or RESULTS_DIR, "*.json"))):
        with open(path) as f:
            d = json.load(f)
        if d.get("mesh") != mesh or d.get("tag", "") != (tag or ""):
            continue
        out.append(d)
    return out


def terms(d: Dict, card: Dict) -> Dict:
    """The roofline terms of one record on ``card`` (:func:`card_constants`);
    ``collective_s`` and ``latency_s`` are None for a cell with no
    exchange."""
    if "skipped" in d:
        return {"arch": d["arch"], "shape": d["shape"], "skipped": d["skipped"]}
    ct = d["flops_weighted"] / card["peak_flops"]
    mt = d["bytes_weighted"] / card["hbm_bw"]
    xt = 2 * d["collective_bytes"] / card["hbm_bw"] if d["collective_bytes"] else None
    lt = d["collective_rounds"] * card["alpha"] if d["collective_rounds"] else None
    named = [(k, v) for k, v in (("compute", ct), ("memory", mt), ("collective", xt),
                                 ("latency", lt)) if v is not None]
    dom = max(named, key=lambda kv: kv[1])
    return {
        "arch": d["arch"],
        "shape": d["shape"],
        "compute_s": ct,
        "memory_s": mt,
        "collective_s": xt,
        "latency_s": lt,
        "bottleneck": dom[0],
        "roofline_frac": ct / dom[1] if dom[1] else 0.0,
        "model_flops": d["model_flops_per_device"],
        "useful_ratio": (d["model_flops_per_device"] / d["flops_weighted"]
                         if d["flops_weighted"] else 0.0),
        "fits_hbm": d["memory"]["peak_estimate_bytes"] <= card["hbm_bytes"],
        "peak_gb": d["memory"]["peak_estimate_bytes"] / 1e9,
        "microbatches": d.get("microbatches"),
        "tag": d.get("tag", ""),
    }


def fmt_s(x: Optional[float]) -> str:
    if x is None:
        return "--"
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def markdown_table(rows: List[Dict], card: Dict) -> str:
    gb = card["hbm_bytes"] / 1e9
    hdr = ("| arch | shape | compute | memory | collective | latency | "
           f"bottleneck | roofline frac | useful FLOPs | fits {gb:.0f}GB |")
    lines = [hdr, "|" + "---|" * 10]
    for r in rows:
        if "skipped" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | -- | -- | -- | -- | "
                         "skipped (full attention) | -- | -- | -- |")
            continue
        fits = "yes" if r["fits_hbm"] else f"NO ({r['peak_gb']:.0f}GB)"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(r['compute_s'])} | "
            f"{fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} | "
            f"{fmt_s(r['latency_s'])} | {r['bottleneck']} | "
            f"{r['roofline_frac']*100:.0f}% | {r['useful_ratio']*100:.0f}% | {fits} |")
    if all(r.get("collective_s") is None for r in rows):
        lines.append("")
        lines.append("No collective was modelled: the cells' steps ran no exchange "
                     "(one card; GSPMD's collectives have no counterpart).")
    lines.append("")
    lines.append(f"{card['name']}: {card['peak_flops']/1e12:.0f} TFLOP/s bf16, "
                 f"{card['hbm_bw']/1e12:.2f} TB/s, {card['hbm_bytes']:,} bytes, "
                 f"alpha {card['alpha']*1e6:.1f} us a round.")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--tag", default="")
    ap.add_argument("--md", action="store_true")
    ap.add_argument("--gpu", default=None,
                    help="a card of CARDS to take the constants of (default: this card)")
    ap.add_argument("--dir", default=None, help=f"the records (default: {RESULTS_DIR})")
    args = ap.parse_args(argv)
    card = card_constants(args.gpu)
    rows = [terms(d, card) for d in load_cells(args.mesh, args.tag, args.dir)]
    if args.md:
        print(markdown_table(rows, card))
    else:
        for r in rows:
            print(json.dumps(r))


if __name__ == "__main__":
    main()
