"""Roofline report: aggregate the dry-run cell JSONs into a table (per
arch x shape: three terms, dominant bottleneck, MODEL_FLOPS / op FLOPs
ratio, and a one-line "what would move the dominant term" for the H100).

The port of ``repro.launch.roofline``; it reads the records of
:mod:`repro_torch.launch.dryrun`.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline
      [--dir results/dryrun_torch] [--mesh pod16x16] [--format md|csv]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List


def load_cells(root: Path, mesh: str, variant: str = "") -> List[dict]:
    d = root / mesh / variant if variant else root / mesh
    cells = []
    for p in sorted(d.glob("*.json")):
        cells.append(json.loads(p.read_text()))
    return cells


_ADVICE = {
    "compute": ("compute-bound: raise tensor-core utilization — wgmma "
                "tiles of 64-row multiples (dims padded to 64/128), bf16 "
                "operands staged by TMA, or fewer GPUs for this size"),
    "memory": ("memory-bound: cut HBM round-trips — keep attention "
               "scores in shared memory (flash kernels, backward too), "
               "fuse norms and casts into neighbouring kernels"),
    "collective": ("collective-bound: fewer/larger transfers — fuse "
                   "gradient buckets, keep the group inside one NVLink "
                   "node, overlap the IB transfers with the backward"),
}


def advice(cell: dict) -> str:
    r = cell.get("roofline", {})
    dom = r.get("dominant", "")
    extra = ""
    frac = r.get("useful_flop_frac")
    if frac is not None and frac < 0.5 and dom == "compute":
        extra = " (useful-FLOP fraction <50%: remat/redundant compute)"
    return _ADVICE.get(dom, "") + extra


def row(cell: dict) -> Dict[str, str]:
    if cell.get("status") == "skipped":
        return {
            "arch": cell["arch"], "shape": cell["shape"],
            "status": "skipped", "compute_s": "", "memory_s": "",
            "collective_s": "", "dominant": "",
            "useful_flop_frac": "", "mfu_bound": "",
            "note": cell.get("reason", "")[:60],
        }
    if cell.get("status") != "ok":
        return {
            "arch": cell["arch"], "shape": cell["shape"],
            "status": "ERROR", "compute_s": "", "memory_s": "",
            "collective_s": "", "dominant": "",
            "useful_flop_frac": "", "mfu_bound": "",
            "note": cell.get("error", "")[:60],
        }
    r = cell["roofline"]
    return {
        "arch": cell["arch"], "shape": cell["shape"], "status": "ok",
        "compute_s": f"{r['compute_s']:.3f}",
        "memory_s": f"{r['memory_s']:.3f}",
        "collective_s": f"{r['collective_s']:.3f}",
        "dominant": r["dominant"],
        "useful_flop_frac": (f"{r['useful_flop_frac']:.2f}"
                             if r.get("useful_flop_frac") else ""),
        "mfu_bound": (f"{r['mfu_bound']*100:.2f}%"
                      if r.get("mfu_bound") else ""),
        "note": advice(cell)[:60],
    }


def render_md(cells: List[dict]) -> str:
    cols = ["arch", "shape", "status", "compute_s", "memory_s",
            "collective_s", "dominant", "useful_flop_frac", "mfu_bound"]
    lines = ["| " + " | ".join(cols) + " |",
             "|" + "|".join(["---"] * len(cols)) + "|"]
    for c in cells:
        r = row(c)
        lines.append("| " + " | ".join(r[k] for k in cols) + " |")
    return "\n".join(lines)


def render_csv(cells: List[dict]) -> str:
    cols = ["arch", "shape", "status", "compute_s", "memory_s",
            "collective_s", "dominant", "useful_flop_frac", "mfu_bound",
            "note"]
    lines = [",".join(cols)]
    for c in cells:
        r = row(c)
        lines.append(",".join(str(r[k]).replace(",", ";") for k in cols))
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--mesh", default="pod16x16")
    ap.add_argument("--variant", default="")
    ap.add_argument("--format", default="md", choices=["md", "csv"])
    args = ap.parse_args(argv)
    cells = load_cells(Path(args.dir), args.mesh, args.variant)
    if args.format == "md":
        print(render_md(cells))
    else:
        print(render_csv(cells))


if __name__ == "__main__":
    main()
