"""Perf diagnostics for a dry-run cell — the port of
``repro/launch/diagnose.py``: top collectives and top byte-traffic
operations.

    PYTHONPATH=src python -m repro_torch.launch.diagnose --arch X \\
        --shape Y [--multi-pod] [--top 15] [--bytes]

:func:`walk_costs` reads post-optimization HLO text, as the reference's
does (over the ported ``core.hlocost``), with while-loop trip
multipliers.  The port has no HLO, so :func:`main` walks the cell
(``launch.dryrun``) and reports the walk's top operations instead: the
collectives by per-chip bytes, and (``--bytes``) each operation by its
per-chip bytes summed over its calls, with the call count.  Nothing is
written.
"""

import argparse
import re
from typing import Dict, List, Tuple

from ..core import hlocost


def walk_costs(hlo: str):
    comps, entry = hlocost._parse_computations(hlo)
    an = hlocost._Analyzer(comps)
    coll_rows, byte_rows = [], []

    def walk(name, mult):
        comp = comps.get(name)
        if comp is None:
            return
        for ins in comp.instrs:
            if ins.opcode == "while":
                mb = re.search(r"body=%?([\w.\-]+)", ins.line)
                mc = re.search(r"condition=%?([\w.\-]+)", ins.line)
                trips = an._trip_count(mc.group(1)) if mc else 1.0
                if mb:
                    walk(mb.group(1), mult * trips)
            elif ins.opcode in ("call", "conditional"):
                for c in ins.callees:
                    walk(c, mult)
            else:
                c = an._instr_cost(comp, ins, False)
                m = re.search(r'op_name="([^"]*)"', ins.line)
                op_name = m.group(1)[-100:] if m else "?"
                base = ins.opcode.replace("-start", "").replace("-done", "")
                if c.collective_bytes:
                    coll_rows.append((sum(c.collective_bytes.values()) * mult,
                                      mult, base, op_name))
                elif c.bytes > 0:
                    byte_rows.append((c.bytes * mult, mult, ins.opcode,
                                      op_name))
    walk(entry, 1.0)
    coll_rows.sort(reverse=True)
    byte_rows.sort(reverse=True)
    return coll_rows, byte_rows


def walk_rows(collectives, costs, chip
              ) -> Tuple[List[Tuple[float, float, str, str]],
                         List[Tuple[float, float, str, str]]]:
    """The rows :func:`walk_costs` gives, from a walked cell: (per-chip
    bytes, count, opcode, what) for the collectives (events of one
    opcode and what summed), and (per-chip bytes, calls, op, "") for each
    operation, both largest first."""
    coll: Dict[Tuple[str, str], List[float]] = {}
    for op, nb, what in collectives:
        row = coll.setdefault((op, what), [0.0, 0.0])
        row[0] += nb
        row[1] += 1.0
    ops: Dict[str, List[float]] = {}
    for c, (_, nb, _) in zip(costs, chip):
        row = ops.setdefault(c.name, [0.0, 0.0])
        row[0] += nb
        row[1] += 1.0
    coll_rows = sorted(((b, n, op, what) for (op, what), (b, n)
                        in coll.items()), reverse=True)
    byte_rows = sorted(((b, n, op, "") for op, (b, n) in ops.items()
                        if b > 0), reverse=True)
    return coll_rows, byte_rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--bytes", action="store_true")
    ap.add_argument("--exec-json", default=None)
    args = ap.parse_args()

    import json as _json
    from ..configs import exec_default
    from ..sharding import rules
    from .dryrun import build_cell, walk_cell
    from .mesh import make_production_mesh

    ex = exec_default(args.arch, args.shape)
    if args.exec_json:
        base = ex.as_dict()
        base.update(_json.loads(args.exec_json))
        ex = rules.ExecConfig.from_dict(base)

    mesh = make_production_mesh(multi_pod=args.multi_pod)
    fn, cell_args, meta, walker = build_cell(args.arch, args.shape, mesh, ex)
    walk_cell(fn, cell_args, meta, walker, ex)
    coll_rows, byte_rows = walk_rows(walker.events, walker.costs,
                                     walker.chip)

    print(f"== collectives (total {sum(r[0] for r in coll_rows):.3e} B/chip)")
    for b, mult, op, name in coll_rows[:args.top]:
        print(f"  {b:.2e} x{mult:5.0f} {op:18s} {name}")
    if args.bytes:
        print(f"== HBM traffic (total {sum(r[0] for r in byte_rows):.3e} B/chip)")
        for b, mult, op, name in byte_rows[:args.top]:
            print(f"  {b:.2e} x{mult:5.0f} {op:18s} {name}")


if __name__ == "__main__":
    main()
