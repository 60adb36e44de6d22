"""Time kernels B1, B2 and B3 under the two L2 evictions, alternately in one
process on one card: "copy", a device copy of ``chip_smoke.L2_FLUSH_BYTES``
alone (which leaves L2 full of dirty lines of its destination), and
"clean", ``chip_smoke.flush_l2`` (that copy, then a read-only pass over
another buffer of the same size, so the copy's write-back falls before the
timed call).

    python3 scripts/time_l2_flush.py [--rounds R] [--out FILE.jsonl]

Inputs: B1 on ``chip_smoke.rank_inputs`` at N=4096 and N=32768 (W=128,
clustered); B2 on ``chip_smoke.b2_case_inputs`` at the fused q7 flush's
shape (nb=32768, W=128, random); B3 on ``chip_smoke.hash_case``'s "q5" and
"load_0.7" find-or-insert and "find_hits_misses" find, each call on its
own table copy; B3's results are first checked against its plain
version. Each input is timed with ``chip_smoke.time_cuda`` in the
order copy, clean, clean, copy, ``R`` times over (default 2), each reading
with its method ("profiler" or "events") and each kernel's share by name.
One JSON line per input goes to stdout and, with ``--out``, to that file.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def flush_copy_only() -> None:
    """The eviction ``chip_smoke.time_cuda`` used before the read-only
    pass: the copy alone."""
    src, dst, _ = cs.l2_flush_buffers()
    dst.copy_(src)


FLUSHES = {"copy": flush_copy_only, "clean": cs.flush_l2}


def cases(device):
    """(name, bound ms, fn, fresh) per input."""
    from risingwave_tpu_torch.ops import rank_totals as rt
    from risingwave_tpu_torch.ops.hash_table import (
        ht_lookup, ht_lookup_or_insert,
    )
    from risingwave_tpu_torch.ops.interval_join import interval_match
    out = []
    for k, n in enumerate((4096, 32768)):
        ident, matches = cs.rank_inputs(n, 128, "clustered", k, device)
        out.append((f"B1 N={n} W=128 clustered",
                    cs.rank_totals_bound(ident, matches)[0],
                    lambda a=ident, b=matches: rt.rank_totals(a, b), None))
    args = cs.b2_case_inputs(cs.Q7_BUCKETS, cs.Q7_LANES, "random", 0, device)
    out.append((f"B2 nb={cs.Q7_BUCKETS} W={cs.Q7_LANES} random",
                cs.interval_match_bound(cs.Q7_BUCKETS, cs.Q7_LANES)[0],
                lambda: interval_match(*args), None))
    for name, op in (("q5", "insert"), ("load_0.7", "insert"),
                     ("find_hits_misses", "find")):
        table, cols, valid = cs.hash_case(name, device)
        err, (s0, f0, _) = cs.compare_hash_probe(table, cols, valid, op)
        if err:
            raise AssertionError(f"hash_probe {op} differs from plain on "
                                 f"{name}: {err} differences")
        if op == "insert":
            def fn(t, c=cols, v=valid):
                ht_lookup_or_insert(t, c, v)
        else:
            def fn(t, c=cols, v=valid):
                ht_lookup(t, c, v)
        bound = cs.hash_probe_bound(table, cols, valid, s0, f0, op)[0]
        out.append((f"B3 {op} {name}", bound, fn,
                    lambda t=table: (t.clone(),)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", type=Path, help="also write the lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_l2_flush: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line())
    lines = []
    for name, bound, fn, fresh in cases("cuda"):
        line = {"input": name, "bound_ms": bound,
                **{f: [] for f in FLUSHES}}
        for _ in range(args.rounds):
            for f in ("copy", "clean", "clean", "copy"):
                shares = {}
                ms, _, timing = cs.time_cuda(
                    fn, iters=20, by_kernel=shares, fresh=fresh,
                    flush=FLUSHES[f])
                line[f].append({"ms": ms, "timing": timing,
                                "by_kernel": shares})
        for f in FLUSHES:
            line[f"{f}_mean_ms"] = sum(r["ms"] for r in line[f]) \
                / len(line[f])
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
