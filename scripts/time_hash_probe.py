"""Time kernel B3 (the hash probe) against earlier versions of its source,
and its two find-or-insert paths against each other, side by side in one
process on one card.

    python3 scripts/time_hash_probe.py [--old OLD.cu ...] [--fused]
                                       [--out FILE.jsonl]

"new" is the port as it stands: ``ops/hash_table.py``'s
``ht_lookup_or_insert`` (path "auto") and ``ht_lookup``. Each ``--old`` is
an earlier ``hash_probe.cu`` ("old", then "old2", ...), built beside it:
one with this launcher (it exports ``hash_probe_workspace_words``) runs
through the same wrapper, with a workspace of its own; the first version
(all rows in the reference's rounds), whose workspace is four counter
words and then the claim words, through a launcher here. Inputs: every ``chip_smoke.HASH_CASES`` entry; one row
found and one row inserted in an empty table of the q5 capacity (the fixed
cost of a launch and its dependent round trips); and the hash join's
rehash (``ops/join_state.py::import_side``) at two sizes: every key of a
table of 1<<16 or 1<<18 slots at load 0.9, in its slot order, into an
empty table twice as large. Where a find-or-insert input has more than
``chip_smoke.CHUNK`` rows, "auto" takes the cooperative grid, and the
phased path forced onto it is timed too ("new_phased"). Each version is
checked slot for slot against the plain version on every input, then
timed in the order old..., new, new_phased, new_phased, new, ...old with
``chip_smoke.time_cuda``: device time with L2 evicted before each call,
each find-or-insert on its own table copy made before the timed loop,
from the profiler's CUDA trace (or CUDA events where the trace lost
kernels; ``<tag>_timing`` says which). The phased calls also report the claim
rounds their last call ran. With ``--fused`` the inputs are instead every
16th find-or-insert of one fused q5, q8 and q3 epoch (after a warm-up
epoch), as those paths give them to the kernel; each line also gives the
rows absent from the table before the call and the new keys, and a last
line per path the mean time per call of each version and the share of
calls that needed claim rounds (rows that lost their first empty slot to
another key). One JSON line per input goes to stdout and, with ``--out``,
to that file. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from risingwave_tpu_torch import kernels  # noqa: E402
from risingwave_tpu_torch.ops import hash_table as ht  # noqa: E402

#: inputs timed beyond chip_smoke.HASH_CASES: (name, op)
EXTRA_CASES = [("one_row_empty", "find"), ("one_row_empty", "insert"),
               ("rehash_1<<16", "insert"), ("rehash_1<<18", "insert")]


class Current:
    """The port's wrapper, on the library built from the checkout or, for
    an earlier source with the same launcher, on that one."""

    def __init__(self, tag: str, lib: ctypes.CDLL | None = None,
                 path: str = "auto"):
        self.tag, self.lib, self.path = tag, lib, path
        self.workspaces = {}

    @contextlib.contextmanager
    def _bound(self):
        if self.lib is None:
            yield
            return
        saved = kernels.load("hash_probe"), ht._workspaces
        kernels._loaded["hash_probe"], ht._workspaces = \
            self.lib, self.workspaces
        try:
            yield
        finally:
            kernels._loaded["hash_probe"], ht._workspaces = saved

    def insert(self, table, cols, valid):
        with self._bound():
            return ht.ht_lookup_or_insert(table, cols, valid, path=self.path)

    def find(self, table, cols, valid):
        with self._bound():
            return ht.ht_lookup(table, cols, valid)

    def rounds(self):
        """The claim rounds of the last phased call."""
        with self._bound():
            return ht.last_claim_rounds()


class FirstVersion:
    """The first ``hash_probe.cu`` (every row in the reference's rounds):
    its launcher takes a workspace of four round counters and then the
    claim words, and no row count."""

    def __init__(self, lib: ctypes.CDLL, tag: str):
        self.lib, self.tag = lib, tag
        ptr, arr = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
        head = [ptr, ctypes.c_longlong, ctypes.c_int, arr, arr,
                ctypes.POINTER(ctypes.c_int), arr, arr, ptr,
                ctypes.c_longlong]
        lib.hash_probe_insert_launch.argtypes = head + [ptr] * 4 + [
            ctypes.c_int, ptr]
        lib.hash_probe_find_launch.argtypes = head + [ptr] * 3
        lib.hash_probe_insert_launch.restype = ctypes.c_int
        lib.hash_probe_find_launch.restype = ctypes.c_int
        self.ws = None

    def insert(self, table, cols, valid):
        args, keep = ht._launch_args(table, cols, valid)
        n, dev = valid.shape[0], valid.device
        if self.ws is None or self.ws.numel() < 4 + table.capacity:
            self.ws = torch.full((4 + table.capacity,), ht._CLAIM_FREE,
                                 dtype=torch.int32, device=dev)
        slots = torch.empty(n, dtype=torch.int64, device=dev)
        is_new = torch.empty(n, dtype=torch.bool, device=dev)
        overflow = torch.empty((), dtype=torch.bool, device=dev)
        err = self.lib.hash_probe_insert_launch(
            *args, slots.data_ptr(), is_new.data_ptr(), overflow.data_ptr(),
            self.ws.data_ptr(), 0, torch.cuda.current_stream().cuda_stream)
        del keep
        if err:
            raise RuntimeError(f"{self.tag} insert launch failed: {err}")
        return table, slots, is_new, overflow

    def find(self, table, cols, valid):
        args, keep = ht._launch_args(table, cols, valid)
        n, dev = valid.shape[0], valid.device
        slots = torch.empty(n, dtype=torch.int64, device=dev)
        found = torch.empty(n, dtype=torch.bool, device=dev)
        err = self.lib.hash_probe_find_launch(
            *args, slots.data_ptr(), found.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        del keep
        if err:
            raise RuntimeError(f"{self.tag} find launch failed: {err}")
        return slots, found

    def rounds(self):
        return None


def build_versions(old: list[Path]) -> dict:
    """tag -> version: "new" as the port builds it, then the old sources,
    compiled in parallel."""
    for log in kernels.build(["hash_probe"]).values():
        print(log.strip(), file=sys.stderr)
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for k, src in enumerate(old):
        tag = "old" + (str(k + 1) if k else "")
        out = kernels.BUILD_DIR / f"time-{tag}-hash_probe.so"
        procs[tag] = (subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(out),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), out)
    versions = {"new": Current("new")}
    for tag, (proc, out) in procs.items():
        log, _ = proc.communicate()
        print(f"nvcc {tag}:\n{log.strip()}", file=sys.stderr)
        if proc.returncode:
            raise RuntimeError(f"building {tag} failed")
        lib = ctypes.CDLL(str(out))
        versions[tag] = Current(tag, lib) \
            if hasattr(lib, "hash_probe_workspace_words") \
            else FirstVersion(lib, tag)
    return versions


def extra_case(name: str, device):
    """(table, key columns, valid) of an ``EXTRA_CASES`` entry."""
    from risingwave_tpu_torch.common import INT64, TIMESTAMP, Column
    if name == "one_row_empty":
        table = ht.ht_new((TIMESTAMP, INT64), cs.Q5_TABLE_CAPACITY, device)
        ones = torch.ones(1, dtype=torch.bool, device=device)
        cols = cs._key_cols([([1_600_000_000_000_000], [True]),
                             ([1_234], [True])], device)
        return table, cols, ones
    old_cap = 1 << int(name.split("<<")[1])
    gen = torch.Generator(device=device).manual_seed(0)
    keys = torch.randint(0, 1 << 40, (int(0.9 * old_cap),), generator=gen,
                         device=device)
    old = ht.ht_new((INT64,), old_cap, device)
    ht.ht_lookup_or_insert(old, [Column(keys, torch.ones_like(
        keys, dtype=torch.bool))], torch.ones_like(keys, dtype=torch.bool))
    cols = [Column(d, m) for d, m in zip(old.key_data, old.key_mask)]
    return ht.ht_new((INT64,), 2 * old_cap, device), cols, old.occupied


def fused_cases(every: int = 16) -> list:
    """(path, (table, key columns, valid)) of every ``every``-th
    find-or-insert of one fused q5, q8 and q3 epoch, each run after a
    warm-up epoch, copied as the path gives them to the kernel."""
    from risingwave_tpu_torch.common import Column
    from risingwave_tpu_torch.ops import grouped_agg, session_window, stream_q3
    users = (grouped_agg, session_window, stream_q3)
    captured, seen = [], [0]
    path = [None]

    def capturing(table, cols, valid, *args, **kwargs):
        if path[0] is not None:
            seen[0] += 1
            if seen[0] % every == 1:
                captured.append((path[0], (table.clone(), [
                    Column(c.data.clone(), c.mask.clone()) for c in cols],
                    valid.clone())))
        return ht.ht_lookup_or_insert(table, cols, valid, *args, **kwargs)

    runners = {
        "q5": lambda: cs.FusedQ5("cuda", cs.Q5_TABLE_CAPACITY, cs.CHUNK,
                                 cs.FUSED_CHUNKS_PER_EPOCH),
        "q8": lambda: cs.FusedQ8("cuda", cs.CHUNK, cs.FUSED_CHUNKS_PER_EPOCH),
        "q3": lambda: cs.FusedQ3("cuda", cs.CHUNK, cs.FUSED_CHUNKS_PER_EPOCH)}
    for mod in users:
        mod.ht_lookup_or_insert = capturing
    try:
        for name, make in runners.items():
            runner = make()
            runner.epoch(cs.Drain())
            path[0], seen[0] = name, 0
            runner.epoch(cs.Drain())
            path[0] = None
    finally:
        for mod in users:
            mod.ht_lookup_or_insert = ht.ht_lookup_or_insert
    torch.cuda.synchronize()
    return captured


def differences(version, table, cols, valid, op) -> int:
    """Where ``version`` and the plain version differ on one input (slots,
    is_new or found, overflow, and for find-or-insert the final table)."""
    if op == "insert":
        got = version.insert(table.clone(), cols, valid)
        want = ht.ht_lookup_or_insert_plain(table.clone(), cols, valid)
        err = cs.table_errors(got[0], want[0])
        got, want = got[1:], want[1:]
    else:
        got = version.find(table, cols, valid)
        want = ht.ht_lookup_plain(table, cols, valid)
        err = 0
    return err + sum(int((a != b).sum()) for a, b in zip(got, want))


def compare(name, op, case, versions) -> dict:
    table, cols, valid = case
    n = valid.shape[0]
    line = {"input": name, "op": op, "N": n, "cap": table.capacity}
    versions = dict(versions)
    if op == "insert" and n > cs.CHUNK:
        line["auto_path"] = "grid"
        versions["new_phased"] = Current("new_phased", path="phased")
    for tag, v in versions.items():
        line[f"{tag}_equal"] = differences(v, table, cols, valid, op) == 0
    tags = [t for t in versions if t.startswith("old")] + [
        t for t in versions if t.startswith("new")]
    for tag in tags + tags[::-1]:
        v = versions[tag]
        if op == "insert":
            def call(t):
                v.insert(t, cols, valid)
        else:
            def call(t):
                v.find(t, cols, valid)
        ms, _, timing = cs.time_cuda(call, iters=20,
                                     fresh=lambda: (table.clone(),))
        line.setdefault(f"{tag}_ms", []).append(ms)
        line.setdefault(f"{tag}_timing", []).append(timing)
        if op == "insert" and (n <= cs.CHUNK or tag == "new_phased"):
            line[f"{tag}_rounds"] = v.rounds()
    if op == "insert":
        _, s0, f0, _ = ht.ht_lookup_or_insert_plain(table.clone(), cols,
                                                    valid)
        line["absent_rows"] = int((valid & ~ht.ht_lookup_plain(
            table, cols, valid)[1]).sum())
        line["new_keys"] = int(f0.sum())
    else:
        s0, f0 = ht.ht_lookup_plain(table, cols, valid)
    line["bound_ms"] = cs.hash_probe_bound(table, cols, valid, s0, f0, op)[0]
    line["sector_floor_ms"] = cs.hash_probe_floor(table, cols, valid, s0, f0,
                                                  op)
    return line


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, action="append", default=[],
                    help="also time an earlier hash_probe.cu (repeatable)")
    ap.add_argument("--fused", action="store_true",
                    help="time the fused paths' inputs, not HASH_CASES")
    ap.add_argument("--out", type=Path, help="also write the lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_hash_probe: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line())
    versions = build_versions(args.old)
    if args.fused:
        cases = [(f"fused {path}", "insert", case)
                 for path, case in fused_cases()]
    else:
        cases = [(name, op, cs.hash_case(name, "cuda"))
                 for name, op in cs.HASH_CASES]
        cases += [(name, op, extra_case(name, "cuda"))
                  for name, op in EXTRA_CASES]
    lines = []
    for name, op, case in cases:
        line = compare(name, op, case, versions)
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.fused:
        for path in ("fused q5", "fused q8", "fused q3"):
            mine = [x for x in lines if x["input"] == path]
            summary = {"input": path, "calls": len(mine),
                       "share_with_rounds": sum(
                           bool(x.get("new_rounds")) for x in mine)
                       / max(len(mine), 1)}
            for tag in versions:
                summary[f"{tag}_mean_ms"] = sum(
                    sum(x[f"{tag}_ms"]) / len(x[f"{tag}_ms"]) for x in mine) \
                    / max(len(mine), 1)
            print(json.dumps(summary), flush=True)
            lines.append(summary)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0 if all(v for x in lines for k, v in x.items()
                    if k.endswith("_equal")) else 1


if __name__ == "__main__":
    sys.exit(main())
