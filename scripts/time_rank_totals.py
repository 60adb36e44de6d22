"""Time kernel B1 (same-key rank/total) against earlier versions of its
source, side by side in one process on one card.

    python3 scripts/time_rank_totals.py [--old OLD.cu ...] [--out FILE.jsonl]

Builds ``risingwave_tpu_torch/csrc/rank_totals.cu`` and each ``--old``
source (an earlier ``rank_totals.cu``; one whose ``rank_totals_launch``
takes a workspace exports ``rank_totals_workspace_bytes``, one without takes
none). Inputs: every ``chip_smoke.RANK_CASES`` entry and a few more, the
q7 executor run's input with the most keyed rows, and the whole q7 run
(every B1 input it made, one call each, as ``chip_smoke.run_q7_capturing``
captures them), whole and split by keyed rows per input. Each version is
checked exactly against the plain version on every input, then timed in
the order old..., new, new, ...old with ``chip_smoke.time_cuda`` (device
time with L2 evicted before each call, from the profiler's CUDA trace,
summed over a call's kernels, or CUDA events where the trace lost
kernels; ``<tag>_timing`` says which). One
JSON line per input goes to stdout and, with ``--out``, to that file.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
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
from risingwave_tpu_torch.ops import rank_totals as rt  # noqa: E402

#: inputs timed beyond chip_smoke.RANK_CASES: (N, W, pattern)
EXTRA_CASES = [(4096, 128, "probe_32"), (4096, 128, "probe_128"),
               (4096, 128, "few_256"), (32768, 128, "one_hot_key")]
#: the q7 run's inputs split by keyed rows: (name, lowest, highest)
Q7_CLASSES = [("no keyed row", 0, 0), ("1-256 keyed rows", 1, 256),
              ("over 256 keyed rows", 257, 1 << 31)]


def build_version(src: Path, tag: str):
    """``fn(ident, matches) -> (r, t)`` of the ``rank_totals.cu`` at src."""
    out = kernels.BUILD_DIR / f"{tag}-{src.stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    launch = lib.rank_totals_launch
    with_ws = hasattr(lib, "rank_totals_workspace_bytes")
    launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p] * (2 if with_ws else 1)
    launch.restype = ctypes.c_int
    if with_ws:
        lib.rank_totals_workspace_bytes.argtypes = [ctypes.c_int] * 2
        lib.rank_totals_workspace_bytes.restype = ctypes.c_size_t
    spaces = {}

    def fn(ident, matches):
        n, w = matches.shape
        r = torch.empty((n, w), dtype=torch.int32, device=ident.device)
        t = torch.empty_like(r)
        stream = torch.cuda.current_stream().cuda_stream
        extra = []
        if with_ws:
            nbytes = lib.rank_totals_workspace_bytes(n, w)
            ws = spaces.get(stream)
            if ws is None or ws.numel() < nbytes:
                ws = torch.zeros(nbytes, dtype=torch.uint8,
                                 device=ident.device)
                spaces[stream] = ws
            extra = [ws.data_ptr()]
        err = launch(ident.data_ptr(), matches.data_ptr(), r.data_ptr(),
                     t.data_ptr(), n, w, *extra, stream)
        if err:
            raise RuntimeError(f"{tag} rank_totals launch failed: {err}")
        return r, t

    return fn


def compare(name, inputs, fns, plain_iters=10):
    """One JSON-able line: each version exact against the plain version on
    every input of ``inputs`` and its device time summed over them."""
    line = {"input": name, "calls": len(inputs),
            "shape": list(inputs[0][1].shape),
            "keyed_rows": cs.keyed_rows(inputs)[:8]}
    for tag, fn in fns.items():
        equal = True
        for ident, matches in inputs:
            r, t = fn(ident, matches)
            r0, t0 = rt.rank_totals_plain(ident, matches)
            equal &= bool(torch.equal(r, r0) and torch.equal(t, t0))
            del r0, t0
        line[f"{tag}_equal"] = equal
    tags = list(fns)
    order = tags[1:] + ["new", "new"] + tags[:0:-1] if len(tags) > 1 \
        else ["new", "new"]
    iters = 10 if len(inputs) > 1 else 50
    for tag in order:
        per = {}
        ms, _, timing = cs.time_cuda(
            lambda: [fns[tag](i, m) for i, m in inputs], iters=iters,
            by_kernel=per)
        line.setdefault(f"{tag}_ms", []).append(ms)
        line.setdefault(f"{tag}_timing", []).append(timing)
        line[f"{tag}_kernels"] = {k[:48]: v for k, v in per.items()}
    line["plain_ms"], _, line["plain_timing"] = cs.time_cuda(
        lambda: [rt.rank_totals_plain(i, m) for i, m in inputs],
        iters=plain_iters)
    line["bound_ms"] = sum(cs.rank_totals_bound(i, m)[0] for i, m in inputs)
    line["bound_by"] = "bytes"
    return line


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, action="append", default=[],
                    help="an earlier rank_totals.cu (may be repeated)")
    ap.add_argument("--out", type=Path, help="also write the lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_rank_totals: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line())
    for log in kernels.build(["rank_totals"]).values():
        print(log.strip(), file=sys.stderr)
    fns = {"new": rt.rank_totals}
    for k, src in enumerate(args.old):
        fns[f"old{k}" if len(args.old) > 1 else "old"] = \
            build_version(src, f"old{k}")
    inputs = [(f"N={n} W={w} {p}", [cs.rank_inputs(n, w, p, k, "cuda")])
              for k, (n, w, p) in enumerate(cs.RANK_CASES + EXTRA_CASES)]
    chunks = cs.bid_chunks(cs.EPOCHS * cs.CHUNKS_PER_EPOCH, "cuda")
    captured = cs.run_q7_capturing(chunks, "cuda")[3]
    keyed = cs.keyed_rows(captured)
    inputs.append(("q7 captured", [captured[keyed.index(max(keyed))]]))
    inputs.append(("q7 run, every input", captured))
    for name, lo, hi in Q7_CLASSES:
        part = [im for im, k in zip(captured, keyed) if lo <= k <= hi]
        if part:
            inputs.append((f"q7 run, {name}", part))
    lines = []
    for name, ins in inputs:
        big = ins[0][1].shape[0] > cs.CHUNK
        line = compare(name, ins, fns, plain_iters=3 if big else 10)
        if name == "q7 run, every input":
            line["keyed_rows"] = keyed
        print(json.dumps(line), flush=True)
        lines.append(line)
        torch.cuda.empty_cache()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0 if all(v for x in lines for k, v in x.items()
                    if k.endswith("_equal")) else 1


if __name__ == "__main__":
    sys.exit(main())
