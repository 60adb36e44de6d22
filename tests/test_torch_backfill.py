"""The port's BackfillExecutor against the reference's, on the CPU: the
four cases of tests/test_backfill.py at the executor level (a backfill
across barriers, live deltas exact, barriers back to back with updates at
both ends of the key space, a crash mid-backfill resumed from the
persisted cursor), with integer and with VARCHAR pks.

Both packages run one script: an upstream StateTable loaded with rows,
then per epoch the upstream's DML (applied to the table as its
Materialize would, and sent to the backfill as the live delta) and a
barrier (the table sealed first; the store committed after a checkpoint
barrier has passed the backfill). The visible output of each epoch must
be equal as a multiset: the port keeps a chunk whose rows were all masked
(no host sync to drop it), the reference drops it.
"""

import asyncio
import collections

import pytest

import risingwave_tpu.stream.backfill as JB
import risingwave_tpu_torch.stream.backfill as TB
from test_torch_recovery import BOTH, JAX, TORCH

CAP = 32
I, D, UD, UI = 0, 1, 2, 3


def key_of(k: int, kind: str):
    """Integer keys, or strings whose order differs from the ids' (ids
    follow interning order)."""
    return k if kind == "int" else f"{(k * 7919) % 1000:03d}-{k}"


def schema(pkg, kind):
    return pkg.schema(("k", "INT64" if kind == "int" else "VARCHAR"),
                      ("g", "INT64"), ("v", "INT64"))


class Script:
    """The upstream job as the backfill sees it: ``steps`` of ("dml",
    [(op, row), ...]) and ("barrier", epoch, checkpoint)."""

    identity = "Script"

    def __init__(self, pkg, table, store, steps, sch):
        self.pkg, self.table, self.store = pkg, table, store
        self.steps, self.schema = steps, sch

    async def execute(self):
        owed = None                      # a checkpoint to commit
        for step in self.steps:
            if owed is not None:
                self.store.commit(owed)
                owed = None
            if step[0] == "dml":
                rows = [r for _, r in step[1]]
                ops = [op for op, _ in step[1]]
                for op, r in step[1]:
                    phys = tuple(t.to_physical(v)
                                 for t, v in zip(self.schema.types, r))
                    (self.table.insert if op in (I, UI)
                     else self.table.delete)(phys)
                yield self.pkg.chunk(self.schema, rows, ops,
                                     max(CAP, len(rows)))
            else:
                self.table.commit(step[1])
                yield self.pkg.stream.Barrier.new(step[1],
                                                  checkpoint=step[2])
                if step[2]:
                    owed = step[1]
            await asyncio.sleep(0)
        if owed is not None:
            self.store.commit(owed)


def load(pkg, kind, n_rows, store=None):
    store = store or pkg.store_cls()
    sch = schema(pkg, kind)
    table = pkg.table_cls(store, 1, sch, [0])
    for k in range(n_rows):
        table.insert(tuple(t.to_physical(v) for t, v in zip(
            sch.types, (key_of(k, kind), k % 7, k))))
    table.commit(1)
    store.commit(1)
    return store, table


def run(pkg, kind, steps, n_rows=600, batch_rows=64, state=None):
    """Per-epoch sorted visible output (op, row) and the progress after
    each barrier. ``state``: (store, table) to resume on."""
    store, table = state or load(pkg, kind, n_rows)
    mod = JB if pkg is JAX else TB
    prog = pkg.table_cls(store, 2, mod.PROGRESS_SCHEMA, [0])
    progress = []
    bf = mod.BackfillExecutor(
        Script(pkg, table, store, steps, table.schema), table,
        batch_rows=batch_rows, chunk_capacity=CAP, progress_table=prog,
        on_progress=progress.append, **pkg.kw())
    epochs = [[]]

    async def drain():
        async for m in bf.execute():
            if isinstance(m, pkg.stream.Barrier):
                epochs.append([])
            else:
                epochs[-1].extend(pkg.common.chunk_to_rows(
                    m, bf.schema, with_ops=True))

    with pkg.eager():
        asyncio.run(drain())
    return [sorted(e) for e in epochs], [p["rows_done"] for p in progress], \
        (store, table)


def net(epochs) -> collections.Counter:
    """Net rows of a changelog."""
    c = collections.Counter()
    for e in epochs:
        for op, r in e:
            c[r] += 1 if op in (I, UI) else -1
    return +c


def barriers(first, n, every=1):
    return [("barrier", first + i, (i + 1) % every == 0) for i in range(n)]


def update(kind, k, v, old_v=None):
    """U-/U+ of row k from value ``old_v`` (k if None) to ``v``."""
    old = (key_of(k, kind), k % 7, k if old_v is None else old_v)
    return ("dml", [(UD, old), (UI, (old[0], k % 7, v))])


@pytest.mark.parametrize("kind", ["int", "varchar"])
def test_backfill_spans_barriers(kind):
    """600 rows at 64 per barrier: ten bounded batches, progress
    monotonic, the whole table delivered once."""
    steps = barriers(2, 12)
    (je, jp, _), (te, tp, _) = (run(p, kind, steps) for p in BOTH)
    assert te == je
    assert tp == jp and len(tp) >= 10 and tp == sorted(tp)
    assert net(te) == collections.Counter(
        (key_of(k, kind), k % 7, k) for k in range(600))


@pytest.mark.parametrize("kind", ["int", "varchar"])
def test_live_deltas_during_backfill_are_exact(kind):
    """After the first batch, an update of a row already read (its delta
    passes) and of one not yet read (its delta is masked; the new value
    comes with a later batch): the MV's net rows are the table's."""
    first = sorted(range(600), key=lambda k: key_of(k, kind))
    lo, hi = first[0], first[-1]
    steps = (barriers(2, 1) + [update(kind, lo, 100000),
                               update(kind, hi, 200000)]
             + barriers(3, 12))
    (je, _, _), (te, _, _) = (run(p, kind, steps) for p in BOTH)
    assert te == je
    want = collections.Counter((key_of(k, kind), k % 7, k)
                               for k in range(600) if k not in (lo, hi))
    want[(key_of(lo, kind), lo % 7, 100000)] += 1
    want[(key_of(hi, kind), hi % 7, 200000)] += 1
    assert net(te) == want


def test_barriers_back_to_back_with_updates_stay_exact():
    """Updates at both ends of the key space between barriers that follow
    each other, every second one a checkpoint, at a batch of 32."""
    steps = barriers(2, 1, 2)
    for i in range(8):
        steps += [update("int", 0, 1000000 + i, 1000000 + i - 1 if i else 0),
                  update("int", 799, 2000000 + i,
                         2000000 + i - 1 if i else 799)]
        steps += barriers(3 + 2 * i, 2, 2)
    steps += barriers(19, 20, 2)
    (je, jp, _), (te, tp, _) = (run(p, "int", steps, n_rows=800,
                                    batch_rows=32) for p in BOTH)
    assert te == je and tp == jp
    want = collections.Counter((k, k % 7, k) for k in range(1, 799))
    want[(0, 0, 1000007)] += 1
    want[(799, 799 % 7, 2000007)] += 1
    assert net(te) == want


@pytest.mark.parametrize("kind", ["int", "varchar"])
def test_crash_mid_backfill_resumes_from_cursor(kind):
    """Two checkpoints into the backfill the executor is dropped; a new one
    over the same store resumes from the persisted cursor (its pk values
    included), and the two runs together deliver the table once."""
    runs = {}
    for pkg in BOTH:
        first, _, state = run(pkg, kind, barriers(2, 2))
        rest, prog, _ = run(pkg, kind, barriers(4, 10), state=state)
        runs[pkg is JAX] = (first, rest, prog)
    assert runs[False] == runs[True]
    first, rest, prog = runs[False]
    assert prog[0] > 2 * 64                  # resumed, not restarted
    assert net(first + rest) == collections.Counter(
        (key_of(k, kind), k % 7, k) for k in range(600))


def test_reference_backfill_resumes_in_the_port():
    """A reference backfill dropped after two checkpoints: the reference's
    store snapshot (the upstream table and the progress row) restored into
    the port's store, the port's backfill resumes where the reference's
    stopped, and its progress equals the reference executor's as
    ``interop.backfill_progress_from_jax`` carries it."""
    from risingwave_tpu_torch.interop import backfill_progress_from_jax
    _, _, (jstore, jtable) = run(JAX, "int", barriers(2, 2))
    store = TORCH.store_cls()
    store.restore(jstore.snapshot())
    table = TORCH.table_cls(store, 1, schema(TORCH, "int"), [0])
    prog = TORCH.table_cls(store, 2, TB.PROGRESS_SCHEMA, [0])
    resumed = TB.BackfillExecutor(None, table, batch_rows=64,
                                  chunk_capacity=CAP, progress_table=prog,
                                  device="cpu")
    ref = JB.BackfillExecutor(None, jtable, batch_rows=64,
                              chunk_capacity=CAP, progress_table=JAX.table_cls(
                                  jstore, 2, JB.PROGRESS_SCHEMA, [0]))
    carried = backfill_progress_from_jax(ref)
    assert {k: getattr(resumed, k) for k in carried} == carried
    assert carried["rows_done"] == 2 * 64 and not carried["done"]
    rest_t, _, _ = run(TORCH, "int", barriers(4, 10), state=(store, table))
    rest_j, _, _ = run(JAX, "int", barriers(4, 10), state=(jstore, jtable))
    assert rest_t == rest_j
