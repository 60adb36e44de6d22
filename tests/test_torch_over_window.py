"""OverWindow (general and EOWC) through both packages on the CPU.

``compute_window_values`` for every function on random partitions (ties,
NULLs, DESC, NULLS FIRST) against the reference's; the general executor's
retraction diffs (inserts, deletes, update pairs, a pk moving partition)
with a DESC order over VARCHAR, compared by decoded string, and its
recovery from a state table; the EOWC executor's accumulators carried
across with ``interop``, and its accumulator and buffer tables, whose rows
interchange with the reference's. Reference executors run op by op under
``jax.disable_jit``. Tolerance: exact (a FLOAT64 avg divides the same
Python floats in the same order in both packages).
"""

import copy
import random

import pytest

import risingwave_tpu.ops.topn as JT
import risingwave_tpu.stream.over_window as JW
import risingwave_tpu_torch.ops.topn as TT
import risingwave_tpu_torch.stream.over_window as TW
from risingwave_tpu_torch.interop import (
    eowc_state_from_jax, over_window_state_from_jax,
)
from test_torch_eowc import events
from test_torch_recovery import BOTH, JAX, TORCH

I, D, UD, UI = 0, 1, 2, 3
KGOV = (("k", "INT64"), ("g", "INT64"), ("o", "INT64"), ("v", "INT64"),
        ("f", "FLOAT64"))


def mods(pkg):
    return (JT, JW) if pkg is JAX else (TT, TW)


def calls(pkg, kinds, order=((2, False, True),), part=(1,)):
    """WindowCalls of ``kinds`` ((kind, arg, offset, FLOAT64 out?))."""
    topn, win = mods(pkg)
    c = pkg.common
    order_by = tuple(topn.OrderSpec(col, desc=desc, nulls_last=nl)
                     for col, desc, nl in order)
    return tuple(win.WindowCall(kind, c.FLOAT64 if flt else c.INT64,
                                arg=arg, offset=off, partition_by=part,
                                order_by=order_by)
                 for kind, arg, off, flt in kinds)


EVERY = [("row_number", -1, 1, False), ("rank", -1, 1, False),
         ("dense_rank", -1, 1, False), ("lag", 3, 1, False),
         ("lag", 3, 2, False), ("lead", 3, 1, False), ("lead", 4, 3, True),
         ("sum", 3, 1, False), ("count", 3, 1, False),
         ("count", -1, 1, False), ("min", 3, 1, False),
         ("max", 4, 1, True), ("avg", 3, 1, False), ("avg", 4, 1, True),
         ("sum", 4, 1, True)]


def random_rows(rng, n):
    def maybe(v):
        return None if rng.random() < 0.15 else v

    return [(k, rng.randrange(3), maybe(rng.randrange(6)),
             maybe(rng.randrange(-50, 50)), maybe(rng.random() * 10 - 3))
            for k in range(n)]


@pytest.mark.parametrize("order", [((2, False, True),), ((2, True, False),),
                                   ((2, True, True), (3, False, True)), ()],
                         ids=["asc", "desc_nulls_first", "two_keys",
                              "no_order"])
@pytest.mark.parametrize("seed", [0, 1])
def test_compute_window_values_every_function(order, seed):
    rng = random.Random(seed)
    rows = [r for r in random_rows(rng, 60) if r[1] == 0]
    got = [mods(pkg)[1].compute_window_values(rows, calls(pkg, EVERY, order),
                                              (0,))
           for pkg in BOTH]
    assert got[1] == got[0] and len(got[0]) == len(rows)


# ---------------------------------------------------------------------------
# the general executor
# ---------------------------------------------------------------------------

KGSV = (("k", "INT64"), ("g", "INT64"), ("s", "VARCHAR"), ("v", "INT64"))
CHURN = [("b", 1, False),
         ("c", [(1, 7, "pear", 10), (2, 7, "apple", 20), (3, 8, "fig", 5),
                (4, 7, "pear", 30)], None), ("b", 2, False),
         ("c", [(5, 7, "zucchini", 1), (2, 7, "apple", 20)], [I, D]),
         ("b", 3, False),
         ("c", [(4, 7, "pear", 30), (4, 7, "kiwi", 31)], [UD, UI]),
         ("c", [(1, 8, "pear", 10)], None), ("b", 4, True),
         ("c", [(6, 8, "banana", 2), (3, 8, "fig", 5)], [I, D]),
         ("b", 5, True)]


def general(pkg, src, store=None, **kw):
    topn, win = mods(pkg)
    c = pkg.common
    order = (topn.OrderSpec(2, desc=True, is_string=True),)
    cs = (win.WindowCall("row_number", c.INT64, partition_by=(1,),
                         order_by=order),
          win.WindowCall("lag", c.VARCHAR, arg=2, partition_by=(1,),
                         order_by=order),
          win.WindowCall("sum", c.INT64, arg=3, partition_by=(1,),
                         order_by=order))
    if store is not None:
        kw["state_table"] = pkg.table_cls(store, 7, src.schema, [0])
    return win.OverWindowExecutor(src, cs, pk_indices=[0], out_capacity=4,
                                  **pkg.kw(**kw))


def source(pkg, spec, schema=KGSV):
    s = pkg.schema(*schema)
    return pkg.stream.MockSource(s, pkg.messages(s, spec))


def test_general_over_window_retractions_as_reference():
    """Every output row in order, strings decoded: deletes of the barrier
    first, then inserts and U-/U+ pairs; pk 1 moves from partition 7 to 8.
    DESC on VARCHAR orders by string, whatever the ids."""
    got = [events(pkg, general(pkg, source(pkg, CHURN))) for pkg in BOTH]
    assert got[1] == got[0]
    assert (D, (1, 7, "pear", 10, 2, "zucchini", 41)) in got[0]
    assert (I, (1, 8, "pear", 10, 1, None, 10)) in got[0]
    assert (I, (5, 7, "zucchini", 1, 1, None, 1)) in got[0]


def test_general_over_window_recovery_as_reference():
    """Dropped after epoch 4 (a checkpoint) and rebuilt from its state
    table: the next epoch's diffs and the store equal the reference's."""
    first, second = CHURN[:8], [("b", 5, False)] + CHURN[8:]
    outs = {}
    for pkg in BOTH:
        store = pkg.store_cls()
        a = events(pkg, general(pkg, source(pkg, first), store), store)
        with pkg.eager():
            ex = general(pkg, source(pkg, second), store)
        b = events(pkg, ex, store)
        outs[pkg.device] = (a, b, store.snapshot())
    assert outs["cpu"] == outs[None]
    assert any(r[0] == D for r in outs["cpu"][1])


def test_general_over_window_state_carried_by_interop():
    ints = [("b", 1, False),
            ("c", [(1, 7, 3, 10, 0.5), (2, 7, 1, 20, 1.5),
                   (3, 8, 2, 5, None)], None), ("b", 2, False)]
    rest = [("b", 3, False),
            ("c", [(4, 7, 2, 7, 2.0), (1, 7, 3, 10, 0.5)], [I, D]),
            ("b", 4, False)]

    def make(pkg, spec):
        _, win = mods(pkg)
        return win.OverWindowExecutor(
            source(pkg, spec, KGOV), calls(pkg, EVERY), pk_indices=[0],
            out_capacity=4, **pkg.kw())

    ref = make(JAX, ints)
    events(JAX, ref)
    port = make(TORCH, rest)
    for name, value in over_window_state_from_jax(ref).items():
        setattr(port, name, value)
    ref_next = make(JAX, rest)
    for name in ("_parts", "_pk_loc", "_out"):
        setattr(ref_next, name, copy.deepcopy(getattr(ref, name)))
    assert events(TORCH, port) == events(JAX, ref_next)


# ---------------------------------------------------------------------------
# the EOWC executor
# ---------------------------------------------------------------------------

def eowc(pkg, src, store=None, **kw):
    topn, win = mods(pkg)
    c = pkg.common
    cs = calls(pkg, [("row_number", -1, 1, False), ("rank", -1, 1, False),
                     ("dense_rank", -1, 1, False), ("sum", 3, 1, False),
                     ("count", -1, 1, False), ("min", 3, 1, False),
                     ("max", 3, 1, False), ("avg", 4, 1, True)])
    if store is not None:
        kw["acc_table"] = pkg.table_cls(
            store, 8, win.eowc_acc_schema(src.schema, cs), [0])
        kw["buffer_table"] = pkg.table_cls(store, 9, src.schema, [0])
    return win.EowcOverWindowExecutor(src, cs, pk_indices=[0],
                                      out_capacity=4, **pkg.kw(**kw))


SORTED = [("b", 1, False),
          ("c", [(1, 7, 1, 10, 1.0), (2, 8, 1, 5, None), (3, 7, 1, 4, 2.5)],
           None),
          ("c", [(4, 7, 2, None, 0.25), (5, 8, 3, 6, 1.0)], None),
          ("w", 2, 3), ("b", 2, True),
          ("c", [(6, 7, 3, 8, 2.0), (7, 7, 3, 1, 3.0), (8, 8, 4, 2, 0.5)],
           None), ("b", 3, False), ("w", 2, 9), ("b", 4, True)]


def test_eowc_over_window_as_reference():
    got = [events(pkg, eowc(pkg, source(pkg, SORTED, KGOV))) for pkg in BOTH]
    assert got[1] == got[0]
    rows = [r[1] for r in got[0] if r[0] == I]
    assert len(rows) == 8


def test_eowc_accumulators_carried_by_interop():
    """The reference runs the first two epochs; its accumulators, open
    peer groups and watermark go to the port's executor, and both run the
    rest."""
    ref = eowc(JAX, source(JAX, SORTED[:5], KGOV))
    events(JAX, ref)
    rest = [("b", 3, False)] + SORTED[5:]
    port = eowc(TORCH, source(TORCH, rest, KGOV))
    ref_next = eowc(JAX, source(JAX, rest, KGOV))
    state = eowc_state_from_jax(ref)
    for name, value in state.items():
        setattr(port, name, value)
        setattr(ref_next, name, copy.deepcopy(getattr(ref, name)))
    assert state["_accs"] and state["_pending"]
    assert events(TORCH, port) == events(JAX, ref_next)


def test_eowc_tables_interchange_with_reference():
    """The reference checkpoints its accumulator and buffer tables; the
    port recovers from a copy of that store and goes on as the reference
    does, and the stores stay byte for byte equal."""
    jstore = JAX.store_cls()
    events(JAX, eowc(JAX, source(JAX, SORTED[:5], KGOV), jstore), jstore)
    tstore = TORCH.store_cls()
    tstore.restore(jstore.snapshot())
    rest = [("b", 3, False)] + SORTED[5:]
    got = events(TORCH, eowc(TORCH, source(TORCH, rest, KGOV), tstore),
                 tstore)
    want = events(JAX, eowc(JAX, source(JAX, rest, KGOV), jstore), jstore)
    assert got == want and any(r[0] == I for r in got)
    assert tstore.snapshot() == jstore.snapshot()
