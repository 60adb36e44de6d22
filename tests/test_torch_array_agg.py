"""array_agg on the host tier in the port against the reference on the CPU:
its output (a LIST sorted by python value, NULL elements last) under
retraction beside string_agg, its checkpoint and recovery from the
reference's snapshot, the array functions and ``unnest`` over its output
(tests/test_materialized_agg.py:61-80 and :162-182), and the rejection of
LIST and STRUCT arguments. Tolerance: exact, compared after decoding.
"""

import asyncio

import jax
import pytest

import risingwave_tpu.common as J
import risingwave_tpu.expr as JE
import risingwave_tpu.expr.expr as JX
import risingwave_tpu.stream as JS
import risingwave_tpu_torch.common as T
import risingwave_tpu_torch.expr as TE
import risingwave_tpu_torch.expr.expr as TX
import risingwave_tpu_torch.stream as TS
import risingwave_tpu.stream.materialized_agg as JM
import risingwave_tpu.stream.project_set as JPS
import risingwave_tpu_torch.stream.materialized_agg as TM
import risingwave_tpu_torch.stream.project_set as TPS
from risingwave_tpu.storage import MemoryStateStore as JStore
from risingwave_tpu.storage import StateTable as JTable
from risingwave_tpu_torch.storage import MemoryStateStore as TStore
from risingwave_tpu_torch.storage import StateTable as TTable

PKG = {"jax": (J, JE, JX, JS, JM, JPS, JStore, JTable),
       "torch": (T, TE, TX, TS, TM, TPS, TStore, TTable)}
I, D, UD, UI = (J.OP_INSERT, J.OP_DELETE, J.OP_UPDATE_DELETE,
                J.OP_UPDATE_INSERT)


def kw(pkg):
    return {"device": "cpu"} if pkg == "torch" else {}


def t_schema(c):
    return c.Schema.of(("id", c.INT64), ("k", c.INT64), ("v", c.INT64),
                       ("s", c.VARCHAR))


def msgs(pkg, epochs, first=1, checkpoint=False):
    """A barrier, then per epoch one chunk of (rows, ops) and a barrier."""
    c, s = PKG[pkg][0], PKG[pkg][3]
    out = [s.Barrier.new(first, checkpoint=checkpoint)]
    for i, (rows, ops) in enumerate(epochs):
        out.append(c.make_chunk(t_schema(c), rows, ops=ops, capacity=16,
                                **kw(pkg)))
        out.append(s.Barrier.new(first + 1 + i, checkpoint=checkpoint))
    return out


def agg_plan(pkg, epochs, calls_of, store=None, first=1):
    c, e, _, s, m, _, _, table_cls = PKG[pkg]
    schema = t_schema(c)
    table = None
    if store is not None:
        table = table_cls(store, 31, m.materialized_agg_state_schema(
            [schema[1]]), list(range(1 + 5)))
    src = s.MockSource(schema, msgs(pkg, epochs, first, store is not None))
    return m.MaterializedAggExecutor(src, [1], calls_of(c, e),
                                     state_table=table, out_capacity=16,
                                     **kw(pkg))


def drive(pkg, ex, store=None):
    c, s = PKG[pkg][0], PKG[pkg][3]

    async def run():
        out = []
        async for m in ex.execute():
            if isinstance(m, s.Barrier):
                if store is not None and m.checkpoint:
                    store.commit(m.epoch.curr)
            else:
                out.extend(c.chunk_to_rows(m, ex.schema, with_ops=True))
        return out

    with jax.disable_jit():
        return asyncio.run(run())


def array_and_string(c, e):
    call = e.agg("string_agg", 3, c.VARCHAR)
    import dataclasses
    return [e.agg("array_agg", 2, c.INT64),
            dataclasses.replace(call, extra=","),
            e.agg("array_agg", 3, c.VARCHAR)]


EPOCHS = [([(1, 1, 3, "x"), (2, 1, 1, "y"), (3, 1, 2, "x"),
            (4, 2, None, None), (5, 2, 7, "a")], None),
          ([(3, 1, 2, "x")], [D]),
          ([(1, 1, 3, "x"), (2, 1, 1, "y"), (4, 2, None, None),
            (5, 2, 7, "a")], [D] * 4)]


def test_array_agg_with_retraction_matches_reference():
    """tests/test_materialized_agg.py::
    test_array_agg_and_string_agg_retraction, with NULL elements (last in
    the array) and a VARCHAR array sorted by string; a group that dies
    deletes its row."""
    outs = {pkg: drive(pkg, agg_plan(pkg, EPOCHS, array_and_string))
            for pkg in PKG}
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][:2] == [
        (I, (1, (1, 2, 3), "x,x,y", ("x", "x", "y"))),
        (I, (2, (7, None), "a", ("a", None)))]
    assert (UI, (1, (1, 3), "x,y", ("x", "y"))) in outs["torch"]
    assert outs["torch"][-1][0] == D


def test_array_agg_state_recovers_from_reference_snapshot():
    """tests/test_materialized_agg.py::test_materialized_state_recovery:
    equal committed bytes (VARCHAR values by content); the port restored
    from the reference's snapshot emits what the reference emits after
    its own recovery, the multisets retracting correctly."""
    first, rest = EPOCHS[:1], EPOCHS[1:]
    snaps, after = {}, {}
    for pkg in PKG:
        store = PKG[pkg][6]()
        drive(pkg, agg_plan(pkg, first, array_and_string, store), store)
        snaps[pkg] = store.snapshot()
        after[pkg] = drive(pkg, agg_plan(pkg, rest, array_and_string, store,
                                         first=3), store)
    assert snaps["torch"] == snaps["jax"]
    store = TStore()
    store.restore(snaps["jax"])
    got = drive("torch", agg_plan("torch", rest, array_and_string, store,
                                  first=3), store)
    assert got == after["torch"] == after["jax"]


def unnest_plan(pkg, epochs):
    """MaterializedAgg(GROUP BY k: array_agg(v)) → ProjectSet(k,
    unnest(vs)) (tests/test_materialized_agg.py::
    test_unnest_and_array_functions)."""
    c, e, x, s, m, ps, _, _ = PKG[pkg]
    agg = agg_plan(pkg, epochs, lambda c, e: [e.agg("array_agg", 2,
                                                     c.INT64)])
    vs = agg.schema[1].type
    exprs = [x.col(0, c.INT64),
             ps.TableFuncCall("unnest", (x.col(1, vs),), vs.elem_type)]
    return ps.ProjectSetExecutor(agg, exprs, names=["k", "v"],
                                 out_capacity=16, **kw(pkg))


def test_unnest_over_array_agg_matches_reference():
    """Each element a row, typed by the list's element type; retraction
    flows through (the array shrinks, its rows retract)."""
    epochs = [([(1, 1, 4, "a"), (2, 1, 6, "b"), (3, 2, 9, "c")], None),
              ([(2, 1, 6, "b")], [D])]
    outs = {pkg: drive(pkg, unnest_plan(pkg, epochs)) for pkg in PKG}
    assert outs["torch"] == outs["jax"]
    live = {}
    for op, r in outs["torch"]:
        live[r] = live.get(r, 0) + (1 if op in (I, UI) else -1)
    assert sorted(r for r, n in live.items() if n > 0) == [(1, 4), (2, 9)]


def test_array_functions_over_array_agg_output():
    """Project(k, array_length(vs), vs[1], vs[2]) over array_agg's output:
    equal rows in both packages."""
    epochs = [([(1, 1, 4, "a"), (2, 1, 6, "b"), (3, 2, 9, "c")], None),
              ([(1, 1, 4, "a")], [D])]
    outs = {}
    for pkg in PKG:
        c, e, x, s = PKG[pkg][:4]
        agg = agg_plan(pkg, epochs, lambda c, e: [e.agg("array_agg", 2,
                                                         c.INT64)])
        vs = x.col(1, agg.schema[1].type)
        exprs = [x.col(0, c.INT64), x.call("array_length", vs)] + [
            x.call("array_access", vs, x.Literal(i, c.INT64))
            for i in (1, 2)]
        outs[pkg] = drive(pkg, s.ProjectExecutor(agg, exprs,
                                                 names=["k", "n", "a",
                                                        "b"]))
    assert outs["torch"] == outs["jax"]
    assert (I, (1, 2, 4, 6)) in outs["torch"]
    assert (UI, (1, 1, 6, None)) in outs["torch"]


@pytest.mark.parametrize("kind", ["list", "struct"])
def test_list_and_struct_arguments_rejected(kind):
    """LIST and STRUCT ids are process-local and no value column persists
    their content: both packages refuse them as an agg argument
    (ROADMAP C3, materialized_agg.py:137)."""
    for pkg in PKG:
        c, e, _, s, m = PKG[pkg][:5]
        t = (c.types.list_of(c.INT64) if kind == "list"
             else c.types.struct_of(("a", c.INT64)))
        schema = c.Schema.of(("k", c.INT64), ("x", t))
        word = "array" if kind == "list" else "struct"
        with pytest.raises(ValueError, match=f"{word} column"):
            m.MaterializedAggExecutor(s.MockSource(schema, []), [0],
                                      [e.agg("count", 1, t, distinct=True)],
                                      **kw(pkg))
