"""ProjectSet (table functions), Union and Values through both packages on
the CPU.

ProjectSet: ``generate_series`` (two and three arguments, an empty range,
NULL bounds) with plain expressions replicated and the hidden ``_pidx``
element index, ``unnest`` of list-dictionary ids, ``regexp_split_to_table``
(VARCHAR output compared by decoded string, never by id), and update pairs
rewritten to Delete + Insert. Union: rows of both inputs as the aligned
polling schedule interleaves them, and each column's watermark re-emitted
as the minimum over the inputs only when it changes. Values: its rows once,
after the first barrier. Reference executors run op by op under
``jax.disable_jit``. Tolerance: exact.
"""

import asyncio

import pytest

import risingwave_tpu.common.types as JT
import risingwave_tpu.stream.project_set as JP
import risingwave_tpu_torch.common.types as TT
import risingwave_tpu_torch.stream.project_set as TP
from test_torch_eowc import events
from test_torch_recovery import BOTH, JAX

I, D, UD, UI = 0, 1, 2, 3


def ps(pkg):
    return JP if pkg is JAX else TP


def source(pkg, spec, schema, capacity=8):
    s = pkg.schema(*schema)
    return pkg.stream.MockSource(s, pkg.messages(s, spec, capacity))


def project_set(pkg, spec, schema, exprs, names, out_capacity=4):
    src = source(pkg, spec, schema)
    with pkg.eager():
        return ps(pkg).ProjectSetExecutor(src, exprs(pkg), names,
                                          out_capacity=out_capacity,
                                          **pkg.kw())


KLH = (("k", "INT64"), ("lo", "INT64"), ("hi", "INT64"))


def series_exprs(pkg, step=False):
    c, e = pkg.common, pkg.expr
    args = (e.col(1, c.INT64), e.col(2, c.INT64)) + (
        (e.Literal(2, c.INT64),) if step else ())
    return [e.col(0, c.INT64), ps(pkg).TableFuncCall("generate_series", args),
            e.Literal(0, c.INT64)]


@pytest.mark.parametrize("step", [False, True])
def test_generate_series_as_reference(step):
    spec = [("b", 1, False),
            ("c", [(1, 1, 3), (2, 5, 4), (3, None, 2), (4, 0, 6)], None),
            ("c", [(4, 0, 6), (4, 1, 2)], [UD, UI]), ("b", 2, False)]
    got = [events(pkg, project_set(pkg, spec, KLH,
                                   lambda p: series_exprs(p, step),
                                   ("k", "g", "_pidx")))
           for pkg in BOTH]
    assert got[1] == got[0]
    rows = [r for r in got[0] if r[0] not in ("wm", "barrier")]
    if not step:
        assert rows[:3] == [(I, (1, 1, 0)), (I, (1, 2, 1)), (I, (1, 3, 2))]
    # the update pair becomes the old row's deletes, then the new row's
    # inserts
    n_old = len(range(0, 7, 2 if step else 1))
    n_new = len(range(1, 3, 2 if step else 1))
    assert [op for op, _ in rows[-(n_old + n_new):]] == [D] * n_old + [
        I] * n_new


def test_unnest_list_ids_as_reference():
    lists = [(1, 2, 3), (), ("x", "y")]

    def exprs(pkg):
        c, e = pkg.common, pkg.expr
        return [e.col(0, c.INT64),
                ps(pkg).TableFuncCall("unnest", (e.col(1, c.INT64),),
                                      c.INT64)]

    got = []
    for pkg in BOTH:
        types = (JT if pkg is JAX else TT)
        ids = [types.GLOBAL_LIST_DICT.intern(v) for v in lists[:2]]
        spec = [("b", 1, False), ("c", [(10, ids[0]), (11, ids[1]),
                                        (12, None)], None), ("b", 2, False)]
        got.append(events(pkg, project_set(
            pkg, spec, (("k", "INT64"), ("l", "INT64")), exprs,
            ("k", "e"))))
        strs = ps(pkg).series_values("unnest", (lists[2],))
        assert [pkg.common.GLOBAL_STRING_DICT.lookup(i) for i in strs] == [
            "x", "y"]
    assert got[1] == got[0]
    assert [r[1] for r in got[0] if r[0] == I] == [(10, 1), (10, 2),
                                                   (10, 3)]


def test_regexp_split_to_table_by_string_as_reference():
    def exprs(pkg):
        c, e = pkg.common, pkg.expr
        return [e.col(0, c.INT64),
                ps(pkg).TableFuncCall("regexp_split_to_table", (
                    e.col(1, c.VARCHAR), e.Literal(",\\s*", c.VARCHAR)),
                    c.VARCHAR)]

    spec = [("b", 1, False), ("c", [(1, "a, b,c"), (2, "solo"), (3, None)],
                                   None), ("b", 2, False)]
    got = [events(pkg, project_set(pkg, spec, (("k", "INT64"),
                                               ("s", "VARCHAR")), exprs,
                                   ("k", "part")))
           for pkg in BOTH]
    assert got[1] == got[0]
    assert [r[1] for r in got[0] if r[0] == I] == [
        (1, "a"), (1, "b"), (1, "c"), (2, "solo")]


KT = (("k", "INT64"), ("ts", "TIMESTAMP"))


def union(pkg, specs):
    with pkg.eager():
        return pkg.stream.UnionExecutor([source(pkg, s, KT) for s in specs])


def test_union_rows_and_minimum_watermark_as_reference():
    left = [("b", 1, False), ("c", [(1, 10)], None), ("w", 1, 10),
            ("c", [(2, 30)], None), ("w", 1, 30), ("b", 2, False),
            ("w", 1, 40), ("b", 3, False)]
    right = [("b", 1, False), ("w", 1, 20), ("c", [(3, 25)], None),
             ("b", 2, False), ("c", [(4, 50)], None), ("w", 1, 50),
             ("b", 3, False)]

    def run(pkg):
        ex = union(pkg, [left, right])

        async def go():
            out = []
            async for m in ex.execute():
                if isinstance(m, pkg.stream.Watermark):
                    out.append(("wm", m.col_idx, m.value))
                elif isinstance(m, pkg.stream.Barrier):
                    out.append(("barrier", m.epoch.curr))
                else:
                    out.extend(pkg.common.chunk_to_rows(m, ex.schema,
                                                        with_ops=True))
            return out

        with pkg.eager():
            return asyncio.run(go())

    got = [run(pkg) for pkg in BOTH]
    assert got[1] == got[0]
    wms = [e[2] for e in got[0] if e[0] == "wm"]
    # each the minimum over both inputs' latest, sent only when it moves
    assert wms == sorted(set(wms)) and wms[-1] == min(40, 50)
    assert sorted(r[1][0] for r in got[0] if r[0] == I) == [1, 2, 3, 4]


def test_union_rejects_mismatched_schemas():
    for pkg in BOTH:
        a = source(pkg, [], KT)
        b = source(pkg, [], (("k", "INT64"),))
        with pytest.raises(ValueError):
            pkg.stream.UnionExecutor([a, b])


def test_values_rows_once_after_first_barrier_as_reference():
    def run(pkg):
        schema = pkg.schema(*KT)
        barriers = pkg.stream.MockSource(schema, pkg.messages(schema, [
            ("b", 1, False), ("b", 2, False), ("b", 3, False)]))
        with pkg.eager():
            ex = pkg.stream.ValuesExecutor(
                schema, [(1, 5), (2, None), (3, 7)], barriers, capacity=2,
                **pkg.kw())
        return events(pkg, ex)

    got = [run(pkg) for pkg in BOTH]
    assert got[1] == got[0]
    assert got[0] == [("barrier", 1), (I, (1, 5)), (I, (2, None)),
                      (I, (3, 7)), ("barrier", 2), ("barrier", 3)]
