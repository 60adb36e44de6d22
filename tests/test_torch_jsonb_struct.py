"""The functions over LIST, STRUCT and JSONB values and the rest of the
reference's scalar registry (array_access, array_length, struct_field,
the six jsonb_* accessors, trim/ltrim/rtrim, substring, round, floor,
ceil) in the port against the reference on the CPU, over the same chunks,
and the scenarios of tests/test_jsonb.py and tests/test_struct.py as
expression and executor trees (a group-by over ``payload -> 'user' ->>
'name'`` with a checkpoint and a recovery from the reference's
snapshot). Tolerance: exact, compared after decoding (dictionary ids
differ by package). round, floor and ceil over DECIMAL are a divergence
by name (ROADMAP C3).
"""

import asyncio

import jax
import pytest

import risingwave_tpu.common as J
import risingwave_tpu.common.types as JT
import risingwave_tpu.expr as JE
import risingwave_tpu.expr.expr as JX
import risingwave_tpu.stream as JS
import risingwave_tpu_torch.common as T
import risingwave_tpu_torch.common.types as TT
import risingwave_tpu_torch.expr as TE
import risingwave_tpu_torch.expr.expr as TX
import risingwave_tpu_torch.stream as TS
from risingwave_tpu.storage import MemoryStateStore as JStore
from risingwave_tpu.storage import StateTable as JTable
from risingwave_tpu.stream.hash_agg import agg_state_schema as j_agg_schema
from risingwave_tpu_torch.connector.parsers import parse_json_lines
from risingwave_tpu_torch.storage import MemoryStateStore as TStore
from risingwave_tpu_torch.storage import StateTable as TTable
from risingwave_tpu_torch.stream.hash_agg import (
    agg_state_schema as t_agg_schema,
)

PKG = {"jax": (J, JT, JX, JE, JS), "torch": (T, TT, TX, TE, TS)}
CAP = 16

PAYLOADS = ['{"user": {"name": "ada", "age": 36}, "tags": ["a", "b"]}',
            '{"user": {"name": "bob"}, "n": 5}', "[10, 20, 30]",
            '{"a": null}', None, '{"user": {"name": "ada"}, "n": 2.5}',
            '"text"', "true", "{}"]


def canon(s):
    """JSONB text as an ``INSERT`` stores it: canonical."""
    import json
    return None if s is None else json.dumps(
        json.loads(s), separators=(",", ":"), sort_keys=True)


def schema_of(t):
    inner = t.struct_of(("x", t.INT64), ("y", t.VARCHAR))
    return t.Schema.of(
        ("j", t.JSONB), ("l", t.list_of(t.INT64)),
        ("ls", t.list_of(t.VARCHAR)),
        ("st", t.struct_of(("name", t.VARCHAR), ("age", t.INT64),
                           ("amt", t.decimal(2)), ("inner", inner))),
        ("s", t.VARCHAR), ("i", t.INT64), ("f", t.FLOAT64),
        ("d", t.decimal(2)), ("k", t.VARCHAR))


ROWS = [
    (canon(PAYLOADS[0]), (10, 20, 30), ("x", None), ("ada", 36, 1.25, (7, "p")),
     "  pad  ", 1, 2.5, 1.25, "user"),
    (canon(PAYLOADS[1]), (), ("y",), ("bob", None, -0.5, None),
     "x ", -1, -2.5, -1.25, "n"),
    (canon(PAYLOADS[2]), (1, None), (), (None, 41, 0.0, (None, "q")),
     " x", 3, 3.7, 1.35, "tags"),
    (canon(PAYLOADS[3]), None, ("z", "w"), None, "", 0, -0.5, 0.05, "a"),
    (None, (5,), None, ("eve", 7, 99.99, (1, "")), None, 2, None, None,
     None),
    (canon(PAYLOADS[5]), (1, 2, 3, 4), ("u",), ("ada", 1, 1.0, (2, "w")),
     "abc", -3, 0.5, -0.05, "user"),
    (canon(PAYLOADS[6]), (0,), ("v",), ("", 0, 0.0, (0, "")), "t", 9,
     1e300, 0.0, "zz"),
    (canon(PAYLOADS[7]), (9, 9), ("",), ("q", 2, 2.0, (3, "x")), "tt", 1,
     -1.5, 2.5, "user"),
    (canon(PAYLOADS[8]), (), ("a",), ("r", 3, 3.0, (4, "y")), "ttt", -2,
     0.0, -2.5, "user"),
]


def evaluate(pkg, build):
    """Decoded values of ``build(t, x)`` over ROWS in one package."""
    c, t, x, _, _ = PKG[pkg]
    schema = schema_of(t)
    kw = {"device": "cpu"} if pkg == "torch" else {}
    chunk = c.make_chunk(schema, ROWS, capacity=CAP, **kw)
    e = build(t, x, schema)
    col = e.eval(chunk)
    data = [v.item() if hasattr(v, "item") else v for v in
            list(col.data.tolist() if hasattr(col.data, "tolist")
                 else col.data)]
    mask = list(col.mask.tolist())
    return [e.type.to_python(d) if m else None
            for d, m in zip(data[:len(ROWS)], mask[:len(ROWS)])]


def col(x, schema, name):
    i = schema.names.index(name)
    return x.col(i, schema[i].type)


def lit(x, t, v, kind):
    return x.Literal(v, getattr(t, kind))


CASES = {
    "array_access_1": lambda t, x, s: x.call(
        "array_access", col(x, s, "l"), lit(x, t, 1, "INT64")),
    "array_access_3": lambda t, x, s: x.call(
        "array_access", col(x, s, "l"), lit(x, t, 3, "INT64")),
    "array_access_col": lambda t, x, s: x.call(
        "array_access", col(x, s, "l"), col(x, s, "i")),
    "array_access_str": lambda t, x, s: x.call(
        "array_access", col(x, s, "ls"), lit(x, t, 1, "INT64")),
    "array_length": lambda t, x, s: x.call("array_length", col(x, s, "l")),
    "array_length_str": lambda t, x, s: x.call("array_length",
                                               col(x, s, "ls")),
    "get_field": lambda t, x, s: x.call(
        "jsonb_get_field", col(x, s, "j"), lit(x, t, "user", "VARCHAR")),
    "get_field_col": lambda t, x, s: x.call(
        "jsonb_get_field", col(x, s, "j"), col(x, s, "k")),
    "get_field_text": lambda t, x, s: x.call(
        "jsonb_get_field_text", col(x, s, "j"), lit(x, t, "n", "VARCHAR")),
    "get_field_null": lambda t, x, s: x.call(
        "jsonb_get_field", col(x, s, "j"), lit(x, t, "a", "VARCHAR")),
    "get_field_text_null": lambda t, x, s: x.call(
        "jsonb_get_field_text", col(x, s, "j"), lit(x, t, "a", "VARCHAR")),
    "path": lambda t, x, s: x.call(
        "jsonb_get_field_text", x.call("jsonb_get_field", col(x, s, "j"),
                                       lit(x, t, "user", "VARCHAR")),
        lit(x, t, "name", "VARCHAR")),
    "get_elem": lambda t, x, s: x.call(
        "jsonb_get_elem", col(x, s, "j"), lit(x, t, 1, "INT64")),
    "get_elem_neg": lambda t, x, s: x.call(
        "jsonb_get_elem_text", col(x, s, "j"), lit(x, t, -1, "INT64")),
    "get_elem_col": lambda t, x, s: x.call(
        "jsonb_get_elem_text", col(x, s, "j"), col(x, s, "i")),
    "typeof": lambda t, x, s: x.call("jsonb_typeof", col(x, s, "j")),
    "typeof_field": lambda t, x, s: x.call(
        "jsonb_typeof", x.call("jsonb_get_field", col(x, s, "j"),
                               lit(x, t, "a", "VARCHAR"))),
    "array_len_json": lambda t, x, s: x.call("jsonb_array_length",
                                             col(x, s, "j")),
    "trim": lambda t, x, s: x.call("trim", col(x, s, "s")),
    "ltrim": lambda t, x, s: x.call("ltrim", col(x, s, "s")),
    "rtrim": lambda t, x, s: x.call("rtrim", col(x, s, "s")),
    "substring": lambda t, x, s: x.call(
        "substring", col(x, s, "s"), lit(x, t, 2, "INT64"),
        lit(x, t, 2, "INT64")),
    "substring_col": lambda t, x, s: x.call(
        "substring", col(x, s, "s"), col(x, s, "i")),
    "round_f": lambda t, x, s: x.call("round", col(x, s, "f")),
    "floor_f": lambda t, x, s: x.call("floor", col(x, s, "f")),
    "ceil_f": lambda t, x, s: x.call("ceil", col(x, s, "f")),
    "round_i": lambda t, x, s: x.call("round", col(x, s, "i")),
    "floor_i": lambda t, x, s: x.call("floor", col(x, s, "i")),
    "ceil_i": lambda t, x, s: x.call("ceil", col(x, s, "i")),
}


def struct_field(pkg, x, s, *names):
    """``(col).a.b`` as each package's binder builds it."""
    e = col(x, s, "st")
    for n in names:
        if pkg == "torch":
            e = x.struct_field(e, n)
        else:
            e = x.FunctionCall("struct_field", (e, x.Literal(
                e.type.field_index(n), JT.INT64)), e.type.field_type(n))
    return e


@pytest.mark.parametrize("case", list(CASES))
def test_function_over_chunk_matches_reference(case):
    got = evaluate("torch", CASES[case])
    assert got == evaluate("jax", CASES[case])


@pytest.mark.parametrize("path", [("name",), ("age",), ("amt",),
                                  ("inner",), ("inner", "x"),
                                  ("inner", "y")])
def test_struct_field_matches_reference(path):
    """Each field converts through its declared type: a DECIMAL keeps its
    scale, a nested struct is a struct, NULL fields and NULL structs are
    NULL."""
    got = evaluate("torch", lambda t, x, s: struct_field("torch", x, s,
                                                         *path))
    want = evaluate("jax", lambda t, x, s: struct_field("jax", x, s, *path))
    assert got == want
    if path == ("amt",):
        assert got[0] == 1.25


def test_results_intern_once_per_distinct_value():
    """JSONB and VARCHAR results are interned per distinct operand tuple:
    evaluating again interns nothing new."""
    build = CASES["get_field"]
    evaluate("torch", build)
    n = len(TT.GLOBAL_STRING_DICT)
    for _ in range(3):
        evaluate("torch", build)
        evaluate("torch", CASES["path"])
    assert len(TT.GLOBAL_STRING_DICT) == n


def test_registry_holds_every_reference_function():
    assert set(JX._REGISTRY) <= set(TX._REGISTRY)


@pytest.mark.parametrize("fn, want", [("round", [1.0, -1.0, 1.0, 0.0, None,
                                                 -0.0, 0.0, 3.0, -3.0]),
                                      ("floor", [1.0, -2.0, 1.0, 0.0, None,
                                                 -1.0, 0.0, 2.0, -3.0]),
                                      ("ceil", [2.0, -1.0, 2.0, 1.0, None,
                                                -0.0, 0.0, 3.0, -2.0])])
def test_decimal_rounding_diverges_from_reference(fn, want):
    """Divergence (ROADMAP C3): over DECIMAL the reference returns the
    argument (1.25 three times); the port gives PostgreSQL's results at
    the same scale: round half away from zero, floor, ceil."""
    def build(t, x, s):
        return x.call(fn, col(x, s, "d"))

    got = evaluate("torch", build)
    assert got == want
    assert evaluate("jax", build) == [r[7] for r in ROWS]


# ---------------------------------------------------------------------------
# tests/test_jsonb.py and tests/test_struct.py as executor trees
# ---------------------------------------------------------------------------

def drive(pkg, ex, store=None):
    """Every output (op, row) of ``ex`` in order; each checkpoint barrier
    commits ``store``."""
    c, _, _, _, s = PKG[pkg]

    async def run():
        out = []
        async for m in ex.execute():
            if isinstance(m, s.Barrier):
                if store is not None and m.checkpoint:
                    store.commit(m.epoch.curr)
            elif not isinstance(m, s.Watermark):
                out.extend(c.chunk_to_rows(m, ex.schema, with_ops=True))
        return out

    with jax.disable_jit():
        return asyncio.run(run())


def ev_schema(t):
    return t.Schema.of(("id", t.INT64), ("payload", t.JSONB))


def names_plan(pkg, msgs, store):
    """Project(payload -> 'user' ->> 'name') → HashAgg(count(*)) over a
    state table."""
    c, t, x, e, s = PKG[pkg]
    schema = ev_schema(t)
    kw = {"device": "cpu"} if pkg == "torch" else {}
    src = s.MockSource(schema, msgs)
    name = x.call("jsonb_get_field_text",
                  x.call("jsonb_get_field", x.col(1, t.JSONB),
                         x.Literal("user", t.VARCHAR)),
                  x.Literal("name", t.VARCHAR))
    proj = s.ProjectExecutor(src, [name], names=["name"])
    calls = [e.count_star()]
    st_schema = (t_agg_schema if pkg == "torch" else j_agg_schema)(
        [proj.schema[0]], calls)
    table = (TTable if pkg == "torch" else JTable)(store, 3, st_schema, [0])
    with jax.disable_jit():
        return s.HashAggExecutor(proj, [0], calls, state_table=table,
                                 table_capacity=16, out_capacity=8, **kw)


def ev_msgs(pkg, epochs, first=1):
    c, t, _, _, s = PKG[pkg]
    kw = {"device": "cpu"} if pkg == "torch" else {}
    out = [s.Barrier.new(first, checkpoint=True)]
    for i, rows in enumerate(epochs):
        out.append(c.make_chunk(ev_schema(t), rows, capacity=8, **kw))
        out.append(s.Barrier.new(first + 1 + i, checkpoint=True))
    return out


def test_group_by_json_path_with_checkpoint_and_recovery():
    """tests/test_jsonb.py::test_jsonb_group_by_path_and_recovery: the
    same outputs and committed bytes; then the port recovers from the
    reference's snapshot (JSONB persisted by content, interned anew) and
    counts a new 'ada' onto the recovered group as the reference does."""
    first = [[(1, canon(PAYLOADS[0])), (2, canon(PAYLOADS[1])),
              (3, canon(PAYLOADS[2]))]]
    second = [[(4, canon('{"user": {"name": "ada"}}'))]]
    outs, snaps = {}, {}
    for pkg, store_cls in (("jax", JStore), ("torch", TStore)):
        store = store_cls()
        out1 = drive(pkg, names_plan(pkg, ev_msgs(pkg, first), store), store)
        snaps[pkg] = store.snapshot()
        out2 = drive(pkg, names_plan(pkg, ev_msgs(pkg, second, 3), store),
                     store)
        outs[pkg] = (sorted(out1, key=repr), out2)
    assert outs["torch"] == outs["jax"]
    assert snaps["torch"] == snaps["jax"]
    assert sorted((r for _, r in outs["torch"][0]), key=repr) == sorted(
        [("ada", 1), ("bob", 1), (None, 1)], key=repr)
    store = TStore()
    store.restore(snaps["jax"])
    again = drive("torch", names_plan("torch", ev_msgs("torch", second, 3),
                                      store), store)
    assert again == outs["jax"][1]
    assert (J.OP_UPDATE_INSERT, ("ada", 2)) in again


def struct_schema(t):
    return t.Schema.of(("id", t.INT64), ("who", t.struct_of(
        ("name", t.VARCHAR), ("age", t.INT64))))


def test_struct_filter_and_grouped_count_with_delete():
    """tests/test_struct.py::test_struct_declare_construct_access:
    Filter((who).age > 40), and GROUP BY (who).name with a delete."""
    outs = {}
    for pkg in ("jax", "torch"):
        c, t, x, e, s = PKG[pkg]
        kw = {"device": "cpu"} if pkg == "torch" else {}
        schema = struct_schema(t)
        rows = [(1, ("ada", 36)), (2, ("bob", 41)), (3, None)]
        msgs = [s.Barrier.new(1),
                c.make_chunk(schema, rows, capacity=8, **kw),
                s.Barrier.new(2),
                c.make_chunk(schema, [rows[1]], ops=[J.OP_DELETE],
                             capacity=8, **kw),
                s.Barrier.new(3)]
        who = x.col(1, schema[1].type)

        def field(n, e0=who, x=x, pkg=pkg):
            if pkg == "torch":
                return x.struct_field(e0, n)
            return x.FunctionCall("struct_field", (e0, x.Literal(
                e0.type.field_index(n), JT.INT64)), e0.type.field_type(n))

        old = s.FilterExecutor(s.MockSource(schema, msgs[:3]), x.call(
            "greater_than", field("age"), x.Literal(40, t.INT64)))
        proj = s.ProjectExecutor(
            s.FilterExecutor(s.MockSource(schema, msgs),
                             x.call("is_not_null", who)),
            [field("name")], names=["n"])
        with jax.disable_jit():
            agg = s.HashAggExecutor(proj, [0], [e.count_star()],
                                    table_capacity=16, out_capacity=8, **kw)
        outs[pkg] = (drive(pkg, old), drive(pkg, agg))
    assert outs["torch"] == outs["jax"]
    assert [r for _, r in outs["torch"][0]] == [(2, ("bob", 41))]
    assert (J.OP_DELETE, ("bob", 1)) in outs["torch"][1]


def test_struct_decimal_scale_and_nesting_persist():
    """tests/test_struct.py::test_struct_decimal_scale_and_nesting_survive
    through a StateTable: (v).amt keeps scale 2 and ((v).inner).y reads
    back after a restore of the reference's snapshot."""
    snaps = {}
    for pkg, store_cls, table_cls in (("jax", JStore, JTable),
                                      ("torch", TStore, TTable)):
        _, t, _, _, _ = PKG[pkg]
        v = t.struct_of(("amt", t.decimal(2)), ("inner", t.struct_of(
            ("x", t.INT64), ("y", t.INT64))))
        schema = t.Schema.of(("id", t.INT64), ("v", v))
        store = store_cls()
        table = table_cls(store, 5, schema, [0])
        table.insert((1, v.to_physical((1.5, (7, 8)))))
        table.commit(1)
        store.commit(1)
        snaps[pkg] = store.snapshot()
    assert snaps["torch"] == snaps["jax"]
    store = TStore()
    store.restore(snaps["jax"])
    v = TT.struct_of(("amt", TT.decimal(2)), ("inner", TT.struct_of(
        ("x", TT.INT64), ("y", TT.INT64))))
    schema = TT.Schema.of(("id", TT.INT64), ("v", v))
    (row,) = TTable(store, 5, schema, [0]).scan_all()
    chunk = T.make_chunk(schema, [row], capacity=4, device="cpu",
                         physical=True)
    amt = TX.struct_field(TX.col(1, v), "amt").eval(chunk)
    y = TX.struct_field(TX.struct_field(TX.col(1, v), "inner"),
                        "y").eval(chunk)
    assert TT.decimal(2).to_python(int(amt.data[0])) == 1.5
    assert int(y.data[0]) == 8


def test_struct_json_source_ingest():
    """tests/test_struct.py::test_struct_json_source_ingest through the
    port's JSON parser and Project((who).name)."""
    import json
    text = "\n".join(json.dumps(o) for o in [
        {"id": 1, "who": {"name": "ada", "age": 36}},
        {"id": 2, "who": {"name": "bob", "age": 41}},
        {"id": 3, "who": None}])
    schema = struct_schema(TT)
    chunk = T.make_chunk(schema, parse_json_lines(text, schema),
                         capacity=4, device="cpu")
    name = TX.struct_field(TX.col(1, schema[1].type), "name").eval(chunk)
    age = TX.struct_field(TX.col(1, schema[1].type), "age").eval(chunk)
    got = [(i, TT.VARCHAR.to_python(n) if m else None, int(a) if am
            else None)
           for i, n, m, a, am in zip(chunk.columns[0].data.tolist(),
                                     name.data.tolist(), name.mask.tolist(),
                                     age.data.tolist(), age.mask.tolist())]
    assert got[:3] == [(1, "ada", 36), (2, "bob", 41), (3, None, None)]


def test_arity_mismatch_and_wrong_operands_rejected():
    st = struct_schema(TT)[1].type
    with pytest.raises(ValueError):
        st.to_physical(("ada",))
    with pytest.raises(TypeError):
        TX.call("jsonb_typeof", TX.col(0, TT.VARCHAR))
    with pytest.raises(TypeError):
        TX.call("array_length", TX.col(0, TT.JSONB))
    with pytest.raises(NotImplementedError):
        TX.call("add", TX.col(0, st), TX.col(1, TT.INT64))
