"""LIST, STRUCT, JSONB and BYTEA in the port against the reference on the
CPU: value round trips, the memcomparable key and value encodings byte for
byte (nested structs with a DECIMAL field and NULL fields, lists with NULL
elements), chunks, a StateTable round trip and ``restore`` of the
reference's snapshot, the native codec, the JSON parser (with its two
divergences named) and the interop re-interning of the reference's ids.
Tolerance: exact; values compare after decoding (dictionary ids differ by
package).
"""

import asyncio
import json

import jax
import numpy as np
import pytest

import risingwave_tpu.common as J
import risingwave_tpu.common.row as JR
import risingwave_tpu.common.types as JT
import risingwave_tpu.connector.parsers as JP
import risingwave_tpu.expr as JE
import risingwave_tpu.stream as JS
import risingwave_tpu_torch.common as T
import risingwave_tpu_torch.common.row as TR
import risingwave_tpu_torch.common.types as TT
import risingwave_tpu_torch.connector.parsers as TP
import risingwave_tpu_torch.expr as TE
import risingwave_tpu_torch.stream as TS
from risingwave_tpu.storage import MemoryStateStore as JStore
from risingwave_tpu.storage import StateTable as JTable
from risingwave_tpu.stream.hash_agg import agg_state_schema as j_agg_schema
from risingwave_tpu_torch import interop, native
from risingwave_tpu_torch.storage import MemoryStateStore as TStore
from risingwave_tpu_torch.storage import StateTable as TTable
from risingwave_tpu_torch.stream.hash_agg import (
    agg_state_schema as t_agg_schema,
)

MODS = {"jax": JT, "torch": TT}


def types_of(m):
    """Named types of one package: nested STRUCT with a DECIMAL field,
    LISTs of three element kinds, JSONB, BYTEA."""
    inner = m.struct_of(("x", m.INT64), ("y", m.VARCHAR))
    return {
        "struct": m.struct_of(("name", m.VARCHAR), ("age", m.INT64),
                              ("amt", m.decimal(2)), ("inner", inner)),
        "list_int": m.list_of(m.INT64),
        "list_str": m.list_of(m.VARCHAR),
        "list_float": m.list_of(m.FLOAT64),
        "jsonb": m.JSONB,
        "bytea": m.BYTEA,
    }


VALUES = {
    "struct": [("ada", 36, 1.25, (7, "p")), ("bob", None, -0.5, None),
               (None, -3, 0.0, (None, None)), ("", 0, 99.99, (1, ""))],
    "list_int": [(), (1,), (1, 2), (1, None, -5), (2,), (-(2 ** 63),)],
    "list_str": [(), ("a",), ("a", "b"), ("b",), (None, "z\x00y")],
    "list_float": [(-1.5, 0.0), (2.5,), (float("inf"), None)],
    "jsonb": ['{"a":1}', "[10,20,30]", "null", '"s"', "{}"],
    "bytea": ["", "bin", "z\x00y", "\xff"],
}
KINDS = list(VALUES)


@pytest.mark.parametrize("kind", KINDS)
def test_round_trip_and_encodings_equal(kind):
    """to_physical / to_python, ``encode_value`` keys, ``encode_key``
    order and value rows: byte for byte the reference's; decoding a value
    row gives back the same values."""
    jt, tt = types_of(JT)[kind], types_of(TT)[kind]
    vals = VALUES[kind]
    jp = [jt.to_physical(v) for v in vals]
    tp = [tt.to_physical(v) for v in vals]
    assert [tt.to_python(p) for p in tp] == [jt.to_python(p)
                                             for p in jp] == vals
    for j, t in zip(jp + [None], tp + [None]):
        assert TR.encode_value(t, tt) == JR.encode_value(j, jt)
    n = len(vals) + 1
    t_row, j_row = tp + [None], jp + [None]
    raw = TR.encode_value_row(t_row, [tt] * n)
    assert raw == JR.encode_value_row(j_row, [jt] * n)
    back = TR.decode_value_row(raw, [tt] * n)
    assert [None if p is None else tt.to_python(p) for p in back] == \
        vals + [None]
    keys = [TR.encode_key([p], [tt]) for p in tp]
    assert keys == [JR.encode_key([p], [jt]) for p in jp]


def test_struct_arity_is_checked():
    for m in (JT, TT):
        st = types_of(m)["struct"]
        with pytest.raises(ValueError):
            st.to_physical(("only one",))
        with pytest.raises(ValueError):
            # a value interned elsewhere with the wrong arity
            bad = m.GLOBAL_LIST_DICT.intern(("a", 1))
            (TR if m is TT else JR).encode_value_row([bad], [st])


def test_list_keys_order_elementwise():
    """A proper prefix sorts first, then element by element."""
    tt = types_of(TT)["list_int"]
    vals = [(1, 2), (), (1,), (0, 9), (1, 2, 0), (2,)]
    keys = [TR.encode_key([tt.to_physical(v)], [tt]) for v in vals]
    assert [vals[i] for i in sorted(range(len(vals)),
                                    key=keys.__getitem__)] == sorted(vals)


def test_chunk_round_trip_equal():
    """make_chunk / chunk_to_rows over every new kind, NULL rows included."""
    rows = list(zip(*(VALUES[k][:3] for k in KINDS))) + [(None,) * len(KINDS)]
    out = {}
    for name, m, c, kw in (("jax", JT, J, {}), ("torch", TT, T,
                                                {"device": "cpu"})):
        ts = types_of(m)
        schema = m.Schema.of(*((k, ts[k]) for k in KINDS))
        out[name] = c.chunk_to_rows(c.make_chunk(schema, rows, capacity=8,
                                                 **kw), schema)
    assert out["torch"] == out["jax"] == rows


def test_native_codec_jsonb_bytes_equal_python():
    """JSONB and BYTEA go through the native string code with the Python
    encoders' bytes; a row holding a LIST or STRUCT has no native codec
    (``codec(types)`` is None), and takes the Python encoders."""
    codec = native.codec()
    if codec is None:
        pytest.skip("no C++ compiler to build the native row codec")
    ts = types_of(TT)
    types = [ts["jsonb"], ts["bytea"], TT.INT64]
    ids = [np.array([ts[k].to_physical(v) for v in VALUES[k][:4]], np.int32)
           for k in ("jsonb", "bytea")]
    datas = ids + [np.arange(4, dtype=np.int64)]
    masks = [np.array([True, True, False, True])] * 3
    idx = np.arange(4)
    want_v = [TR.encode_value_row(
        [d[i] if m[i] else None for d, m in zip(datas, masks)], types)
        for i in idx]
    assert codec.encode_value_rows(datas, masks, types, idx) == want_v
    want_k = [TR.encode_key(
        [d[i] if m[i] else None for d, m in zip(datas, masks)], types)
        for i in idx]
    assert codec.encode_keys(datas, masks, types, idx) == want_k
    assert native.codec([ts["list_int"]]) is None
    assert native.codec([ts["struct"], TT.INT64]) is None


def _agg_over_key(pkg, kind, value):
    """A HashAgg(count(*)) grouped by one column of ``kind``, one row in
    and a checkpoint; returns the store's snapshot."""
    is_t = pkg == "torch"
    c, e, s = (T, TE, TS) if is_t else (J, JE, JS)
    m = TT if is_t else JT
    schema = m.Schema.of(("k", types_of(m)[kind]), ("v", m.INT64))
    store = (TStore if is_t else JStore)()
    calls = [e.count_star()]
    table = (TTable if is_t else JTable)(
        store, 1, (t_agg_schema if is_t else j_agg_schema)([schema[0]],
                                                           calls), [0])
    kw = {"device": "cpu"} if is_t else {}
    msgs = [s.Barrier.new(1),
            c.make_chunk(schema, [(value, 1), (value, 2)], capacity=8, **kw),
            s.Barrier.new(2, checkpoint=True)]
    with jax.disable_jit():
        ex = s.HashAggExecutor(s.MockSource(schema, msgs), [0], calls,
                               state_table=table, table_capacity=16,
                               out_capacity=8, **kw)

        async def run():
            async for msg in ex.execute():
                if isinstance(msg, s.Barrier) and msg.checkpoint:
                    store.commit(msg.epoch.curr)
        asyncio.run(run())
    return store


@pytest.mark.parametrize("kind", ["jsonb", "list_int", "struct"])
def test_checkpointed_group_key_of_new_kind(kind):
    """Divergence (ROADMAP C3): the reference's HashAgg checkpoint raises
    on a JSONB, LIST or STRUCT group key when its native codec is built
    (``_CODE_BY_KIND`` has no entry for them). The port checkpoints such a
    key (JSONB through the string code, LIST and STRUCT through the
    Python encoders) and recovers it."""
    value = VALUES[kind][1]
    if native.codec() is not None:
        with pytest.raises(KeyError, match=kind.split("_")[0].upper()):
            _agg_over_key("jax", kind, value)
    store = _agg_over_key("torch", kind, value)
    ts = types_of(TT)
    schema = TT.Schema.of(("k", ts[kind]), ("v", TT.INT64))
    calls = [TE.count_star()]
    table = TTable(store, 1, t_agg_schema([schema[0]], calls), [0])
    rows = list(table.scan_all())
    assert [(ts[kind].to_python(r[0]), r[1], r[2]) for r in rows] == [
        (value, 2, 2)]


def test_state_table_round_trip_and_restore_of_reference_snapshot():
    """Rows of every new kind through a StateTable in each package: equal
    snapshots; the port's store restored from the reference's snapshot
    scans back to the same values."""
    cols = [(k, k) for k in KINDS]
    rows_py = [(i,) + tuple(VALUES[k][i % len(VALUES[k])] for k in KINDS)
               for i in range(5)] + [(9,) + (None,) * len(KINDS)]
    snaps = {}
    for name, m, store_cls, table_cls in (("jax", JT, JStore, JTable),
                                          ("torch", TT, TStore, TTable)):
        ts = types_of(m)
        schema = m.Schema.of(("id", m.INT64), *((n, ts[k]) for n, k in cols))
        store = store_cls()
        table = table_cls(store, 7, schema, [0])
        for r in rows_py:
            table.insert(tuple(None if v is None else t.to_physical(v)
                               for v, t in zip(r, schema.types)))
        table.commit(1)
        store.commit(1)
        snaps[name] = store.snapshot()
    assert snaps["torch"] == snaps["jax"]
    store = TStore()
    store.restore(snaps["jax"])
    ts = types_of(TT)
    schema = TT.Schema.of(("id", TT.INT64), *((n, ts[k]) for n, k in cols))
    got = [tuple(None if v is None else t.to_python(v)
                 for v, t in zip(r, schema.types))
           for r in TTable(store, 7, schema, [0]).scan_all()]
    assert got == rows_py


EVENTS = [
    {"id": 1, "who": {"name": "ada", "age": 36, "f": 1.5, "d": "2.25"},
     "payload": '{"b": 1, "a": [1, 2]}', "tags": ["x", "y"], "raw": "q"},
    {"id": 2, "who": {"name": "bob"}, "payload": {"b": 1, "a": [1, 2]},
     "tags": [], "raw": None},
    {"id": 3, "who": None, "payload": None},
]


def event_schema(m):
    return m.Schema.of(
        ("id", m.INT64),
        ("who", m.struct_of(("name", m.VARCHAR), ("age", m.INT64),
                            ("f", m.FLOAT64), ("d", m.decimal(2)))),
        ("payload", m.JSONB), ("tags", m.list_of(m.VARCHAR)),
        ("raw", m.BYTEA))


def test_parse_json_line_parity_and_its_two_divergences():
    """Everything but STRUCT fields and JSONB text parses as the reference
    parses it. Divergence 1 (ROADMAP C3): the reference coerces every
    struct field to text ('36', '1.5'); the port coerces each by its
    declared type, so the struct interns as the one built from the
    numbers. Divergence 2: JSONB given as text is canonicalised like a
    JSON object (the reference keeps the text as written, so equal JSON
    values got two ids)."""
    lines = [json.dumps(ev) for ev in EVENTS]
    jrows = [JP.parse_json_line(ln, event_schema(JT)) for ln in lines]
    trows = [TP.parse_json_line(ln, event_schema(TT)) for ln in lines]
    for jr, tr in zip(jrows, trows):
        assert tr[0] == jr[0] and tr[3] == jr[3] and tr[4] == jr[4]
    assert jrows[0][1] == ("ada", "36", "1.5", "2.25")
    assert trows[0][1] == ("ada", 36, 1.5, 2.25)
    assert jrows[1][1] == trows[1][1] == ("bob", None, None, None)
    assert jrows[0][2] == '{"b": 1, "a": [1, 2]}'
    assert trows[0][2] == trows[1][2] == jrows[1][2] == '{"a":[1,2],"b":1}'
    ts = event_schema(TT)
    chunk = T.make_chunk(ts, trows, capacity=4, device="cpu")
    assert T.chunk_to_rows(chunk, ts) == trows
    # equal JSON values share one id: one group
    pay = chunk.columns[2].data[:2].tolist()
    assert pay[0] == pay[1]
    built = ts[1].type.to_physical(("ada", 36, 1.5, 2.25))
    assert int(chunk.columns[1].data[0]) == built


def test_csv_and_debezium_parsers_match_reference():
    schema_of = (lambda m: m.Schema.of(("id", m.INT64), ("name", m.VARCHAR),
                                       ("ok", m.BOOL), ("x", m.FLOAT64)))
    text = "id,name,ok,x\n1,ada,true,1.5\n2,,0,\n"
    assert TP.parse_csv_lines(text, schema_of(TT)) == \
        JP.parse_csv_lines(text, schema_of(JT))
    events = "\n".join(json.dumps(e) for e in [
        {"op": "c", "after": {"id": 1, "name": "a"}},
        {"payload": {"op": "u", "before": {"id": 1, "name": "a"},
                     "after": {"id": 1, "name": "b"}}},
        {"op": "u", "after": {"id": 2, "name": "c"}},
        {"op": "d", "before": {"id": 1, "name": "b"}}])
    assert TP.parse_debezium_lines(events, schema_of(TT)) == \
        JP.parse_debezium_lines(events, schema_of(JT))
    with pytest.raises(ValueError):
        TP.parse_debezium_line('{"op": "x"}', schema_of(TT))


def test_interop_reinterns_reference_ids_by_content():
    """A reference chunk whose VARCHAR, BYTEA, JSONB, LIST and STRUCT
    columns hold the reference's ids: carried into the port re-interned
    by content (nested structs field by field), NULL rows kept."""
    # intern a few values in the port first, so its ids differ
    for v in ("zzz", "yyy"):
        TT.GLOBAL_STRING_DICT.intern(v)
    TT.GLOBAL_LIST_DICT.intern(("pad",))
    kinds = ["struct", "list_str", "list_int", "jsonb", "bytea"]
    rows = [tuple(VALUES[k][i] for k in kinds) for i in range(3)]
    rows.append((None,) * len(kinds))
    js = JT.Schema.of(*((k, types_of(JT)[k]) for k in kinds))
    ts = TT.Schema.of(*((k, types_of(TT)[k]) for k in kinds))
    jchunk = J.make_chunk(js, rows, capacity=8)
    host = jax.tree_util.tree_map(np.asarray, jchunk)
    chunk = interop.chunk_from_jax(host, "cpu", ts, JT.GLOBAL_STRING_DICT,
                                   JT.GLOBAL_LIST_DICT)
    assert T.chunk_to_rows(chunk, ts) == J.chunk_to_rows(jchunk, js) == rows
    phys = J.chunk_to_rows(jchunk, js, physical=True)[0]
    mine = interop.physical_row_from_jax(phys, ts.types,
                                         JT.GLOBAL_STRING_DICT,
                                         JT.GLOBAL_LIST_DICT)
    assert mine == T.chunk_to_rows(chunk, ts, physical=True)[0]
