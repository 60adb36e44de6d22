"""The host storage tier of the port against the reference's, on the CPU:
the row encoders (memcomparable keys and value rows) byte for byte over the
port's six kinds, a scripted StateTable session leaving the same committed
bytes in both packages' stores, a store restored across packages, and the
port's native row codec equal to its Python encoders. Tolerance: exact
(bytes and decoded values; a NaN compares by its bits)."""

import math
import struct

import numpy as np
import pytest

import risingwave_tpu.common.row as JR
import risingwave_tpu.common.types as JT
import risingwave_tpu_torch.common.row as TR
import risingwave_tpu_torch.common.types as TT
from risingwave_tpu.storage import MemoryStateStore as JStore
from risingwave_tpu.storage import StateTable as JTable
from risingwave_tpu_torch.native import codec
from risingwave_tpu_torch.storage import MemoryStateStore as TStore
from risingwave_tpu_torch.storage import StateTable as TTable

KINDS = ["BOOL", "INT32", "INT64", "FLOAT64", "TIMESTAMP", "VARCHAR"]
I64_MIN, I64_MAX = -2**63, 2**63 - 1
I32_MIN, I32_MAX = -2**31, 2**31 - 1
# (kind, logical value) — None is NULL
VALUES = {
    "BOOL": [None, False, True],
    "INT32": [None, I32_MIN, -1, 0, 7, I32_MAX],
    "INT64": [None, I64_MIN, -5, 0, 2**40, I64_MAX],
    "FLOAT64": [None, -math.inf, -1e300, -0.0, 0.0, 1.5, math.inf,
                math.nan],
    "TIMESTAMP": [None, I64_MIN, -1, 0, 1_600_000_000_000_000, I64_MAX],
    "VARCHAR": [None, "", "a", "with\x00zero", "\x00", "ab\x00\x00c",
                "βeta", "zz"],
}


def _types(mod, kinds):
    return [getattr(mod, k) for k in kinds]


def _phys(t, v):
    return None if v is None else t.to_physical(v)


def _same(a, b) -> bool:
    """Equal, with a NaN equal to a NaN of the same bits."""
    if isinstance(a, float) and isinstance(b, float):
        return struct.pack("<d", a) == struct.pack("<d", b)
    return a == b


def _logical(t, v):
    return None if v is None else t.to_python(v)


@pytest.mark.parametrize("kind", KINDS)
def test_encoders_give_the_reference_bytes(kind):
    jt, tt = getattr(JT, kind), getattr(TT, kind)
    for v in VALUES[kind]:
        jv, tv = _phys(jt, v), _phys(tt, v)
        assert TR.encode_key([tv], [tt]) == JR.encode_key([jv], [jt]), v
        assert (TR.encode_value_row([tv], [tt])
                == JR.encode_value_row([jv], [jt])), v
        enc = TR.encode_value_row([tv], [tt])
        (got,) = TR.decode_value_row(enc, [tt])
        (want,) = JR.decode_value_row(enc, [jt])
        assert _same(_logical(tt, got), _logical(jt, want)), v
        assert TR.encode_vnode_key(7, [tv], [tt]) \
            == JR.encode_vnode_key(7, [jv], [jt])


def test_multi_column_keys_sort_as_the_reference():
    kinds = ["INT64", "VARCHAR", "FLOAT64", "BOOL"]
    jts, tts = _types(JT, kinds), _types(TT, kinds)
    rng = np.random.default_rng(3)
    rows = [tuple(VALUES[k][rng.integers(len(VALUES[k]))] for k in kinds)
            for _ in range(200)]
    jkeys = [JR.encode_key([_phys(t, v) for t, v in zip(jts, r)], jts)
             for r in rows]
    tkeys = [TR.encode_key([_phys(t, v) for t, v in zip(tts, r)], tts)
             for r in rows]
    assert tkeys == jkeys
    assert sorted(range(200), key=tkeys.__getitem__) == \
        sorted(range(200), key=jkeys.__getitem__)


def _script(common_types, store_cls, table_cls):
    """A scripted insert/delete/update/commit session over two tables;
    returns the store."""
    t = common_types
    schema = t.Schema.of(("k", t.INT64), ("s", t.VARCHAR), ("x", t.FLOAT64),
                         ("b", t.BOOL), ("i", t.INT32),
                         ("ts", t.TIMESTAMP))
    types = [f.type for f in schema]
    store = store_cls()
    a = table_cls(store, 1, schema, [0, 1])
    b = table_cls(store, 2, schema, [3, 0])

    def row(*vals):
        return tuple(_phys(ty, v) for ty, v in zip(types, vals))

    r1 = row(1, "one", 1.5, True, -3, 10)
    r2 = row(2, "two\x00", None, False, None, -10)
    r3 = row(-7, "", -0.0, None, I32_MAX, I64_MIN)
    for tbl in (a, b):
        tbl.insert(r1)
        tbl.insert(r2)
        tbl.insert(r3)
    a.commit(1)
    b.commit(1)
    store.commit(1)
    a.delete(r2)
    a.update(r1, row(1, "one", math.inf, False, 4, 11))
    b.update(r3, row(-7, "", 2.0, None, I32_MAX, I64_MIN))
    b.delete(r1)
    b.insert(row(9, "nine", math.nan, True, 0, 0))
    a.commit(2)
    b.commit(2)
    store.commit(2)
    a.insert(row(5, "five", 5.0, True, 5, 5))
    a.commit(3)                  # staged, not committed
    return store, (a, b), types


def test_state_table_session_leaves_the_reference_bytes():
    jstore, (ja, jb), jtypes = _script(JT, JStore, JTable)
    tstore, (ta, tb), ttypes = _script(TT, TStore, TTable)
    assert tstore.snapshot() == jstore.snapshot()
    assert tstore.committed_epoch == jstore.committed_epoch == 2
    for jtab, ttab in ((ja, ta), (jb, tb)):
        want = [tuple(_logical(t, v) for t, v in zip(jtypes, r))
                for r in jtab.scan_all()]
        got = [tuple(_logical(t, v) for t, v in zip(ttypes, r))
               for r in ttab.scan_all()]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert all(_same(x, y) for x, y in zip(g, w)), (g, w)
    # a store written by one package restores into the other
    cross = TStore()
    cross.restore(jstore.snapshot())
    assert cross.snapshot() == tstore.snapshot()
    back = JStore()
    back.restore(tstore.snapshot())
    assert back.snapshot() == jstore.snapshot()


@pytest.fixture
def native():
    c = codec()
    if c is None:
        pytest.skip("no C++ compiler to build the row codec")
    return c


def _columns(kinds, rows):
    types = _types(TT, kinds)
    datas, masks = [], []
    for c, t in enumerate(types):
        arr = np.zeros(len(rows), t.np_dtype)
        mask = np.zeros(len(rows), bool)
        for r, row in enumerate(rows):
            if row[c] is not None:
                arr[r] = t.to_physical(row[c])
                mask[r] = True
        datas.append(arr)
        masks.append(mask)
    return types, datas, masks


NATIVE_KINDS = ["INT64", "INT32", "BOOL", "FLOAT64", "TIMESTAMP", "VARCHAR"]
NATIVE_ROWS = [
    (42, -7, True, 1.5, 9204, "alpha"),
    (-1, None, False, -0.0, None, "with\x00zero"),
    (0, I32_MAX, None, math.inf, -10, ""),
    (2**62, I32_MIN, True, -1e300, 0, "βeta"),
    (I64_MIN, 0, None, math.nan, I64_MAX, None),
]


def test_native_codec_gives_the_python_bytes(native):
    types, datas, masks = _columns(NATIVE_KINDS, NATIVE_ROWS)
    idx = np.arange(len(NATIVE_ROWS))
    values = native.encode_value_rows(datas, masks, types, idx)
    keys = native.encode_keys(datas, masks, types, idx)
    for r, row in enumerate(NATIVE_ROWS):
        phys = [_phys(t, v) for t, v in zip(types, row)]
        assert values[r] == TR.encode_value_row(phys, types), r
        assert keys[r] == TR.encode_key(phys, types), r
    # a subset, out of order
    sub = native.encode_value_rows(datas, masks, types, np.array([2, 0]))
    assert sub == [values[2], values[0]]


def test_native_codec_keys_sort_by_value(native):
    vals = [(-(2**40),), (-5,), (0,), (3,), (2**50,), (None,)]
    types, datas, masks = _columns(["INT64"], vals)
    keys = native.encode_keys(datas, masks, types, np.arange(len(vals)))
    # NULL first, then numeric order
    assert sorted(range(len(vals)), key=keys.__getitem__) == [5, 0, 1, 2, 3,
                                                              4]
